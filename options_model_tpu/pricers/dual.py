"""Martingale-dual (Rogers / Haugh-Kogan) upper bound for American options.

Beyond-reference capability: the reference's LSM estimators (and this repo's,
pricers/american.py) are all LOW-biased — the exercise policy is suboptimal,
and the out-of-sample estimator is low-biased by construction. The duality
result of Rogers (2002) gives the complementary bound: for ANY adapted
martingale M with M_0 = 0,

    V_0 <= E[ max_t ( D^t h(S_t) - M_t ) ]

with equality at the value process's own martingale part. Together with the
out-of-sample LSM low estimate this brackets the true price from both sides
on ONE simulation — a confidence interval for the *bias*, not just the MC
noise, which no point estimator can give.

Design. W_t is the value surrogate max(h, clip(C_t)) built from the
fitted LSM continuation polynomial C_t in the centered variable u = (x-m)rho,
x = S/K (pricers/american.build_centered_basis) — the raw C_t alone is a poor
value approximation exactly where it matters (in the exercise region the
value is h > C_t, and the cubic extrapolates wildly OTM), and measured here
it leaves a ~50% gap; max(h, clip(C, 0, cap)) closes it to ~1%. The one-step
conditional expectations E[W_{t+1}(S_{t+1}) | S_t] come from:

- interior dates: one-step nested sampling — under GBM the sub-simulation is
  a SINGLE lognormal draw x' = x exp(mu + a z) (not a sub-path to maturity as
  in full Andersen-Broadie, because W is an explicit function, not a policy
  rollout), so the inner loop is n_inner antithetic elementwise evaluations
  per (date, path), scanned over dates to bound memory;
- the terminal step (W_n = h exactly): the one-step Black closed form
  E[(x'-1)^+ | x] = x e^{mu+a^2/2} Phi(d1) - Phi(d2), d2 = (ln x + mu)/a,
  d1 = d2 + a — exact, no inner noise.

Validity: the duality inequality holds for ANY adapted martingale. Fresh
inner normals at each date keep M a martingale in the enlarged filtration
(each date's inner average is conditionally unbiased given everything drawn
before it), so inner noise only LOOSENS the bound (by O(1/sqrt(n_inner)));
it never invalidates it. The policy itself must be fitted on paths
independent of the ones the max statistic is evaluated on —
price_american_bracket defaults to the repo's alternating-block
out-of-sample split (american.oos_masks). With out_of_sample=False the
"bound" is only approximate (the policy has seen the eval paths).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from options_model_tpu.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu.core.payoff import vanilla_payoff
from options_model_tpu.core.stats import masked_mean_stderr
from options_model_tpu.pricers.american import (
    build_centered_basis,
    oos_masks,
    simulate_paths,
)
from options_model_tpu.models.heston import effective_bs_sigma
from options_model_tpu.pricers.blackscholes import bs_price
from options_model_tpu.pricers.regressors import masked_wls_theta_centered


class LSMPolicy(NamedTuple):
    """Per-exercise-date regression state, dates 1..n_steps-1 in FORWARD
    order: the continuation value at date t is

        C_t(x) = sum_k betas[t,k] u^k + betas[t,degree+1] (x-1)^+
                 [+ betas[t,degree+2] w + betas[t,degree+3] w^2
                  + betas[t,degree+4] u w   when fitted with a variance
                  state (Heston)],
        u = (x - x_mean[t]) * x_rstd[t],  x = S/K,
        w = (v - v_mean[t]) * v_rstd[t]
    """

    betas: jnp.ndarray   # (n_dates, degree+2 [+3 with variance])
    x_mean: jnp.ndarray  # (n_dates,)
    x_rstd: jnp.ndarray  # (n_dates,)
    v_mean: Optional[jnp.ndarray] = None  # (n_dates,) Heston only
    v_rstd: Optional[jnp.ndarray] = None


def fit_lsm_policy(S_paths: jnp.ndarray, spec: OptionSpec, T, *,
                   poly_degree: int = 3,
                   train_mask: Optional[jnp.ndarray] = None,
                   v_paths: Optional[jnp.ndarray] = None,
                   axis_name: Optional[str] = None):
    """LSM backward induction that also RETURNS the per-date regressions.

    Same algorithm as american.lsm_poly_backward (masked WLS on the centered
    basis, fitted on ``train_mask`` paths, decisions applied to all paths) —
    the stopped cash it returns is bitwise-identical to that pricer's on the
    same inputs (tested). ``v_paths`` adds the Heston variance columns
    (LSMConfig.variance_basis semantics). Returns (policy, cash) with
    ``cash`` the per-path stopped cashflow discounted to t=0 (feed for the
    low estimate) and ``policy`` the LSMPolicy the dual bound evaluates.
    """
    n_steps = S_paths.shape[0] - 1
    dtype = S_paths.dtype
    dt = jnp.asarray(T, dtype) / n_steps
    disc = jnp.exp(-jnp.asarray(spec.rate, dtype) * dt)
    K = jnp.asarray(spec.strike, dtype)
    if train_mask is None:
        train_mask = jnp.ones((S_paths.shape[1],), dtype)

    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    cash = vanilla_payoff(S_paths[-1], K, spec.cp)
    ts = jnp.arange(n_steps - 1, 0, -1)

    def step(cash, t):
        cash = cash * disc
        S_t = S_paths[t]
        v_t = v_paths[t] if v_paths is not None else None
        immediate = vanilla_payoff(S_t, K, spec.cp)
        itm = (immediate > 0).astype(dtype) * train_mask
        X, stats = build_centered_basis(S_t, K, itm, poly_degree, allsum,
                                        v_t=v_t, return_stats=True)
        theta = masked_wls_theta_centered(X, cash, itm, axis_name=axis_name)
        continuation = jnp.matmul(X, theta,
                                  precision=jax.lax.Precision.HIGHEST)
        exercise = (immediate > continuation) & (immediate > 0)
        cash = jnp.where(exercise, immediate, cash)
        return cash, (theta,) + stats

    cash, ys = jax.lax.scan(step, cash, ts)
    cash = cash * disc  # final step t=dt -> 0
    if v_paths is not None:
        thetas, ms, rhos, vms, vrs = ys
        policy = LSMPolicy(betas=thetas[::-1], x_mean=ms[::-1],
                           x_rstd=rhos[::-1], v_mean=vms[::-1],
                           v_rstd=vrs[::-1])
    else:
        thetas, ms, rhos = ys
        policy = LSMPolicy(betas=thetas[::-1], x_mean=ms[::-1],
                           x_rstd=rhos[::-1])
    return policy, cash


def _one_step_black(x, mu, a, cp):
    """E[(x'-1)^+ | x] (cp=+1) or E[(1-x')^+ | x] (cp=-1) for one lognormal
    step x' = x exp(mu + a Z) — the Black formula on a single time step."""
    d2 = (jnp.log(x) + mu) / a
    d1 = d2 + a
    fwd = x * jnp.exp(mu + 0.5 * a * a)
    call = fwd * norm.cdf(d1) - norm.cdf(d2)
    put = norm.cdf(-d2) - fwd * norm.cdf(-d1)
    return jnp.where(cp > 0, call, put)


_U_CLAMP = 4.0  # the regression's fitted ITM range in standardized u units


def _vhat(x, K, cp, tau_t, rate, q, sigma, b_t, m_t, rho_t, degree: int,
          v=None, vm_t=None, vr_t=None):
    """Value surrogate W_t(x) = max(h, E_t, clip(C_t(u clamped), 0, cap)) in
    price units — any measurable function of the state is a legal W, and each
    piece exists to track the TRUE value V_t in a different region (tightness
    is all that is at stake, never validity):

    - h: intrinsic — exact in the deep exercise region, where the ITM-fitted
      C_t underestimates V = h (using C alone measured a ~50% slack here);
    - E_t: the European closed form at remaining maturity tau_t — a uniform
      lower bound on V that is near-exact OTM, where C_t is pure
      extrapolation (without it the put's OTM cubic garbage, clipped only by
      the loose cap K, left a ~35% slack; the call was saved by its cap K*x
      shrinking to 0 OTM);
    - C_t, used ONLY on the ITM side of the moneyness boundary — the region
      the masked regression actually fitted. Freezing or extrapolating the
      cubic OTM keeps a near-ATM-sized constant where the true value decays
      (measured: a ~13% slack on puts from exactly that); OTM the European
      floor is near-exact, so C is simply gated off there. Within the ITM
      side u is still clamped to +-_U_CLAMP standardized units (flat in the
      sparse deep tail, where h dominates anyway) and the value is clipped to
      [0, cap] with cap = K for puts (a put is worth at most K), K*x for
      calls (at most S).

    ``sigma``: the floor's volatility — the GBM sigma, or the Heston
    effective vol (per-state, _sigma_eff) that moment-matches the integrated
    variance; the floor is a SURROGATE (tightness), not a bound, so the
    moment-matched BS price serves. ``v``/``vm_t``/``vr_t``: the variance
    state and its standardization for a policy fitted with the (S, v) basis.
    """
    u = jnp.clip((x - m_t) * rho_t, -_U_CLAMP, _U_CLAMP)
    c = sum(b_t[..., k, None] * u**k for k in range(degree + 1))
    c = c + b_t[..., degree + 1, None] * jnp.maximum(x - 1.0, 0.0)
    if v is not None:
        w = jnp.clip((v - vm_t) * vr_t, -_U_CLAMP, _U_CLAMP)
        c = (c + b_t[..., degree + 2, None] * w
             + b_t[..., degree + 3, None] * w**2
             + b_t[..., degree + 4, None] * u * w)
    cap = jnp.where(cp > 0, K * x, K)
    itm_side = cp * (x - 1.0) >= 0.0
    c = jnp.where(itm_side, jnp.clip(c, 0.0, cap), 0.0)
    h = K * jnp.maximum(cp * (x - 1.0), 0.0)
    e = bs_price(K * x, K, tau_t, rate, sigma, cp, q=q)
    return jnp.maximum(jnp.maximum(h, e), c)


def _inner_normals(dkey, lead, n, inner_block, first_block, dtype):
    """Fresh normals of shape lead + (n,) for one date.

    ``inner_block=None``: one draw keyed by the date alone (single-device
    form). With ``inner_block`` set the draws are generated PER PATH BLOCK,
    keyed by the GLOBAL block index (first_block + local block) — the repo's
    sharding-invariance discipline (core/rng.py): a mesh shard that owns
    blocks [first_block, first_block + n/inner_block) draws exactly the
    rows the unsharded run draws for those paths, so the sharded dual equals
    the single-device dual on the same total paths."""
    if inner_block is None:
        return jax.random.normal(dkey, lead + (n,), dtype)
    if n % inner_block:
        raise ValueError(f"paths ({n}) must be a multiple of inner_block "
                         f"({inner_block})")
    nb = n // inner_block

    def blk(b):
        return jax.random.normal(jax.random.fold_in(dkey, first_block + b),
                                 lead + (inner_block,), dtype)

    z = jax.vmap(blk)(jnp.arange(nb))         # (nb, *lead, inner_block)
    perm = tuple(range(1, 1 + len(lead))) + (0, 1 + len(lead))
    return jnp.transpose(z, perm).reshape(lead + (n,))


def _sigma_eff(v, tau, heston: HestonParams, dtype):
    """Alias of models.heston.effective_bs_sigma (moved there so the NN-LSM's
    residual regression baseline shares the exact formula the dual surrogate
    uses — training and dual evaluation must agree on the baseline)."""
    return effective_bs_sigma(v, tau, heston, dtype)


def _inner_poisson(dkey, lead, n, inner_block, first_block, lam_dt, dtype):
    """Fresh Poisson(lam_dt) counts of shape lead + (n,) for one date — the
    jump-count analogue of _inner_normals, same global-block keying rule."""
    if inner_block is None:
        return jax.random.poisson(dkey, lam_dt, lead + (n,)).astype(dtype)
    nb = n // inner_block

    def blk(b):
        return jax.random.poisson(
            jax.random.fold_in(dkey, first_block + b), lam_dt,
            lead + (inner_block,)).astype(dtype)

    z = jax.vmap(blk)(jnp.arange(nb))
    perm = tuple(range(1, 1 + len(lead))) + (0, 1 + len(lead))
    return jnp.transpose(z, perm).reshape(lead + (n,))


def _inner_gamma(dkey, lead, n, inner_block, first_block, alpha, dtype):
    """Fresh Gamma(alpha, scale 1) draws of shape lead + (n,) for one date —
    the gamma-clock analogue of _inner_normals (VG inner steps), same
    global-block keying rule."""
    if inner_block is None:
        return jax.random.gamma(dkey, alpha, lead + (n,), dtype)
    nb = n // inner_block

    def blk(b):
        return jax.random.gamma(jax.random.fold_in(dkey, first_block + b),
                                alpha, lead + (inner_block,), dtype)

    z = jax.vmap(blk)(jnp.arange(nb))
    perm = tuple(range(1, 1 + len(lead))) + (0, 1 + len(lead))
    return jnp.transpose(z, perm).reshape(lead + (n,))


def _one_step_jump_black(x, mu0, a2, cp, lam_dt, mu_j, sig_j,
                         n_terms: int = 10):
    """E[h(x')|state] for one jump-diffusion step, by conditioning on the
    jump count: given N = n, log x' ~ N(log x + mu0 + n mu_j, a2 + n sig_j^2),
    so the expectation is the Poisson mixture of one-step Black terms. The
    n_terms=10 truncation discards P(N >= 10) ~ (lam dt)^10/10! (< 1e-40 at
    any sane lam dt < 0.1) — immeasurably below the MC noise the dual's
    pathwise max carries, so the bound's exactness is preserved in practice."""
    from jax.scipy.special import gammaln

    dtype = x.dtype
    k = jnp.arange(n_terms, dtype=dtype)
    logw = (-lam_dt + k * jnp.log(jnp.maximum(lam_dt, 1e-30))
            - gammaln(k + 1.0))
    w = jnp.where(lam_dt > 0, jnp.exp(logw), (k == 0).astype(dtype))
    out = 0.0
    for n in range(n_terms):
        out = out + w[n] * _one_step_black(
            x, mu0 + n * mu_j, jnp.sqrt(a2 + n * sig_j**2), cp)
    return out


def dual_upper_from_policy(inner_key: jax.Array, S_paths: jnp.ndarray,
                           spec: OptionSpec, T, policy: LSMPolicy, *,
                           n_inner: int = 64,
                           model: str = "gbm",
                           heston: Optional[HestonParams] = None,
                           merton=None, bates=None, vg=None,
                           sabr=None, rbergomi=None, rb_hist=None,
                           v_paths: Optional[jnp.ndarray] = None,
                           eval_mask: Optional[jnp.ndarray] = None,
                           stat_pair_block: Optional[int] = None,
                           inner_block: Optional[int] = None,
                           first_block: int = 0,
                           axis_name: Optional[str] = None):
    """Rogers dual upper bound on given paths under a fitted LSM policy.

    Builds the martingale from the value surrogates W_t = max(h, clip(C_t))
    (W_n = payoff exactly) with one-step nested inner sampling at the
    interior dates and the closed-form Black expectation at the terminal step
    (module docstring). Returns (upper, stderr) of the pathwise maximum
    E[max_t (D^t h(S_t) - M_t)] — stderr over antithetic pair means via
    ``stat_pair_block`` like every estimator in the repo.

    ``model='heston'`` (with ``heston`` params, ``v_paths``, and a policy
    fitted with the variance basis): the inner one-step sampler replicates
    the simulator's full-truncation Euler transition EXACTLY (the dual bounds
    the price of the DISCRETIZED process, so the inner law must be the
    simulated law, models/heston.py:86-96), the surrogate's floor uses the
    moment-matched effective vol (_sigma_eff), and the terminal Black step
    uses the path's own one-step vol sqrt(v dt) — still exact, because the
    one-step conditional of S given (S, v) is lognormal.

    ``inner_key`` MUST be independent of the key that simulated ``S_paths``
    (jax.random.split upstream): reusing path randomness for the inner draws
    would correlate the inner averages with the increments they are meant to
    center, silently breaking the martingale property.

    ``n_inner``: antithetic inner draws per (date, path). The inner noise
    only loosens the bound (never invalidates it); 64 draws put the looseness
    well below the policy's own suboptimality gap.

    ``inner_block``/``first_block``: block the inner draws per path block
    keyed by GLOBAL block index (_inner_normals) — under shard_map over the
    path axis, pass the shard's first global block and the result equals the
    unsharded dual on the same total paths (parallel.batch.
    price_american_bracket_sharded).

    ``model='sabr'`` (beta=1 only, with ``sabr`` params and the alpha paths
    as ``v_paths``): the inner sampler replicates simulate_sabr's discrete
    transition exactly — the exact-lognormal alpha step and the spot-
    converted log-Euler F step (S' = S e^{drift dt} e^{-a^2 dt/2 + a
    sqrt(dt) z}); the terminal Black step is exact (S' | (S, a) is
    lognormal). The surrogate's floor vol is alpha itself (Hagan's leading
    term at beta=1 — tightness only).

    ``model='rbergomi'`` (with ``rbergomi`` params, the variance paths as
    ``v_paths``, and ``rb_hist`` from simulate_rbergomi(return_dual_state=
    True)): although (S, v) is NOT a Markov state for H < 1/2, the dual is
    still EXACT for the discretized process — ``rb_hist[t]`` is the
    F_t-measurable frozen-Volterra part of Y_{t+1}, so one fresh draw of
    (dW', Z2', Zp') replicates the hybrid scheme's one-step conditional law
    of (S_{t+1}, v_{t+1}) given F_t exactly, and the inner average is
    conditionally unbiased (module docstring's validity argument). This is
    the only available certification for rough-vol Americans: there is no
    PDE oracle for H < 1/2, and the (S, v) LSM policy is a documented
    Markovian-projection LOWER bound (models/rbergomi.py). The surrogate's
    floor vol sqrt((v_t + xi0)/2) is a tightness-only heuristic (the true
    forward-variance curve needs the history).
    """
    n_steps = S_paths.shape[0] - 1
    n_dates = n_steps - 1
    if policy.betas.shape[0] != n_dates:
        raise ValueError(f"policy has {policy.betas.shape[0]} dates, paths "
                         f"imply {n_dates}")
    if n_inner < 2 or n_inner % 2:
        raise ValueError("n_inner must be an even count >= 2 (antithetic "
                         "inner pairs)")
    if model not in ("gbm", "heston", "merton", "bates", "vg", "sabr",
                     "rbergomi"):
        raise ValueError(f"model must be 'gbm', 'heston', 'merton', 'bates', "
                         f"'vg', 'sabr' or 'rbergomi', got {model!r}")
    use_v = model in ("heston", "bates", "sabr", "rbergomi")
    if model == "bates":
        if bates is None:
            raise ValueError("model='bates' needs bates params")
        heston = bates.heston
    if model == "merton" and merton is None:
        raise ValueError("model='merton' needs merton params")
    if model == "vg" and vg is None:
        raise ValueError("model='vg' needs vg params")
    if model == "sabr":
        if sabr is None:
            raise ValueError("model='sabr' needs sabr params")
        if float(sabr.beta) != 1.0:
            raise ValueError("the SABR dual replicates the beta=1 lognormal "
                             "transition; beta<1 uses the absorbing Euler "
                             f"step the one-step law can't match (beta="
                             f"{float(sabr.beta)})")
    if model == "rbergomi":
        if rbergomi is None:
            raise ValueError("model='rbergomi' needs rbergomi params")
        if rb_hist is None:
            raise ValueError("model='rbergomi' needs rb_hist (simulate_"
                             "rbergomi(..., return_dual_state=True)): the "
                             "frozen Volterra history is what makes the "
                             "one-step inner law exact under rough vol")
    if use_v:
        if v_paths is None or policy.v_mean is None or (
                model in ("heston", "bates") and heston is None):
            raise ValueError(f"model={model!r} needs the variance params, "
                             "v_paths, and a policy fitted with v_paths")
        if spec.sigma is not None:
            raise ValueError("stochastic-vol dual: spec.sigma must be None "
                             "(the variance state drives the vol)")
    dtype = S_paths.dtype
    dt = jnp.asarray(T, dtype) / n_steps
    K = jnp.asarray(spec.strike, dtype)
    cp = jnp.asarray(spec.cp, dtype)
    rate = jnp.asarray(spec.rate, dtype)
    q = jnp.asarray(spec.div_yield, dtype)
    drift = rate - q
    degree = policy.betas.shape[1] - (5 if use_v else 2)

    # Jump layer (merton/bates): the inner one-step law gains the simulator's
    # exact compound-jump increment (count + aggregated size, models/
    # {merton,bates}.py), the drift its -lam*kbar*dt compensator, the
    # terminal closed form becomes the Poisson-mixture Black
    # (_one_step_jump_black), and the surrogate's European floor uses the
    # jump-augmented effective variance rate (tightness only, not validity).
    jp = merton if model == "merton" else (bates if model == "bates" else None)
    if jp is not None:
        lam_j = jnp.asarray(jp.lam, dtype)
        mu_jj = jnp.asarray(jp.mu_j, dtype)
        sig_jj = jnp.asarray(jp.sigma_j, dtype)
        kbar_j = jnp.exp(mu_jj + 0.5 * sig_jj**2) - 1.0
        lam_dt = lam_j * dt
        comp_dt = lam_j * kbar_j * dt            # drift compensator per step
        jvar = lam_j * (mu_jj**2 + sig_jj**2)    # jump variance rate / year
    else:
        lam_dt = comp_dt = jvar = jnp.asarray(0.0, dtype)

    def _aug(sig2):
        """Jump-augmented effective variance -> vol for the European floor."""
        return jnp.sqrt(sig2 + jvar)

    x = S_paths / K                                   # (n_steps+1, P)
    taus = (jnp.asarray(T, dtype)
            - jnp.arange(1, n_steps, dtype=dtype) * dt)  # (n_dates,)
    half = n_inner // 2
    sqrt_dt = jnp.sqrt(dt)

    if model == "sabr":
        # Exact replication of simulate_sabr's beta=1 transition in SPOT
        # units (S_t = F_t e^{-drift (T-t)} per simulate_paths, so the spot
        # gains an e^{drift dt} factor per step): given (S, a) draw
        # correlated (z1, z2) and advance both states exactly.
        nu_s = jnp.asarray(sabr.nu, dtype)
        rho_s = jnp.asarray(sabr.rho, dtype)
        rho_bar_s = jnp.sqrt(1.0 - rho_s**2)

        als = v_paths[1:n_steps]                       # alpha at dates
        w_vals = _vhat(x[1:n_steps], K, cp, taus[:, None], rate, q, als,
                       policy.betas, policy.x_mean[:, None],
                       policy.x_rstd[:, None], degree,
                       v=als, vm_t=policy.v_mean[:, None],
                       vr_t=policy.v_rstd[:, None])

        def date_ce(carry, inp):
            i, xp_t, ap_t, tau_t, b_t, m_t, rho_t, vm_t, vr_t = inp
            dkey = jax.random.fold_in(inner_key, i)
            z = _inner_normals(dkey, (2, half), xp_t.shape[0], inner_block,
                               first_block, dtype)
            z1, z2 = z[0], z[1]
            w2 = rho_s * z1 + rho_bar_s * z2
            a_row = ap_t[None, :]
            mu_row = (drift - 0.5 * a_row**2) * dt

            def w_at(s1, s2):
                x_in = xp_t[None, :] * jnp.exp(mu_row + a_row * sqrt_dt * s1)
                a_in = a_row * jnp.exp(nu_s * sqrt_dt * s2
                                       - 0.5 * nu_s**2 * dt)
                return _vhat(x_in, K, cp, tau_t, rate, q, a_in, b_t, m_t,
                             rho_t, degree, v=a_in, vm_t=vm_t, vr_t=vr_t)

            vals = w_at(z1, w2) + w_at(-z1, -w2)
            return carry, vals.mean(0) * 0.5

        _, ce = jax.lax.scan(
            date_ce, None,
            (jnp.arange(n_dates), x[0:n_steps - 1], v_paths[0:n_steps - 1],
             taus, policy.betas, policy.x_mean, policy.x_rstd,
             policy.v_mean, policy.v_rstd))            # (n_dates, P)

        # terminal: S' | (S, a) is exactly lognormal with one-step vol
        # a sqrt(dt) — closed-form Black, no inner noise.
        a_nm1 = v_paths[n_steps - 1]
        mu_T = (drift - 0.5 * a_nm1**2) * dt
        e_h = K * _one_step_black(x[n_steps - 1], mu_T,
                                  jnp.maximum(a_nm1 * sqrt_dt, 1e-6), spec.cp)
    elif model == "rbergomi":
        # The hybrid scheme's one-step law given F_t, replicated exactly via
        # the frozen Volterra history rb_hist[t] (docstring): fresh
        # (z1, z2, zp) advance (S, v) with the SAME formulas the simulator
        # uses (models/rbergomi.simulate_rbergomi), so the inner average is
        # conditionally unbiased and the dual bounds the discretized price.
        from options_model_tpu.models.rbergomi import _hybrid_weights
        import numpy as _np
        H_r = float(rbergomi.H)
        dtf = float(T) / n_steps
        _, c1_r, c2_r, var_np = _hybrid_weights(n_steps, H_r, dtf)
        sqrt2H = jnp.asarray(_np.sqrt(2.0 * H_r), dtype)
        c1_r = jnp.asarray(c1_r, dtype)
        c2_r = jnp.asarray(c2_r, dtype)
        eta_r = jnp.asarray(rbergomi.eta, dtype)
        xi0_r = jnp.asarray(rbergomi.xi0, dtype)
        rho_r = jnp.asarray(rbergomi.rho, dtype)
        rho_bar_r = jnp.sqrt(1.0 - rho_r**2)
        # discrete compensator at t_1..t_{n-1}: rows the inner v' lands on
        comp_next = 0.5 * eta_r**2 * jnp.asarray(var_np[1:n_steps], dtype)

        def _floor_sig(v):
            # tightness-only heuristic: blend the instantaneous variance
            # with its long-run level (the true forward-variance curve is
            # history-dependent; any measurable surrogate is legal).
            return jnp.sqrt(0.5 * (v + xi0_r))

        vs = v_paths[1:n_steps]
        w_vals = _vhat(x[1:n_steps], K, cp, taus[:, None], rate, q,
                       _floor_sig(vs),
                       policy.betas, policy.x_mean[:, None],
                       policy.x_rstd[:, None], degree,
                       v=vs, vm_t=policy.v_mean[:, None],
                       vr_t=policy.v_rstd[:, None])

        def date_ce(carry, inp):
            (i, xp_t, vp_t, h_t, comp_t1, tau_t, b_t, m_t, rho_t, vm_t,
             vr_t) = inp
            dkey = jax.random.fold_in(inner_key, i)
            z = _inner_normals(dkey, (3, half), xp_t.shape[0], inner_block,
                               first_block, dtype)
            z1, z2, zp = z[0], z[1], z[2]
            sv = jnp.sqrt(jnp.maximum(vp_t, 0.0))[None, :]
            mu_row = ((drift - 0.5 * vp_t) * dt)[None, :]

            def w_at(s1, s2, sp):
                dW = sqrt_dt * s1
                x_in = xp_t[None, :] * jnp.exp(
                    mu_row + sv * (rho_r * dW + rho_bar_r * sqrt_dt * sp))
                Y_in = h_t[None, :] + sqrt2H * (c1_r * dW + c2_r * s2)
                v_in = xi0_r * jnp.exp(eta_r * Y_in - comp_t1)
                return _vhat(x_in, K, cp, tau_t, rate, q, _floor_sig(v_in),
                             b_t, m_t, rho_t, degree,
                             v=v_in, vm_t=vm_t, vr_t=vr_t)

            # the simulator mirrors all three draws (antithetic contract)
            vals = w_at(z1, z2, zp) + w_at(-z1, -z2, -zp)
            return carry, vals.mean(0) * 0.5

        _, ce = jax.lax.scan(
            date_ce, None,
            (jnp.arange(n_dates), x[0:n_steps - 1], v_paths[0:n_steps - 1],
             rb_hist[0:n_steps - 1], comp_next, taus, policy.betas,
             policy.x_mean, policy.x_rstd, policy.v_mean, policy.v_rstd))

        # terminal: the price increment given v_{n-1} is exactly Gaussian
        # (left-point construction) — closed-form Black, no inner noise.
        v_nm1 = jnp.maximum(v_paths[n_steps - 1], 0.0)
        mu_T = (drift - 0.5 * v_nm1) * dt
        e_h = K * _one_step_black(
            x[n_steps - 1], mu_T,
            jnp.maximum(jnp.sqrt(v_nm1 * dt), 1e-6), spec.cp)
    elif use_v:
        kappa = jnp.asarray(heston.kappa, dtype)
        theta_h = jnp.asarray(heston.theta, dtype)
        xi = jnp.asarray(heston.xi, dtype)
        rho_h = jnp.asarray(heston.rho, dtype)
        rho_bar = jnp.sqrt(1.0 - rho_h**2)

        # W_t(x_t, v_t) at the observed states, dates t = 1..n_steps-1.
        vs = v_paths[1:n_steps]
        w_vals = _vhat(x[1:n_steps], K, cp, taus[:, None], rate, q,
                       _aug(_sigma_eff(vs, taus[:, None], heston,
                                       dtype) ** 2),
                       policy.betas, policy.x_mean[:, None],
                       policy.x_rstd[:, None], degree,
                       v=vs, vm_t=policy.v_mean[:, None],
                       vr_t=policy.v_rstd[:, None])

        def date_ce(carry, inp):
            i, xp_t, vp_t, tau_t, b_t, m_t, rho_t, vm_t, vr_t = inp
            dkey = jax.random.fold_in(inner_key, i)
            z = _inner_normals(dkey, (2, half), xp_t.shape[0], inner_block,
                               first_block, dtype)
            z1, z2 = z[0], z[1]
            w2 = rho_h * z1 + rho_bar * z2
            sv = jnp.sqrt(jnp.maximum(vp_t, 0.0) * dt)[None, :]
            mu_t = ((drift - 0.5 * vp_t) * dt - comp_dt)[None, :]
            dv = (kappa * (theta_h - vp_t) * dt)[None, :]
            if jp is not None:
                # Bates inner law = Heston Euler step x the simulator's exact
                # compound-jump increment; the count is shared by the
                # antithetic pair (each member still has the exact marginal).
                nj = _inner_poisson(jax.random.fold_in(dkey, 1), (half,),
                                    xp_t.shape[0], inner_block, first_block,
                                    lam_dt, dtype)
                zj = _inner_normals(jax.random.fold_in(dkey, 2), (half,),
                                    xp_t.shape[0], inner_block, first_block,
                                    dtype)
                jbase, jnoise = nj * mu_jj, sig_jj * jnp.sqrt(nj) * zj
            else:
                jbase = jnoise = jnp.asarray(0.0, dtype)

            def w_at(s1, s2, j):
                x_in = xp_t[None, :] * jnp.exp(mu_t + sv * s1 + j)
                v_in = jnp.maximum(vp_t[None, :] + dv + xi * sv * s2, 0.0)
                return _vhat(x_in, K, cp, tau_t, rate, q,
                             _aug(_sigma_eff(v_in, tau_t, heston,
                                             dtype) ** 2),
                             b_t, m_t, rho_t, degree,
                             v=v_in, vm_t=vm_t, vr_t=vr_t)

            vals = (w_at(z1, w2, jbase + jnoise)
                    + w_at(-z1, -w2, jbase - jnoise))
            return carry, vals.mean(0) * 0.5

        _, ce = jax.lax.scan(
            date_ce, None,
            (jnp.arange(n_dates), x[0:n_steps - 1], v_paths[0:n_steps - 1],
             taus, policy.betas, policy.x_mean, policy.x_rstd,
             policy.v_mean, policy.v_rstd))           # (n_dates, P)

        # Terminal step: S' | (S, v) is lognormal with one-step vol
        # sqrt(v dt) — the Black closed form stays exact under Heston; with
        # jumps it becomes the exact Poisson mixture of Black terms.
        v_nm1 = jnp.maximum(v_paths[n_steps - 1], 0.0)
        mu_T = (drift - 0.5 * v_nm1) * dt - comp_dt
        a2_T = jnp.maximum(v_nm1 * dt, 1e-12)
        if jp is not None:
            e_h = K * _one_step_jump_black(x[n_steps - 1], mu_T, a2_T,
                                           spec.cp, lam_dt, mu_jj, sig_jj)
        else:
            e_h = K * _one_step_black(x[n_steps - 1], mu_T, jnp.sqrt(a2_T),
                                      spec.cp)
    elif model == "vg":
        # Pure-jump VG: the inner one-step law is the simulator's EXACT
        # increment (models/vg.py) — a gamma time step G = nu*Gamma(dt/nu)
        # and a conditional normal. The antithetic inner pair shares G and
        # mirrors the normal (each member keeps the exact marginal — the
        # Poisson-count rule of the merton/bates branches). The surrogate's
        # European floor uses the VG quadratic-variation rate
        # sigma^2 + nu theta^2 (tightness only, never validity).
        sigv = jnp.asarray(vg.sigma, dtype)
        thv = jnp.asarray(vg.theta, dtype)
        nuv = jnp.asarray(vg.nu, dtype)
        om = jnp.log1p(-thv * nuv - 0.5 * sigv**2 * nuv) / nuv
        mu = (drift + om) * dt
        sig_f = jnp.sqrt(sigv**2 + nuv * thv**2)
        alpha = dt / nuv

        w_vals = _vhat(x[1:n_steps], K, cp, taus[:, None], rate, q, sig_f,
                       policy.betas, policy.x_mean[:, None],
                       policy.x_rstd[:, None], degree)

        def date_ce(carry, inp):
            i, xp_t, tau_t, b_t, m_t, rho_t = inp
            dkey = jax.random.fold_in(inner_key, i)
            z = _inner_normals(dkey, (half,), xp_t.shape[0], inner_block,
                               first_block, dtype)
            G = nuv * _inner_gamma(jax.random.fold_in(dkey, 1), (half,),
                                   xp_t.shape[0], inner_block, first_block,
                                   alpha, dtype)
            jb, jn = thv * G, sigv * jnp.sqrt(G) * z
            x_up = xp_t[None, :] * jnp.exp(mu + jb + jn)
            x_dn = xp_t[None, :] * jnp.exp(mu + jb - jn)
            vals = (_vhat(x_up, K, cp, tau_t, rate, q, sig_f, b_t, m_t,
                          rho_t, degree)
                    + _vhat(x_dn, K, cp, tau_t, rate, q, sig_f, b_t, m_t,
                            rho_t, degree))
            return carry, vals.mean(0) * 0.5

        _, ce = jax.lax.scan(
            date_ce, None,
            (jnp.arange(n_dates), x[0:n_steps - 1], taus, policy.betas,
             policy.x_mean, policy.x_rstd))           # (n_dates, P)

        # Terminal step: no finite Black mixture exists over the gamma clock,
        # so Rao-Blackwellize — sample ONLY G and take the Black closed form
        # conditional on it (lognormal given G). The residual inner noise
        # only loosens the dual (the docstring's validity argument), and
        # integrating out the normal removes most of it.
        tkey = jax.random.fold_in(inner_key, n_dates)
        G_T = nuv * _inner_gamma(tkey, (half,), x.shape[1], inner_block,
                                 first_block, alpha, dtype)
        e_h = K * jnp.mean(_one_step_black(
            x[n_steps - 1][None, :], mu + thv * G_T,
            sigv * jnp.sqrt(jnp.maximum(G_T, 1e-20)), spec.cp), axis=0)
    else:
        # merton: the diffusion vol comes from the params (the simulated
        # transition uses merton.sigma; spec.sigma may echo it but the dual
        # must replicate the simulator exactly).
        sig = jnp.asarray(jp.sigma if model == "merton" else spec.sigma,
                          dtype)
        mu = (drift - 0.5 * sig * sig) * dt - comp_dt
        a = sig * jnp.sqrt(dt)

        # W_t(x_t) at the observed states, dates t = 1..n_steps-1
        # (betas (n_dates, d) broadcast against the (n_dates, P) state rows).
        w_vals = _vhat(x[1:n_steps], K, cp, taus[:, None], rate, q,
                       _aug(sig * sig),
                       policy.betas, policy.x_mean[:, None],
                       policy.x_rstd[:, None], degree)

        # E[W_{t+1}(x') | x_t] for t = 0..n_steps-2: one-step nested inner
        # average with FRESH normals per date (martingale validity — module
        # docstring), scanned over dates so memory stays O(n_inner*n_paths).
        def date_ce(carry, inp):
            i, xp_t, tau_t, b_t, m_t, rho_t = inp
            dkey = jax.random.fold_in(inner_key, i)
            z = _inner_normals(dkey, (half,), xp_t.shape[0], inner_block,
                               first_block, dtype)
            if jp is not None:
                # Merton inner law = GBM step x exact compound-jump increment
                # (count shared by the antithetic pair).
                nj = _inner_poisson(jax.random.fold_in(dkey, 1), (half,),
                                    xp_t.shape[0], inner_block, first_block,
                                    lam_dt, dtype)
                zj = _inner_normals(jax.random.fold_in(dkey, 2), (half,),
                                    xp_t.shape[0], inner_block, first_block,
                                    dtype)
                jbase, jnoise = nj * mu_jj, sig_jj * jnp.sqrt(nj) * zj
            else:
                jbase = jnoise = jnp.asarray(0.0, dtype)
            x_up = xp_t[None, :] * jnp.exp(mu + a * z + jbase + jnoise)
            x_dn = xp_t[None, :] * jnp.exp(mu - a * z + jbase - jnoise)
            sig_f = _aug(sig * sig)
            vals = (_vhat(x_up, K, cp, tau_t, rate, q, sig_f, b_t, m_t,
                          rho_t, degree)
                    + _vhat(x_dn, K, cp, tau_t, rate, q, sig_f, b_t, m_t,
                            rho_t, degree))
            return carry, vals.mean(0) * 0.5

        _, ce = jax.lax.scan(
            date_ce, None,
            (jnp.arange(n_dates), x[0:n_steps - 1], taus, policy.betas,
             policy.x_mean, policy.x_rstd))           # (n_dates, P)

        if jp is not None:
            e_h = K * _one_step_jump_black(x[n_steps - 1], mu, a * a,
                                           spec.cp, lam_dt, mu_jj, sig_jj)
        else:
            e_h = K * _one_step_black(x[n_steps - 1], mu, a, spec.cp)

    return _dual_assemble(S_paths, spec, T, w_vals, ce, e_h, eval_mask,
                          stat_pair_block, axis_name)


def _dual_assemble(S_paths, spec: OptionSpec, T, w_vals, ce, e_h, eval_mask,
                   stat_pair_block, axis_name):
    """Martingale increments -> pathwise max -> (upper, stderr).

    Shared tail of every dual estimator: increments in discounted units from
    the observed surrogate values ``w_vals`` (dates 1..n-1), the inner
    conditional expectations ``ce`` (dates 0..n-2), and the exact closed-form
    terminal expectation ``e_h`` (W_n = h, no inner noise)."""
    n_steps = S_paths.shape[0] - 1
    dtype = S_paths.dtype
    dt = jnp.asarray(T, dtype) / n_steps
    K = jnp.asarray(spec.strike, dtype)
    disc_pows = jnp.exp(-jnp.asarray(spec.rate, dtype) * dt
                        * jnp.arange(1, n_steps + 1, dtype=dtype))
    h_n = vanilla_payoff(S_paths[-1], K, spec.cp)
    deltas = jnp.concatenate([w_vals - ce, (h_n - e_h)[None, :]])
    deltas = deltas * disc_pows[:, None]              # (n_steps, P)

    M = jnp.concatenate([jnp.zeros_like(deltas[:1]),
                         jnp.cumsum(deltas, axis=0)])  # (n_steps+1, P)
    z = vanilla_payoff(S_paths, K, spec.cp)
    z = z * jnp.concatenate([jnp.ones((1,), dtype), disc_pows])[:, None]
    upper_paths = jnp.max(z - M, axis=0)

    upper, stderr, _ = masked_mean_stderr(upper_paths, eval_mask, axis_name,
                                          stat_pair_block)
    return upper, stderr


class NNPolicy(NamedTuple):
    """The shared continuation network as an exercise policy: the trained
    ContinuationMLP params plus the feature/target standardization fitted on
    the ITM training rows (american._nn_continuation). Unlike LSMPolicy the
    state is date-INDEPENDENT — tau enters through the feature basis
    (ops/lsm_basis.regression_features), so one net serves every date."""

    params: object       # ContinuationMLP params pytree
    x_mean: jnp.ndarray  # (n_features,)
    x_std: jnp.ndarray   # (n_features,)
    y_mean: jnp.ndarray  # ()
    y_std: jnp.ndarray   # ()
    # True when the net was trained on RESIDUAL targets over the closed-form
    # European baseline (american._nn_continuation): consumers must add the
    # same baseline back at their own states (_vhat_nn does).
    residual: bool = True


def fit_nn_policy(train_key: jax.Array, S_paths: jnp.ndarray,
                  spec: OptionSpec, T, lsm, *,
                  train_mask: Optional[jnp.ndarray] = None,
                  v_paths: Optional[jnp.ndarray] = None,
                  heston: Optional[HestonParams] = None):
    """Train the shared continuation net and return (policy, cash).

    Same two-pass algorithm as american.lsm_nn_backward (the reference's
    flagship scheme, options_model_3/options_model_3.py:439-651) — the
    stopped ``cash`` is identical to that pricer's on the same inputs; the
    NNPolicy additionally carries the net so the dual bound can evaluate the
    continuation at its inner one-step samples. ``v_paths`` appends the
    Heston variance feature exactly as lsm_nn_backward does."""
    from options_model_tpu.pricers.american import (
        _nn_continuation, _nn_stopped_cash)
    n_steps = S_paths.shape[0] - 1
    immediate, cont, terminal, ts, net = _nn_continuation(
        train_key, S_paths, spec, T, lsm, v_paths, train_mask,
        return_net=True, heston=heston)
    cash = _nn_stopped_cash(immediate, cont, terminal, ts, spec, T, n_steps)
    return NNPolicy(*net), cash


def _vhat_nn(x, K, cp, tau, rate, q, sigma, policy: NNPolicy, lsm, v=None):
    """NN value surrogate W_t(x[, v]) = max(h, E_t, clip(net, 0, cap)) —
    the same three-piece construction as the polynomial _vhat (see its
    docstring for why each piece exists) with the fitted continuation read
    from the shared net instead of per-date betas. The net is evaluated on
    the SAME standardized feature basis it was trained on; like the
    polynomial it is gated to the ITM side of the moneyness boundary (the
    masked training set saw only ITM rows) and clipped to [0, cap]."""
    from options_model_tpu.ops.lsm_basis import regression_features
    from options_model_tpu.pricers.regressors import mlp_predict
    feats = regression_features(K * x, K, tau)       # (..., 7)
    if v is not None:
        feats = jnp.concatenate([feats, v[..., None]], axis=-1)
    z = (feats - policy.x_mean) / policy.x_std
    c = mlp_predict(policy.params, z.reshape(-1, z.shape[-1]), lsm)
    c = c.reshape(x.shape) * policy.y_std + policy.y_mean
    cap = jnp.where(cp > 0, K * x, K)
    itm_side = cp * (x - 1.0) >= 0.0
    e = bs_price(K * x, K, tau, rate, sigma, cp, q=q)
    if policy.residual:
        # The net output is the early-exercise PREMIUM over the European
        # baseline (american._nn_continuation residual regression); ``sigma``
        # here is by construction the same baseline vol the training used
        # (spec.sigma for GBM, effective_bs_sigma(v, tau) for Heston).
        c = e + jnp.where(itm_side, jnp.maximum(c, 0.0), 0.0)
    c = jnp.where(itm_side, jnp.clip(c, 0.0, cap), 0.0)
    h = K * jnp.maximum(cp * (x - 1.0), 0.0)
    return jnp.maximum(jnp.maximum(h, e), c)


def dual_upper_from_nn_policy(inner_key: jax.Array, S_paths: jnp.ndarray,
                              spec: OptionSpec, T, policy: NNPolicy, lsm, *,
                              n_inner: int = 64,
                              model: str = "gbm",
                              heston: Optional[HestonParams] = None,
                              v_paths: Optional[jnp.ndarray] = None,
                              eval_mask: Optional[jnp.ndarray] = None,
                              stat_pair_block: Optional[int] = None,
                              inner_block: Optional[int] = None,
                              first_block: int = 0,
                              axis_name: Optional[str] = None):
    """Rogers dual upper bound under the shared-net continuation policy.

    The nn sibling of dual_upper_from_policy — identical martingale
    construction and validity argument (module docstring; fresh inner
    normals per date, policy independent of the eval paths), with the
    surrogate's continuation piece read from the trained ContinuationMLP at
    each (date, inner sample). ``lsm`` is the LSMConfig the net was trained
    with (static net architecture)."""
    n_steps = S_paths.shape[0] - 1
    n_dates = n_steps - 1
    if n_inner < 2 or n_inner % 2:
        raise ValueError("n_inner must be an even count >= 2 (antithetic "
                         "inner pairs)")
    if model not in ("gbm", "heston"):
        raise ValueError(f"model must be 'gbm' or 'heston', got {model!r}")
    use_v = model == "heston"
    if use_v:
        if heston is None or v_paths is None:
            raise ValueError("model='heston' needs heston params and "
                             "v_paths")
        if spec.sigma is not None:
            raise ValueError("heston dual: spec.sigma must be None (the "
                             "variance state drives the vol)")
        if int(policy.x_mean.shape[0]) != 8:
            raise ValueError("heston dual needs a policy trained WITH the "
                             "variance feature (8 features, got "
                             f"{int(policy.x_mean.shape[0])})")
    dtype = S_paths.dtype
    dt = jnp.asarray(T, dtype) / n_steps
    K = jnp.asarray(spec.strike, dtype)
    cp = jnp.asarray(spec.cp, dtype)
    rate = jnp.asarray(spec.rate, dtype)
    q = jnp.asarray(spec.div_yield, dtype)
    drift = rate - q

    x = S_paths / K                                   # (n_steps+1, P)
    taus = (jnp.asarray(T, dtype)
            - jnp.arange(1, n_steps, dtype=dtype) * dt)  # (n_dates,)
    half = n_inner // 2

    if use_v:
        kappa = jnp.asarray(heston.kappa, dtype)
        theta_h = jnp.asarray(heston.theta, dtype)
        xi = jnp.asarray(heston.xi, dtype)
        rho_h = jnp.asarray(heston.rho, dtype)
        rho_bar = jnp.sqrt(1.0 - rho_h**2)

        vs = v_paths[1:n_steps]
        w_vals = _vhat_nn(x[1:n_steps], K, cp, taus[:, None], rate, q,
                          _sigma_eff(vs, taus[:, None], heston, dtype),
                          policy, lsm, v=vs)

        def date_ce(carry, inp):
            i, xp_t, vp_t, tau_t = inp
            z = _inner_normals(jax.random.fold_in(inner_key, i), (2, half),
                               xp_t.shape[0], inner_block, first_block,
                               dtype)
            z1, z2 = z[0], z[1]
            w2 = rho_h * z1 + rho_bar * z2
            sv = jnp.sqrt(jnp.maximum(vp_t, 0.0) * dt)[None, :]
            mu_t = ((drift - 0.5 * vp_t) * dt)[None, :]
            dv = (kappa * (theta_h - vp_t) * dt)[None, :]

            def w_at(s1, s2):
                x_in = xp_t[None, :] * jnp.exp(mu_t + sv * s1)
                v_in = jnp.maximum(vp_t[None, :] + dv + xi * sv * s2, 0.0)
                return _vhat_nn(x_in, K, cp, tau_t, rate, q,
                                _sigma_eff(v_in, tau_t, heston, dtype),
                                policy, lsm, v=v_in)

            vals = w_at(z1, w2) + w_at(-z1, -w2)
            return carry, vals.mean(0) * 0.5

        _, ce = jax.lax.scan(
            date_ce, None,
            (jnp.arange(n_dates), x[0:n_steps - 1], v_paths[0:n_steps - 1],
             taus))                                   # (n_dates, P)

        v_nm1 = jnp.maximum(v_paths[n_steps - 1], 0.0)
        mu_T = (drift - 0.5 * v_nm1) * dt
        a_T = jnp.maximum(jnp.sqrt(v_nm1 * dt), 1e-6)
        e_h = K * _one_step_black(x[n_steps - 1], mu_T, a_T, spec.cp)
    else:
        sig = jnp.asarray(spec.sigma, dtype)
        mu = (drift - 0.5 * sig * sig) * dt
        a = sig * jnp.sqrt(dt)

        w_vals = _vhat_nn(x[1:n_steps], K, cp, taus[:, None], rate, q, sig,
                          policy, lsm)

        def date_ce(carry, inp):
            i, xp_t, tau_t = inp
            z = _inner_normals(jax.random.fold_in(inner_key, i), (half,),
                               xp_t.shape[0], inner_block, first_block,
                               dtype)
            x_up = xp_t[None, :] * jnp.exp(mu + a * z)
            x_dn = xp_t[None, :] * jnp.exp(mu - a * z)
            vals = (_vhat_nn(x_up, K, cp, tau_t, rate, q, sig, policy, lsm)
                    + _vhat_nn(x_dn, K, cp, tau_t, rate, q, sig, policy,
                               lsm))
            return carry, vals.mean(0) * 0.5

        _, ce = jax.lax.scan(
            date_ce, None,
            (jnp.arange(n_dates), x[0:n_steps - 1], taus))  # (n_dates, P)

        e_h = K * _one_step_black(x[n_steps - 1], mu, a, spec.cp)

    return _dual_assemble(S_paths, spec, T, w_vals, ce, e_h, eval_mask,
                          stat_pair_block, axis_name)


class BracketResult(NamedTuple):
    low: jnp.ndarray
    low_stderr: jnp.ndarray
    high: jnp.ndarray
    high_stderr: jnp.ndarray


def price_american_bracket(key: jax.Array, S0, T, spec: OptionSpec,
                           mc: MCConfig, *, poly_degree: int = 3,
                           engine: str = "auto", n_inner: int = 64,
                           model: str = "gbm",
                           heston: Optional[HestonParams] = None,
                           merton=None, bates=None, vg=None,
                           sabr=None, rbergomi=None,
                           lsm=None,
                           out_of_sample: bool = True) -> BracketResult:
    """Primal-dual bracket [low, high] for an American option on ONE
    simulation: the policy is fitted on alternating path blocks
    (american.oos_masks); the low-biased LSM estimate AND the Rogers dual
    upper bound are both evaluated on the complementary blocks, so the true
    price lies in [low - 2se, high + 2se] with high confidence — a bound on
    the estimator BIAS no point estimate can provide (module docstring).

    ``model='heston'`` (with ``heston``): the policy is fitted with the
    variance basis and the dual's inner sampler replicates the Euler
    transition — the bracket then brackets the discretized Heston American
    price with no PDE oracle in the loop (the ADI solver cross-checks it in
    the tests).

    ``lsm`` (LSMConfig): choose the policy family. ``regressor='nn'``
    brackets the reference's FLAGSHIP estimator — the shared continuation
    network (fit_nn_policy / dual_upper_from_nn_policy); 'poly' (or None)
    uses the per-date polynomial regressions, with ``lsm.poly_degree``
    overriding ``poly_degree``.

    ``out_of_sample=False`` fits and evaluates on all paths (cheaper, but the
    dual is then only an approximate bound — the policy has seen the eval
    paths).
    """
    use_v = model in ("heston", "bates", "sabr", "rbergomi")
    use_nn = lsm is not None and getattr(lsm, "regressor", "poly") == "nn"
    if use_nn and model in ("merton", "bates", "vg", "sabr", "rbergomi"):
        raise ValueError("the nn-policy dual supports gbm/heston; use the "
                         "poly policy for the other families")
    if lsm is not None and not use_nn:
        poly_degree = lsm.poly_degree
    if model == "heston" and heston is None:
        raise ValueError("model='heston' needs heston params")
    if model == "bates" and bates is None:
        raise ValueError("model='bates' needs bates params")
    if model == "merton" and merton is None:
        raise ValueError("model='merton' needs merton params")
    if model == "vg" and vg is None:
        raise ValueError("model='vg' needs vg params")
    if model == "sabr" and sabr is None:
        raise ValueError("model='sabr' needs sabr params")
    if model == "rbergomi" and rbergomi is None:
        raise ValueError("model='rbergomi' needs rbergomi params")
    if model == "gbm" and spec.sigma is None:
        raise ValueError("the one-step dual increments need spec.sigma "
                         "(GBM dynamics)")
    sim_key, inner_key = jax.random.split(key)
    if use_nn:
        train_key, inner_key = jax.random.split(inner_key)
    rb_hist = None
    if model == "rbergomi":
        # same stream as simulate_paths' rbergomi route, plus the frozen
        # Volterra history the exact inner sampler needs (module docstring).
        from options_model_tpu.models.rbergomi import simulate_rbergomi
        S_paths, v_paths, rb_hist = simulate_rbergomi(
            sim_key, S0, T, rbergomi, mc,
            rate=spec.rate - spec.div_yield, return_paths=True,
            return_variance=True, return_dual_state=True)
    else:
        out = simulate_paths(sim_key, S0, T, mc, model, sigma=spec.sigma,
                             rate=spec.rate, heston=heston, merton=merton,
                             bates=bates, vg=vg, sabr=sabr, engine=engine,
                             div_yield=spec.div_yield, return_variance=use_v)
        S_paths, v_paths = out if use_v else (out, None)
    pb = mc.path_block
    stat_pb = pb if mc.antithetic else None
    n_paths = S_paths.shape[1]
    if out_of_sample:
        if n_paths < 2 * pb:
            raise ValueError("out_of_sample needs at least two path blocks")
        train_mask, eval_mask = oos_masks(n_paths, pb, S_paths.dtype)
    else:
        train_mask = eval_mask = jnp.ones((n_paths,), S_paths.dtype)

    # Inner draws blocked on the antithetic pair block: the single-device
    # bracket then equals the mesh-sharded one (_inner_normals discipline).
    if use_nn:
        policy, cash = fit_nn_policy(train_key, S_paths, spec, T, lsm,
                                     train_mask=(train_mask if out_of_sample
                                                 else None),
                                     v_paths=v_paths, heston=heston)
        low, low_se, _ = masked_mean_stderr(cash, eval_mask, None, stat_pb)
        high, high_se = dual_upper_from_nn_policy(
            inner_key, S_paths, spec, T, policy, lsm, n_inner=n_inner,
            model=model, heston=heston, v_paths=v_paths, eval_mask=eval_mask,
            stat_pair_block=stat_pb, inner_block=pb)
    else:
        policy, cash = fit_lsm_policy(S_paths, spec, T,
                                      poly_degree=poly_degree,
                                      train_mask=train_mask,
                                      v_paths=v_paths)
        low, low_se, _ = masked_mean_stderr(cash, eval_mask, None, stat_pb)
        high, high_se = dual_upper_from_policy(inner_key, S_paths, spec, T,
                                               policy, n_inner=n_inner,
                                               model=model, heston=heston,
                                               merton=merton, bates=bates,
                                               vg=vg, sabr=sabr,
                                               rbergomi=rbergomi,
                                               rb_hist=rb_hist,
                                               v_paths=v_paths,
                                               eval_mask=eval_mask,
                                               stat_pair_block=stat_pb,
                                               inner_block=pb)
    return BracketResult(low=low, low_stderr=low_se,
                         high=high, high_stderr=high_se)
