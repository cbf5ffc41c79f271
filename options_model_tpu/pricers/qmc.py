"""Randomized-QMC option pricers: scrambled Sobol + Brownian bridge.

Beyond-reference capability (the reference's engines are pseudo-random MC
throughout, options_model_3/options_model_3.py:471-480): at equal path budget,
RQMC's O(N^-1 (log N)^d) discrepancy bound beats MC's O(N^-1/2) once the
Brownian bridge compresses the payoff's effective dimension into the leading
Sobol coordinates. Measured on the Asian leg (bench.py): ~20x stderr reduction
on the RAW payoff (``qmc_asian_stderr_ratio_raw``); the pricers AS SHIPPED
also compose the Kemna-Vorst control variate, and on that rougher residual
RQMC's remaining edge is ~4x (``qmc_asian_stderr_ratio_vs_mc``) — the
combined RQMC+CV estimator sits ~175x below raw MC
(scripts/exp_qmc_ratio.py decomposes the three ratios).

Statistics: K independent Matousek scrambles -> K i.i.d. unbiased replicate
means -> stderr over replicates (core/qmc.replicate_stats). No antithetic
pairing here — the scramble IS the randomization.

All device work (point generation, bridge, Euler scans, payoff reductions) is
one jitted program per (model, shape) — replicates stream through it with only
the (d x 30)-uint32 direction table changing.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from options_model_tpu.core.config import HestonParams, OptionSpec
from options_model_tpu.core.payoff import vanilla_payoff
from options_model_tpu.core.qmc import (
    bb_increments,
    replicate_stats,
    sobol_directions,
    sobol_normals,
    sobol_uniforms,
)


def _poisson_nmax(lam_mean: float) -> int:
    """Static sweep length covering Poisson(lam_mean) to tail mass < 1e-9:
    mean + 10 sigma + 12 (callers compute it from the CONCRETE lam*T at
    trace time — a fixed n_max would silently saturate the count and bias
    the price for large lam*T while the replicate stderr stayed tiny)."""
    lam_mean = float(lam_mean)
    if not np.isfinite(lam_mean) or lam_mean < 0:
        raise ValueError(f"lam*T must be finite and >= 0, got {lam_mean}")
    if lam_mean > 1e4:
        raise ValueError(f"lam*T = {lam_mean:g} is beyond the QMC count "
                         "sweep's practical range; use the mc sampler")
    return int(lam_mean + 10.0 * math.sqrt(lam_mean) + 12.0)


def _poisson_icdf(u, lam_mean, n_max: int = 24):
    """Poisson inverse CDF N(u) = min{n : P(X <= n) >= u} as a fixed
    vectorized sweep over n = 0..n_max-1 (XLA-friendly: no data-dependent
    loop). One Sobol coordinate then drives the jump COUNT with the net's
    exact one-dimensional stratification. Size ``n_max`` with _poisson_nmax
    — too small SILENTLY clamps the count."""
    dtype = u.dtype
    k = jnp.arange(n_max, dtype=dtype)
    from jax.scipy.special import gammaln
    logp = (-lam_mean + k * jnp.log(jnp.maximum(lam_mean, 1e-30))
            - gammaln(k + 1.0))
    pmf = jnp.where(lam_mean > 0, jnp.exp(logp), (k == 0).astype(dtype))
    cdf = jnp.cumsum(pmf)
    return jnp.sum((u[..., None] > cdf[None, :]).astype(dtype), axis=-1)


def _gamma_icdf(u, alpha, n_iter: int = 40):
    """Gamma(alpha, scale 1) inverse CDF by bisection on the regularized
    lower incomplete gamma (jax.scipy.special.gammainc) — fully vectorized,
    fixed trip count (XLA-friendly; no data-dependent loop), monotone in u
    (the one-dimensional stratification a Sobol coordinate needs survives
    the transform exactly).

    Bracket: [0, alpha + 12 sqrt(alpha) + 40] covers u <= 1 - 2^-31 (the
    largest centered-cell f32 Sobol uniform) for any alpha — the small-alpha
    tail is sub-exponential (quantile <= -ln(1-u) + O(alpha) ~ 21.5) and the
    large-alpha tail is Gaussian (12 sigma). 40 bisections put the bracket
    width below f32 resolution of the result."""
    from jax.scipy.special import gammainc

    dtype = u.dtype
    alpha = jnp.asarray(alpha, dtype)
    hi0 = alpha + 12.0 * jnp.sqrt(alpha) + 40.0

    def step(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        below = gammainc(alpha, mid) < u
        return jnp.where(below, mid, lo), jnp.where(below, hi, mid)

    lo, hi = jax.lax.fori_loop(
        0, n_iter, step,
        (jnp.zeros_like(u), jnp.broadcast_to(hi0, u.shape)))
    return 0.5 * (lo + hi)


def _pow2(n: int) -> int:
    """Sobol nets are balanced at powers of two — round the budget up."""
    return 1 << max(1, math.ceil(math.log2(max(2, n))))


def gbm_paths_qmc(sv, shift, S0, r, sigma, T, n_paths: int, n_steps: int,
                  dtype=jnp.float32) -> jnp.ndarray:
    """(n_steps+1, n_paths) GBM paths from one Sobol replicate (dim = n_steps).

    Exact log-Euler on bridge-ordered increments: log S_t = log S0 +
    (r - sigma^2/2) t + sigma W_t with W from core/qmc.brownian_bridge.
    """
    Z = sobol_normals(sv, shift, 0, n_paths, dtype)          # (P, n_steps)
    dW = bb_increments(Z, T)                                  # (n_steps, P)
    dt = jnp.asarray(T, dtype) / n_steps
    drift = (jnp.asarray(r, dtype) - 0.5 * jnp.asarray(sigma, dtype) ** 2) * dt
    logS = jnp.log(jnp.asarray(S0, dtype)) + jnp.cumsum(
        drift + jnp.asarray(sigma, dtype) * dW, axis=0)
    first = jnp.full((1, n_paths), jnp.log(jnp.asarray(S0, dtype)), dtype)
    return jnp.exp(jnp.concatenate([first, logS], axis=0))


def heston_terminal_qmc(sv, shift, S0, r, T, p: HestonParams,
                        n_paths: int, n_steps: int, dtype=jnp.float32,
                        return_paths: bool = False, Z=None,
                        dim_offset: int = 0):
    """Heston full-truncation Euler driven by two bridged Brownians
    (2 * n_steps Sobol coordinates starting at ``dim_offset``; asset factor
    on the even ones, the orthogonal variance component on the odd).

    Identical scheme to models/heston.simulate_heston (euler): the QMC price
    estimates the SAME discretized law, only the driving measure changes.
    ``Z``: precomputed (n_paths, >= dim_offset + 2*n_steps) normals — pass it
    when the caller already generated the point set (avoids regenerating the
    whole net; the Bates branch threads one matrix through count, size and
    diffusion).
    """
    if Z is None:
        Z = sobol_normals(sv, shift, 0, n_paths, dtype)
    Zh = Z[:, dim_offset:dim_offset + 2 * n_steps]
    # (slice BEFORE de-interleaving: callers may carry extra Sobol dims,
    # e.g. the Bates jump pair — 0::2 over the full width would misalign
    # the factor split)
    dB1 = bb_increments(Zh[:, 0::2], T)                       # asset driver
    dB2 = bb_increments(Zh[:, 1::2], T)                       # orthogonal
    dt = jnp.asarray(T, dtype) / n_steps
    kappa = jnp.asarray(p.kappa, dtype)
    theta = jnp.asarray(p.theta, dtype)
    xi = jnp.asarray(p.xi, dtype)
    rho = jnp.asarray(p.rho, dtype)
    rho_bar = jnp.sqrt(1.0 - rho ** 2)
    r_ = jnp.asarray(r, dtype)

    logS0 = jnp.full((n_paths,), jnp.log(jnp.asarray(S0, dtype)), dtype)
    v0 = jnp.full((n_paths,), jnp.asarray(p.v0, dtype), dtype)

    def step(carry, dw):
        logS, v = carry
        dws, db2 = dw
        dwv = rho * dws + rho_bar * db2
        v_plus = jnp.maximum(v, 0.0)
        sq = jnp.sqrt(v_plus)
        v_new = jnp.maximum(v_plus + kappa * (theta - v_plus) * dt
                            + xi * sq * dwv, 0.0)
        logS_new = logS + (r_ - 0.5 * v_plus) * dt + sq * dws
        return (logS_new, v_new), (logS_new if return_paths else None)

    (logS_T, _), rows = jax.lax.scan(step, (logS0, v0), (dB1, dB2))
    if return_paths:
        return jnp.exp(jnp.concatenate([logS0[None], rows], axis=0))
    return jnp.exp(logS_T)


def _run_replicates(seed: int, dim: int, replicates: int, jitted_rep):
    """Host loop over independent scrambles; device work stays one compile."""
    means = []
    for k in range(replicates):
        sv, shift = sobol_directions(dim, scramble_seed=seed * 1000 + k)
        means.append(jitted_rep(jnp.asarray(sv), jnp.asarray(shift)))
    return replicate_stats(jnp.stack(means))


def price_european_qmc(seed: int, model: str, S0, spec: OptionSpec, T, *,
                       heston: Optional[HestonParams] = None,
                       merton=None, bates=None, vg=None, rbergomi=None,
                       rbergomi_cv: bool = True,
                       n_paths: int = 1 << 14, n_steps: int = 64,
                       replicates: int = 16, dtype=jnp.float32
                       ) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """European vanilla price under RQMC. Returns (price, stderr, n_total).

    model='gbm' uses the exact one-dimensional terminal law (S_T needs only
    W_T — Sobol dim 1 is a stratification of the real line, error ~O(1/N));
    model='heston' runs the bridged 2-factor Euler scheme. model='merton'
    is EXACT in 3 Sobol dims (diffusion normal, jump count via the Poisson
    inverse CDF, aggregated jump-size normal — no time discretization at
    all); model='bates' appends the same (count, size) pair to the bridged
    Heston dims (the compound jump over [0, T] is one Poisson draw,
    models/bates.py's terminal collapse). model='vg' is EXACT in 2 Sobol
    dims (conditional normal + the gamma time increment via _gamma_icdf —
    the terminal VG law is one gamma clock draw, models/vg.py).
    model='rbergomi' drives the BLP hybrid scheme with 3*n_steps Sobol
    coordinates: the vol-driving dW and the orthogonal price normals are
    Brownian-bridged on the interleaved leading 2*n_steps dims (the
    bridge owns the coarse shape BOTH factors share), the singular-interval
    correction normals take the trailing block raw (small variance share).
    Layout A/B (measured raw-payoff stderr at 8 x 2^14):
    interleaved 0.0066 beats sequential blocks 0.0093 and a
    price-Brownian-first bridge 0.0094 — both factors genuinely want
    leading coordinates;
    ``rbergomi_cv`` composes the same-path conditional-Black control
    variate at beta=1 (the frozen-variance lognormal on the identical
    price Brownian prices by Black-Scholes exactly — models/rbergomi.py's
    CV discipline; the bench reports the RQMC edge both raw and on the CV
    residual, the r4 lesson).
    """
    n_paths = _pow2(n_paths)
    r = spec.rate
    drift = r - spec.div_yield
    disc = jnp.exp(-jnp.asarray(r, dtype) * jnp.asarray(T, dtype))

    if model == "gbm":
        sigma = jnp.asarray(spec.sigma, dtype)

        @jax.jit
        def rep_mean(sv, shift):
            Z = sobol_normals(sv, shift, 0, n_paths, dtype)[:, 0]
            S_T = jnp.asarray(S0, dtype) * jnp.exp(
                (drift - 0.5 * sigma ** 2) * jnp.asarray(T, dtype)
                + sigma * jnp.sqrt(jnp.asarray(T, dtype)) * Z)
            return jnp.mean(vanilla_payoff(S_T, spec.strike, spec.cp)) * disc

        dim = 1
    elif model == "heston":
        if heston is None:
            raise ValueError("heston params required for model='heston'")

        @jax.jit
        def rep_mean(sv, shift):
            S_T = heston_terminal_qmc(sv, shift, S0, drift, T, heston,
                                      n_paths, n_steps, dtype)
            return jnp.mean(vanilla_payoff(S_T, spec.strike, spec.cp)) * disc

        dim = 2 * n_steps
    elif model == "merton":
        if merton is None:
            raise ValueError("merton params required for model='merton'")
        from jax.scipy.special import ndtri
        sig = jnp.asarray(merton.sigma, dtype)
        lam = jnp.asarray(merton.lam, dtype)
        mu_j = jnp.asarray(merton.mu_j, dtype)
        sig_j = jnp.asarray(merton.sigma_j, dtype)
        kbar = jnp.exp(mu_j + 0.5 * sig_j ** 2) - 1.0
        Tf = jnp.asarray(T, dtype)
        n_max = _poisson_nmax(float(merton.lam) * float(T))

        @jax.jit
        def rep_mean(sv, shift):
            # ONE point-set generation; normals via ndtri on the same
            # uniforms (sobol_normals would regenerate the whole net).
            u = sobol_uniforms(sv, shift, 0, n_paths, dtype)   # (P, 3)
            nj = _poisson_icdf(u[:, 1], lam * Tf, n_max=n_max)
            logS = (jnp.log(jnp.asarray(S0, dtype))
                    + (drift - 0.5 * sig ** 2 - lam * kbar) * Tf
                    + sig * jnp.sqrt(Tf) * ndtri(u[:, 0])
                    + nj * mu_j + sig_j * jnp.sqrt(nj) * ndtri(u[:, 2]))
            return jnp.mean(vanilla_payoff(jnp.exp(logS), spec.strike,
                                           spec.cp)) * disc

        dim = 3
    elif model == "bates":
        if bates is None:
            raise ValueError("bates params required for model='bates'")
        from jax.scipy.special import ndtri
        lam = jnp.asarray(bates.lam, dtype)
        mu_j = jnp.asarray(bates.mu_j, dtype)
        sig_j = jnp.asarray(bates.sigma_j, dtype)
        kbar = jnp.exp(mu_j + 0.5 * sig_j ** 2) - 1.0
        Tf = jnp.asarray(T, dtype)
        hp = bates.heston
        n_max = _poisson_nmax(float(bates.lam) * float(T))

        @jax.jit
        def rep_mean(sv, shift):
            # Jump (count, size) on the LEADING dims 0-1 — for jump-heavy
            # parameters the terminal jump factor carries a large variance
            # share, and the net's equidistribution is best in its first
            # coordinates (the bridge packs the diffusion variance into the
            # following dims). One point-set generation for everything.
            u = sobol_uniforms(sv, shift, 0, n_paths, dtype)
            Z = ndtri(u)
            nj = _poisson_icdf(u[:, 0], lam * Tf, n_max=n_max)
            fac = jnp.exp(nj * mu_j + sig_j * jnp.sqrt(nj) * Z[:, 1])
            # Heston drift carries the jump compensator; the terminal jump
            # factor multiplies on (independent components — the exact
            # factorization models/bates.py documents).
            S_T = heston_terminal_qmc(sv, shift, S0, drift - lam * kbar, T,
                                      hp, n_paths, n_steps, dtype,
                                      Z=Z, dim_offset=2)
            return jnp.mean(vanilla_payoff(S_T * fac, spec.strike,
                                           spec.cp)) * disc

        dim = 2 * n_steps + 2
    elif model == "vg":
        if vg is None:
            raise ValueError("vg params required for model='vg'")
        from jax.scipy.special import ndtri
        sig = jnp.asarray(vg.sigma, dtype)
        th = jnp.asarray(vg.theta, dtype)
        nu = jnp.asarray(vg.nu, dtype)
        Tf = jnp.asarray(T, dtype)
        om = jnp.log1p(-th * nu - 0.5 * sig ** 2 * nu) / nu

        @jax.jit
        def rep_mean(sv, shift):
            # Exact 2-dim terminal law: conditional normal on dim 0 (the
            # dominant variance at moderate nu), the gamma clock on dim 1.
            u = sobol_uniforms(sv, shift, 0, n_paths, dtype)   # (P, 2)
            G = nu * _gamma_icdf(u[:, 1], Tf / nu)
            logS = (jnp.log(jnp.asarray(S0, dtype)) + (drift + om) * Tf
                    + th * G + sig * jnp.sqrt(G) * ndtri(u[:, 0]))
            return jnp.mean(vanilla_payoff(jnp.exp(logS), spec.strike,
                                           spec.cp)) * disc

        dim = 2
    elif model == "rbergomi":
        if rbergomi is None:
            raise ValueError("rbergomi params required for model='rbergomi'")
        from options_model_tpu.models.rbergomi import _hybrid_weights
        from options_model_tpu.pricers.blackscholes import bs_price

        W_np, c1_f, c2_f, var_np = _hybrid_weights(
            n_steps, float(rbergomi.H), float(T) / n_steps)
        W_mat = jnp.asarray(W_np, dtype)
        comp = (0.5 * float(rbergomi.eta) ** 2
                * jnp.asarray(var_np[:-1], dtype))
        sqrt2H = float(np.sqrt(2.0 * rbergomi.H))
        eta = jnp.asarray(rbergomi.eta, dtype)
        rho_p = jnp.asarray(rbergomi.rho, dtype)
        rho_bar = jnp.sqrt(1.0 - rho_p ** 2)
        xi0 = jnp.asarray(rbergomi.xi0, dtype)
        sig_cv = jnp.sqrt(xi0)
        dt = jnp.asarray(T, dtype) / n_steps
        dr = jnp.asarray(drift, dtype)
        logS0 = jnp.log(jnp.asarray(S0, dtype))
        cv_mean = bs_price(S0, spec.strike, T, r, sig_cv, spec.cp,
                           q=spec.div_yield)

        @jax.jit
        def rep_mean(sv, shift):
            Z = sobol_normals(sv, shift, 0, n_paths, dtype)  # (P, 3n)
            dW = bb_increments(Z[:, 0:2 * n_steps:2], T)     # vol driver
            dWp = bb_increments(Z[:, 1:2 * n_steps:2], T)    # orthogonal
            z2 = Z[:, 2 * n_steps:].T                        # (n, P) raw
            G = jnp.matmul(W_mat, dW, precision=jax.lax.Precision.HIGHEST)
            Y_tail = sqrt2H * (G[:-1] + c1_f * dW[:-1] + c2_f * z2[:-1])
            Y_left = jnp.concatenate(
                [jnp.zeros((1, n_paths), dtype), Y_tail], axis=0)
            v_left = xi0 * jnp.exp(eta * Y_left - comp[:, None])
            dB = rho_p * dW + rho_bar * dWp
            dlogS = (dr - 0.5 * v_left) * dt + jnp.sqrt(v_left) * dB
            S_T = jnp.exp(logS0 + jnp.sum(dlogS, axis=0))
            pay = disc * vanilla_payoff(S_T, spec.strike, spec.cp)
            if not rbergomi_cv:
                return jnp.mean(pay)
            dlogG = (dr - 0.5 * sig_cv ** 2) * dt + sig_cv * dB
            G_T = jnp.exp(logS0 + jnp.sum(dlogG, axis=0))
            cv_pay = disc * vanilla_payoff(G_T, spec.strike, spec.cp)
            return jnp.mean(pay - (cv_pay - cv_mean))

        dim = 3 * n_steps
    else:
        raise ValueError(f"model must be 'gbm', 'heston', 'merton', 'bates', "
                         f"'vg' or 'rbergomi', got {model!r}")

    price, stderr = _run_replicates(seed, dim, replicates, rep_mean)
    return price, stderr, replicates * n_paths


def price_asian_qmc(seed: int, S0, T, spec: OptionSpec, *,
                    model: str = "gbm",
                    heston: Optional[HestonParams] = None,
                    average: str = "arithmetic", strike_type: str = "fixed",
                    n_paths: int = 1 << 14, n_steps: int = 64,
                    replicates: int = 16, dtype=jnp.float32,
                    control_variate: str = "auto"
                    ) -> Tuple[jnp.ndarray, jnp.ndarray, int]:
    """Asian option under RQMC (mirrors pricers/exotics.price_asian_mc).

    The showcase QMC workload: the average is a smooth low-effective-dimension
    functional of the bridge's leading coordinates, so RQMC beats MC by ~10x+
    in stderr at equal paths (measured in tests/test_qmc.py).

    control_variate: 'auto' | 'on' | 'off' — the same Kemna-Vorst geometric
    variate as price_asian_mc, composed at the REPLICATE level: each scramble
    reports (payoff mean, variate mean), beta* is fit across the K i.i.d.
    replicate means (E[adj] = 0 exactly over scrambles, so the CV'd means
    stay unbiased up to the O(1/K) beta-fit term) and one regression degree
    of freedom is charged to the stderr (K-2 denominator). Eligibility rule
    is identical to the MC pricer: GBM + arithmetic + fixed strike.
    """
    if average not in ("arithmetic", "geometric"):
        raise ValueError("average must be 'arithmetic' or 'geometric'")
    if strike_type not in ("fixed", "floating"):
        raise ValueError("strike_type must be 'fixed' or 'floating'")
    if model not in ("gbm", "heston"):
        raise ValueError(f"model must be 'gbm' or 'heston', got {model!r}")
    if control_variate not in ("auto", "on", "off"):
        raise ValueError("control_variate must be 'auto', 'on' or 'off'")
    cv_ok = (model == "gbm" and average == "arithmetic"
             and strike_type == "fixed" and replicates >= 4)
    if control_variate == "on" and not cv_ok:
        raise ValueError("control_variate='on' requires model='gbm', "
                         "average='arithmetic', strike_type='fixed' and "
                         ">= 4 replicates")
    use_cv = cv_ok and control_variate != "off"
    n_paths = _pow2(n_paths)
    drift = spec.rate - spec.div_yield
    disc = jnp.exp(-jnp.asarray(spec.rate, dtype) * jnp.asarray(T, dtype))

    @jax.jit
    def rep_mean(sv, shift):
        if model == "gbm":
            S = gbm_paths_qmc(sv, shift, S0, drift, spec.sigma, T,
                              n_paths, n_steps, dtype)
        else:
            S = heston_terminal_qmc(sv, shift, S0, drift, T, heston,
                                    n_paths, n_steps, dtype,
                                    return_paths=True)
        monitored = S[1:]
        if average == "arithmetic":
            avg = jnp.mean(monitored, axis=0)
        else:
            avg = jnp.exp(jnp.mean(jnp.log(monitored), axis=0))
        if strike_type == "fixed":
            payoff = jnp.maximum(spec.cp * (avg - spec.strike), 0.0)
        else:
            payoff = jnp.maximum(spec.cp * (S[-1] - avg), 0.0)
        pay_mean = jnp.mean(payoff) * disc
        if not use_cv:
            return pay_mean, jnp.zeros((), dtype)
        from options_model_tpu.pricers.exotics import geometric_asian_bs_price
        geo = jnp.exp(jnp.mean(jnp.log(monitored), axis=0))
        geo_pay = jnp.maximum(spec.cp * (geo - spec.strike), 0.0)
        geo_cf = geometric_asian_bs_price(S0, spec.strike, T, spec.rate,
                                          spec.sigma, n_steps, spec.cp,
                                          spec.div_yield)
        return pay_mean, geo_cf - disc * jnp.mean(geo_pay)

    dim = n_steps if model == "gbm" else 2 * n_steps
    pairs = []
    for k in range(replicates):
        sv, shift = sobol_directions(dim, scramble_seed=seed * 1000 + k)
        pairs.append(rep_mean(jnp.asarray(sv), jnp.asarray(shift)))
    pm = jnp.stack([p[0] for p in pairs])
    if not use_cv:
        price, stderr = replicate_stats(pm)
        return price, stderr, replicates * n_paths
    am = jnp.stack([p[1] for p in pairs])
    from options_model_tpu.core.stats import optimal_cv_beta
    beta = optimal_cv_beta(pm, am)
    cvd = pm + beta * am
    price = jnp.mean(cvd)
    k = replicates
    var = jnp.sum((cvd - price) ** 2) / (k - 2)  # beta burns one dof
    return price, jnp.sqrt(var / k), replicates * n_paths
