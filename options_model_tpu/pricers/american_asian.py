"""American (Bermudan-on-the-grid) Asian options via LSM on the joint
(S, running-average) state.

Beyond-reference capability (the reference's American pricer is single-state
vanilla, options_model_3/options_model_3.py:482-560; its exotic pricer is a
stub, options_model_2.py:61-66): the Asian option's exercise value depends on
the running average A_t = mean(S_{t_1..t_k}), so the continuation regression
must see the PAIR (S_t, A_t) — an S-only basis misprices the policy exactly
the way the S-only Heston basis did before the variance column
(pricers/fd_heston.py's 0.68% find). The running-average matrix is one
parallel-prefix cumsum over the path matrix; everything else is the repo's
standard backward scan with the masked Gram-matmul WLS.

Validated against a float64 Hull-White (1993) representative-average binomial
oracle (pricers/fd_asian.py) the same way the Heston American leg is anchored
to the ADI solver: tests/test_american_asian.py.

Contract conventions match price_asian_mc (pricers/exotics.py): the average
runs over the monitoring dates t_i = i*T/n (not the spot), 'fixed' pays
cp*(A - K)^+ at exercise, 'floating' pays cp*(S_t - A_t)^+.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu.core.stats import masked_mean_stderr
from options_model_tpu.pricers.american import (_apply_cv, oos_masks,
                                                simulate_paths)
from options_model_tpu.pricers.regressors import masked_wls_predict_centered

_STRIKE_TYPES = ("fixed", "floating")


def running_average(S_paths: jnp.ndarray) -> jnp.ndarray:
    """(n, P) running arithmetic average A_k = mean(S_1..S_k) over the
    monitored dates of a (n+1, P) path matrix (row 0 is the spot and is NOT
    monitored — the price_asian_mc convention, exotics.py:49)."""
    n = S_paths.shape[0] - 1
    counts = jnp.arange(1, n + 1, dtype=S_paths.dtype)[:, None]
    return jnp.cumsum(S_paths[1:], axis=0) / counts


def _asian_payoff(S_t, A_t, K, cp, strike_type: str):
    if strike_type == "fixed":
        return jnp.maximum(cp * (A_t - K), 0.0)
    return jnp.maximum(cp * (S_t - A_t), 0.0)


def build_asian_basis(S_t, A_t, scale, itm, allsum, cp, strike_type: str,
                      v_t=None) -> jnp.ndarray:
    """(P, d) design for the continuation value on the joint (S, A) state.

    Columns: intercept; masked-centered/scaled u_s = S/scale and
    u_a = A/scale with the full cubic in each and the u_s*u_a cross term
    (the exercise boundary of a fixed-strike Asian is a curve in the (S, A)
    plane — the average supplies the moneyness, the spot the future drift);
    plus the uncentered intrinsic hinge (the kink feature the vanilla basis
    carries as (x-1)^+, pricers/american.build_centered_basis). ``v_t``
    (Heston) appends [w, w^2, u_s*w] exactly as the vanilla (S, v) basis
    does — continuation under stochastic vol is a function of the state.
    """
    def centered(col):
        wsum = jnp.maximum(allsum(itm.sum()), 1.0)
        m = allsum((col * itm).sum()) / wsum
        var = allsum(((col - m) ** 2 * itm).sum()) / wsum
        return (col - m) * jax.lax.rsqrt(jnp.maximum(var, 1e-12))

    u_s = centered(S_t / scale)
    u_a = centered(A_t / scale)
    cols = [jnp.ones_like(u_s), u_s, u_a,
            u_s * u_s, u_a * u_a, u_s * u_a,
            u_s * u_s * u_s, u_a * u_a * u_a]
    cols.append(_asian_payoff(S_t, A_t, scale, cp, strike_type) / scale)
    if v_t is not None:
        w = centered(v_t)
        cols += [w, w * w, u_s * w]
    return jnp.stack(cols, axis=-1)


def lsm_asian_backward(S_paths: jnp.ndarray, spec: OptionSpec, T, *,
                       strike_type: str = "fixed",
                       exercise_from: int = 1,
                       out_of_sample: bool = False,
                       pair_block: Optional[int] = None,
                       stat_pair_block: Optional[int] = None,
                       axis_name: Optional[str] = None,
                       v_paths: Optional[jnp.ndarray] = None,
                       return_cash: bool = False):
    """LSM backward induction on (n_steps+1, P) paths with the running
    average as the second regression state. Every monitoring date from
    ``exercise_from`` (1-based) onwards is an exercise date;
    ``exercise_from = n_steps`` disables early exercise entirely and the
    estimator collapses to the European Asian on the same paths (the
    structural limit tests/test_american_asian.py pins).

    Returns (price, stderr) — pair-mean stderr discipline — or the raw
    discounted per-path cashflow vector with ``return_cash`` (the CV
    composition in price_american_asian owns the statistic then).
    """
    if strike_type not in _STRIKE_TYPES:
        raise ValueError(f"strike_type must be one of {_STRIKE_TYPES}")
    n_steps = S_paths.shape[0] - 1
    dtype = S_paths.dtype
    dt = jnp.asarray(T, dtype) / n_steps
    disc = jnp.exp(-jnp.asarray(spec.rate, dtype) * dt)
    K = jnp.asarray(spec.strike, dtype)
    cp = jnp.asarray(spec.cp, dtype)
    # the strike scales the fixed contract; the spot scales the floating one
    # (kept as a traced array — this runs under jit)
    scale = (jnp.asarray(spec.strike, dtype) if strike_type == "fixed"
             else S_paths[0, 0])

    A = running_average(S_paths)  # A[t-1] is the average at date t
    cash = _asian_payoff(S_paths[-1], A[-1], K, cp, strike_type)
    n_paths = cash.shape[0]
    if out_of_sample:
        if pair_block is None:
            raise ValueError("out_of_sample=True requires pair_block")
        train_mask, eval_mask = oos_masks(n_paths, pair_block, dtype)
    else:
        train_mask = eval_mask = jnp.ones((n_paths,), dtype)

    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    def step(cash, t):
        cash = cash * disc
        S_t = S_paths[t]
        A_t = A[t - 1]
        v_t = None if v_paths is None else v_paths[t]
        immediate = _asian_payoff(S_t, A_t, K, cp, strike_type)
        itm = (immediate > 0).astype(dtype) * train_mask
        X = build_asian_basis(S_t, A_t, scale, itm, allsum, cp, strike_type,
                              v_t)
        continuation = masked_wls_predict_centered(X, cash, itm,
                                                   axis_name=axis_name)
        exercise = ((immediate > continuation) & (immediate > 0)
                    & (t >= exercise_from))
        return jnp.where(exercise, immediate, cash), None

    cash, _ = jax.lax.scan(step, cash, jnp.arange(n_steps - 1, 0, -1))
    cash = cash * disc
    if return_cash:
        return cash, eval_mask
    price, stderr, _ = masked_mean_stderr(cash, eval_mask, axis_name,
                                          stat_pair_block)
    return price, stderr


def price_american_asian(key: jax.Array, S0, T, spec: OptionSpec,
                         mc: Optional[MCConfig] = None, model: str = "gbm", *,
                         strike_type: str = "fixed",
                         heston: Optional[HestonParams] = None, merton=None,
                         bates=None, vg=None, sigma_fn=None,
                         out_of_sample: bool = False,
                         control_variate: str = "auto",
                         cv_beta: str = "opt",
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """American fixed-/floating-strike Asian option. Returns (price, stderr).

    ``mc.n_steps`` IS both the monitoring grid and the exercise grid (a
    Bermudan on the averaging dates — exercising between monitoring dates
    changes the contract's average, so the grids coincide by definition,
    unlike the vanilla LSM's Richardson-in-dates refinement).

    control_variate: 'auto' | 'on' | 'off' — the European GEOMETRIC-Asian
    leg on the same paths centered at its exact closed form
    (exotics.geometric_asian_bs_price), composed at the pair-mean optimal
    beta (core/stats.optimal_cv_beta). Exact only under GBM + fixed strike;
    'on' raises elsewhere, 'auto' skips.
    """
    if strike_type not in _STRIKE_TYPES:
        raise ValueError(f"strike_type must be one of {_STRIKE_TYPES}")
    if control_variate not in ("auto", "on", "off"):
        raise ValueError("control_variate must be 'auto', 'on' or 'off'")
    cv_ok = model == "gbm" and strike_type == "fixed"
    if control_variate == "on" and not cv_ok:
        raise ValueError("control_variate='on' requires model='gbm' and "
                         "strike_type='fixed' (the geometric closed form "
                         "is exact only there)")
    use_cv = cv_ok and control_variate != "off"
    mc = mc if mc is not None else MCConfig(n_paths=1 << 17, n_steps=25,
                                            path_block=4096)

    want_v = model == "heston"
    out = simulate_paths(key, S0, T, mc, model, sigma=spec.sigma,
                         rate=spec.rate, heston=heston, merton=merton,
                         bates=bates, vg=vg, sigma_fn=sigma_fn,
                         div_yield=spec.div_yield, return_variance=want_v)
    S, v_paths = out if want_v else (out, None)
    pb = mc.path_block if mc.antithetic else None

    if not use_cv:
        return lsm_asian_backward(
            S, spec, T, strike_type=strike_type,
            out_of_sample=out_of_sample, pair_block=pb or mc.path_block,
            stat_pair_block=pb, v_paths=v_paths)

    from options_model_tpu.pricers.exotics import geometric_asian_bs_price

    cash, eval_mask = lsm_asian_backward(
        S, spec, T, strike_type=strike_type, out_of_sample=out_of_sample,
        pair_block=pb or mc.path_block, v_paths=v_paths, return_cash=True)
    dtype = cash.dtype
    disc_T = jnp.exp(-jnp.asarray(spec.rate, dtype) * jnp.asarray(T, dtype))
    geo = jnp.exp(jnp.mean(jnp.log(S[1:]), axis=0))
    geo_pay = jnp.maximum(spec.cp * (geo - spec.strike), 0.0)
    geo_cf = geometric_asian_bs_price(S0, spec.strike, T, spec.rate,
                                      spec.sigma, mc.n_steps, spec.cp,
                                      spec.div_yield)
    adj = geo_cf.astype(dtype) - disc_T * geo_pay  # E[adj] = 0 exactly
    stat = _apply_cv(cash, adj, cv_beta, eval_mask, pair_block=pb)
    price, stderr, _ = masked_mean_stderr(stat, eval_mask,
                                          pair_block=pb)
    return price, stderr
