"""SABR stochastic-volatility family (beyond-reference dynamics).

    dF = alpha_t F^beta dW1,   d alpha = nu alpha dW2,
    corr(dW1, dW2) = rho

The industry-standard smile model (Hagan, Kumar, Lesniewski, Woodward 2002,
"Managing Smile Risk"). Three legs, mirroring how the repo treats every
dynamics family (closed form = MC oracle AND control-variate leg; cf.
models/merton.py, calibration/charfn.py):

  * ``hagan_lognormal_iv`` — the closed-form lognormal implied vol
    (Hagan eq. 2.17a with the ATM-safe z/x(z) series), fully traceable, so
    smiles, calibration gradients, and Greeks differentiate through it.
  * ``simulate_sabr`` — a device-side simulator: the vol process is EXACTLY
    lognormal (alpha_{t+dt} = alpha_t exp(nu dW2 - nu^2 dt/2) — no
    discretization error in alpha), log-Euler on F for beta=1 and Euler
    with absorption at 0 for beta<1; same global-block counter RNG and
    antithetic layout as every other simulator (models/blocks.py).
  * ``calibrate_sabr`` — vega-weighted least squares on Hagan IVs with
    exact JAX gradients (float64 on host, the calibration discipline of
    calibration/calibrator.py), rho/nu multi-start.

The reference has no SABR; parity anchor is the same role Heston plays in
its calibration module (heston_calibration.py) — fit a smile, price with
the fitted dynamics.
"""

from __future__ import annotations

from contextlib import nullcontext as _null
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from options_model_tpu.core.config import MCConfig, SABRParams
from options_model_tpu.models.blocks import block_normals, num_blocks


def hagan_lognormal_iv(F, K, T, params: SABRParams, dtype=None):
    """Hagan et al. (2002) eq. 2.17a lognormal implied vol, elementwise in
    (F, K, T).

    ATM singularity handled by the z/x(z) -> 1 - rho z/2 + (2-3rho^2) z^2/12
    series below |z| < 1e-4 (both branches evaluated NaN-safe: the raw ratio
    uses a z clamped away from 0, the series is polynomial).
    """
    dt_ = dtype or jnp.result_type(F, K, T, float)
    F = jnp.asarray(F, dt_)
    K = jnp.asarray(K, dt_)
    T = jnp.asarray(T, dt_)
    alpha = jnp.asarray(params.alpha, dt_)
    beta = jnp.asarray(params.beta, dt_)
    rho = jnp.asarray(params.rho, dt_)
    nu = jnp.asarray(params.nu, dt_)

    one_b = 1.0 - beta
    logFK = jnp.log(F / K)
    FKb = (F * K) ** (0.5 * one_b)          # (FK)^((1-beta)/2)

    z = (nu / alpha) * FKb * logFK
    z_safe = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    xz = jnp.log((jnp.sqrt(1.0 - 2.0 * rho * z_safe + z_safe**2)
                  + z_safe - rho) / (1.0 - rho))
    ratio_raw = z_safe / xz
    ratio_ser = 1.0 - 0.5 * rho * z + (2.0 - 3.0 * rho**2) * z**2 / 12.0
    ratio = jnp.where(jnp.abs(z) < 1e-4, ratio_ser, ratio_raw)

    denom = FKb * (1.0 + one_b**2 * logFK**2 / 24.0
                   + one_b**4 * logFK**4 / 1920.0)
    correction = 1.0 + (one_b**2 * alpha**2 / (24.0 * FKb**2)
                        + 0.25 * rho * beta * nu * alpha / FKb
                        + (2.0 - 3.0 * rho**2) * nu**2 / 24.0) * T
    return (alpha / denom) * ratio * correction


def sabr_bs_price(F0, K, T, r, params: SABRParams, cp=1.0):
    """Black price of a European option under SABR: discount x Black(F0, K)
    at the Hagan lognormal vol. The family's closed-form oracle (approximate
    in O(T), exact as nu -> 0) and its control-variate anchor."""
    from options_model_tpu.pricers.blackscholes import bs_price
    iv = hagan_lognormal_iv(F0, K, T, params)
    # Black-76 via bs_price on the forward: S = F e^{-rT} with q = 0 prices
    # e^{-rT} Black(F, K, iv) exactly (bs_price's S e^{-qT} N(d1) form).
    disc_F = jnp.asarray(F0) * jnp.exp(-jnp.asarray(r) * jnp.asarray(T))
    return bs_price(disc_F, K, T, r, iv, cp)


def simulate_sabr(key: jax.Array, F0, T, params: SABRParams, cfg: MCConfig,
                  return_paths: bool = False, return_alpha: bool = False,
                  first_block=0):
    """Simulate SABR forward paths (martingale: no drift on F).

    Returns F_T (n_paths,) by default, the (n_steps+1, n_paths) path matrix
    with return_paths, plus the alpha path/terminal with return_alpha.
    The alpha update is the EXACT lognormal solution; F advances by log-Euler
    when beta == 1 (exact conditional on alpha being frozen over the step)
    and by an absorbing Euler step for beta < 1 (F pinned at 0 once hit —
    the CEV boundary behavior).
    """
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    dt = jnp.asarray(T, dtype) / n_steps
    sqrt_dt = jnp.sqrt(dt)
    half = cfg.path_block // 2
    nb = num_blocks(cfg)
    beta = float(params.beta)

    alpha0 = jnp.asarray(params.alpha, dtype)
    rho = jnp.asarray(params.rho, dtype)
    rho_bar = jnp.sqrt(1.0 - rho**2)
    nu = jnp.asarray(params.nu, dtype)

    def sim_block(block_key):
        vary0 = (jax.random.key_data(block_key).astype(dtype) * 0).sum()
        if beta == 1.0:
            state0 = jnp.full((cfg.path_block,), jnp.log(jnp.asarray(F0, dtype)),
                              dtype) + vary0
        else:
            state0 = jnp.full((cfg.path_block,), jnp.asarray(F0, dtype),
                              dtype) + vary0
        a0 = jnp.full((cfg.path_block,), alpha0, dtype) + vary0

        def step(carry, t):
            state, a = carry
            z1, z2 = block_normals(block_key, t, half, 2, cfg.antithetic, dtype)
            w1 = z1
            w2 = rho * z1 + rho_bar * z2
            if beta == 1.0:
                state_new = state - 0.5 * a**2 * dt + a * sqrt_dt * w1
            else:
                F_plus = jnp.maximum(state, 0.0)
                F_new = F_plus + a * F_plus**beta * sqrt_dt * w1
                state_new = jnp.where(state <= 0.0, 0.0,
                                      jnp.maximum(F_new, 0.0))
            # exact lognormal vol step (alpha is a GBM with zero drift)
            a_new = a * jnp.exp(nu * sqrt_dt * w2 - 0.5 * nu**2 * dt)
            out = (state_new, a_new) if return_paths else None
            return (state_new, a_new), out

        (state_T, a_T), ys = jax.lax.scan(step, (state0, a0),
                                          jnp.arange(n_steps))
        def to_F(s):
            return jnp.exp(s) if beta == 1.0 else s
        if return_paths:
            s_rows, a_rows = ys
            F = jnp.concatenate([to_F(state0)[None], to_F(s_rows)], axis=0)
            if return_alpha:
                return F, jnp.concatenate([a0[None], a_rows], axis=0)
            return F
        if return_alpha:
            return to_F(state_T), a_T
        return to_F(state_T)

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(
        first_block + jnp.arange(nb))
    out = jax.vmap(sim_block)(block_keys)

    def merge(x):
        if x.ndim == 3:
            return jnp.transpose(x, (1, 0, 2)).reshape(
                x.shape[1], nb * cfg.path_block)
        return x.reshape(nb * cfg.path_block)

    if isinstance(out, tuple):
        return tuple(merge(x) for x in out)
    return merge(out)


def sabr_european_mc(key: jax.Array, S0, K, r, T, params: SABRParams,
                     cfg: MCConfig, cp=1.0, q=0.0,
                     control_variate: bool = True
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """European price under SABR: simulate the FORWARD F_0 = S0 e^{(r-q)T},
    discount the terminal payoff at r.

    Control variate: the nu=0 lognormal forward driven by the SAME W1
    increments (its Black expectation is exact), applied at the pair-mean
    optimal beta — the repo-wide CV discipline (core/stats.optimal_cv_beta).
    Returns (price, stderr) with the antithetic pair-mean stderr.
    """
    from options_model_tpu.core.stats import masked_mean_stderr, optimal_cv_beta
    from options_model_tpu.pricers.blackscholes import bs_price

    dtype = cfg.dtype
    F0 = jnp.asarray(S0, dtype) * jnp.exp(
        (jnp.asarray(r, dtype) - jnp.asarray(q, dtype)) * jnp.asarray(T, dtype))
    disc = jnp.exp(-jnp.asarray(r, dtype) * jnp.asarray(T, dtype))

    if not control_variate:
        F_T = simulate_sabr(key, F0, T, params, cfg)
        pay = disc * jnp.maximum(cp * (F_T - K), 0.0)
        mean, se, _ = masked_mean_stderr(pay, pair_block=cfg.path_block)
        return mean, se

    # Re-simulate both the SABR forward and the frozen-vol lognormal forward
    # from the same per-step W1 stream: scan once carrying both states.
    n_steps = cfg.n_steps
    dt = jnp.asarray(T, dtype) / n_steps
    sqrt_dt = jnp.sqrt(dt)
    half = cfg.path_block // 2
    nb = num_blocks(cfg)
    alpha0 = jnp.asarray(params.alpha, dtype)
    rho = jnp.asarray(params.rho, dtype)
    rho_bar = jnp.sqrt(1.0 - rho**2)
    nu = jnp.asarray(params.nu, dtype)
    beta = float(params.beta)

    def sim_block(block_key):
        vary0 = (jax.random.key_data(block_key).astype(dtype) * 0).sum()
        logF0 = jnp.log(F0)
        if beta == 1.0:
            s0 = jnp.full((cfg.path_block,), logF0, dtype) + vary0
        else:
            s0 = jnp.full((cfg.path_block,), F0, dtype) + vary0
        a0 = jnp.full((cfg.path_block,), alpha0, dtype) + vary0
        g0 = jnp.full((cfg.path_block,), logF0, dtype) + vary0  # CV leg logF

        def step(carry, t):
            s, a, g = carry
            z1, z2 = block_normals(block_key, t, half, 2, cfg.antithetic, dtype)
            w1, w2 = z1, rho * z1 + rho_bar * z2
            if beta == 1.0:
                s_new = s - 0.5 * a**2 * dt + a * sqrt_dt * w1
            else:
                F_plus = jnp.maximum(s, 0.0)
                s_new = jnp.where(s <= 0.0, 0.0, jnp.maximum(
                    F_plus + a * F_plus**beta * sqrt_dt * w1, 0.0))
            a_new = a * jnp.exp(nu * sqrt_dt * w2 - 0.5 * nu**2 * dt)
            g_new = g - 0.5 * alpha0**2 * dt + alpha0 * sqrt_dt * w1
            return (s_new, a_new, g_new), None

        (s_T, _, g_T), _ = jax.lax.scan(step, (s0, a0, g0),
                                        jnp.arange(n_steps))
        F_T = jnp.exp(s_T) if beta == 1.0 else s_T
        return F_T, jnp.exp(g_T)

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(
        jnp.arange(nb))
    F_T, G_T = jax.vmap(sim_block)(block_keys)
    F_T = F_T.reshape(-1)
    G_T = G_T.reshape(-1)

    pay = disc * jnp.maximum(cp * (F_T - K), 0.0)
    cv_pay = disc * jnp.maximum(cp * (G_T - K), 0.0)
    # E[CV leg] = e^{-rT} Black(F0, K, alpha0): lognormal forward at vol
    # alpha0 (the leg's own n_steps log-Euler is EXACT for constant vol).
    cv_mean = bs_price(F0 * disc, K, T, r, alpha0, cp)
    adj = cv_pay - cv_mean
    b = optimal_cv_beta(pay, adj, pair_block=cfg.path_block)
    mean, se, _ = masked_mean_stderr(pay + b * adj, pair_block=cfg.path_block)
    return mean, se


def calibrate_sabr(F0, T, strikes, market_ivs, beta: Optional[float] = None,
                   weights=None, n_starts: int = 4):
    """Fit SABR to one expiry's smile by weighted least squares on Hagan IVs.

    beta: fixed backbone exponent (industry practice: beta is chosen, not
    fitted — it is near-degenerate with rho on a single smile; default 1.0).
    weights default to ATM-peaked Gaussians in log-moneyness (the vega-shaped
    weighting of calibration/calibrator.py). Multi-start over (rho, nu) —
    a bad vol-of-vol start parks in a local valley exactly like kappa/lam do
    for Heston/Bates. Float64 objective with exact JAX gradients on host.

    Returns (SABRParams, info dict with rmse/iters/success).
    """
    from scipy.optimize import minimize

    from options_model_tpu.calibration.calibrator import (
        _explicit_x64_scope, _try_enable_explicit_x64)

    K = np.asarray(strikes, np.float64)
    iv = np.asarray(market_ivs, np.float64)
    b = 1.0 if beta is None else float(beta)
    if weights is None:
        k = np.log(K / float(F0))
        weights = np.exp(-0.5 * (k / 0.25) ** 2)
    w = np.asarray(weights, np.float64)
    w = w / w.sum()

    # f64 objective on host (the calibration precision discipline,
    # calibration/calibrator.py): the Hagan chain is real-valued so f32
    # would work, but its ~1e-7 rounding floor caps round-trip recovery.
    have_x64 = _try_enable_explicit_x64()
    dtype = jnp.float64 if have_x64 else jnp.float32
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    scope = _explicit_x64_scope if have_x64 else None
    with (scope() if scope else _null()):
        w_j = jnp.asarray(w, dtype)
        K_j = jnp.asarray(K, dtype)
        iv_j = jnp.asarray(iv, dtype)

    # alpha seeded from the ATM vol: iv_ATM ~ alpha / F^{1-beta}
    i_atm = int(np.argmin(np.abs(K - float(F0))))
    alpha_seed = float(iv[i_atm]) * float(F0) ** (1.0 - b)

    def unpack(x):
        # soft bounds via transforms: alpha > 0, rho in (-1, 1), nu >= 0
        return (jnp.exp(x[0]), jnp.tanh(x[1]), jnp.exp(x[2]))

    def objective(x):
        a, r_, n_ = unpack(x)
        p = SABRParams(alpha=a, beta=b, rho=r_, nu=n_)
        model_iv = hagan_lognormal_iv(F0, K_j, T, p, dtype=dtype)
        return jnp.sqrt(jnp.sum(w_j * (model_iv - iv_j) ** 2))

    val_grad = jax.jit(jax.value_and_grad(objective))

    def f_np(x):
        xa = np.asarray(x, np.float64 if have_x64 else np.float32)
        with (scope() if scope else _null()):
            if cpu is not None:
                with jax.default_device(cpu):
                    v, g = val_grad(jax.device_put(xa, cpu))
            else:
                v, g = val_grad(jnp.asarray(xa))
        return float(v), np.asarray(g, np.float64)

    starts = [(alpha_seed, -0.3, 0.5), (alpha_seed, 0.3, 0.5),
              (alpha_seed, -0.6, 1.5), (alpha_seed, 0.0, 0.1)][:n_starts]
    best = None
    for a0, r0, n0 in starts:
        x0 = np.array([np.log(max(a0, 1e-4)), np.arctanh(r0),
                       np.log(max(n0, 1e-4))])
        res = minimize(f_np, x0, jac=True, method="L-BFGS-B",
                       options={"maxiter": 200, "ftol": 1e-14,
                                "gtol": 1e-12})
        if best is None or res.fun < best.fun:
            best = res
    a, r_, n_ = (float(v) for v in unpack(jnp.asarray(best.x)))
    params = SABRParams(alpha=a, beta=b, rho=r_, nu=n_).validate()
    return params, {"rmse": float(best.fun), "iters": int(best.nit),
                    "success": bool(best.success)}
