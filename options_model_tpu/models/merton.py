"""Merton (1976) jump-diffusion simulation + closed-form European series.

Beyond-reference dynamics family (the reference has GBM, Heston and the NN
local vol — no jumps). Step design: the compound-Poisson jump sum
over a step is aggregated EXACTLY without simulating individual jumps —
conditional on the count N_t ~ Poisson(lam*dt), the summed log-jump is
N_t*mu_j + sigma_j*sqrt(N_t)*Z' — so each step is three fixed-shape draws
(diffusion normal, Poisson count, jump-aggregate normal) and pure elementwise
math. Increments stay independent across time, so the path build is the same
log-space parallel-prefix cumsum as GBM (models/gbm.py): no sequential scan.

Antithetic discipline: the two NORMAL draws mirror within a block as usual;
the Poisson count cannot be mirrored (no measure-preserving reflection), so
it is drawn full-width — pairs still share mirrored diffusion/jump-size noise
(most of the variance), and pair means remain the i.i.d. unit for stderrs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import MCConfig, MertonParams
from options_model_tpu.models.blocks import num_blocks


def simulate_merton(key: jax.Array, S0, r, T, params: MertonParams,
                    cfg: MCConfig, return_paths: bool = True, first_block=0):
    """Simulate Merton jump-diffusion paths.

    Returns (n_steps+1, n_paths) when return_paths else terminal (n_paths,).
    ``r`` is the risk-neutral DRIFT (callers subtract any dividend yield);
    the compensator -lam*kbar*dt keeps the discounted price a martingale.
    """
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    dt = jnp.asarray(T, dtype) / n_steps
    sig = jnp.asarray(params.sigma, dtype)
    lam = jnp.asarray(params.lam, dtype)
    mu_j = jnp.asarray(params.mu_j, dtype)
    sig_j = jnp.asarray(params.sigma_j, dtype)
    kbar = jnp.exp(mu_j + 0.5 * sig_j**2) - 1.0
    drift = (jnp.asarray(r, dtype) - 0.5 * sig**2 - lam * kbar) * dt
    diffusion = sig * jnp.sqrt(dt)
    half = cfg.path_block // 2
    nb = num_blocks(cfg)
    logS0 = jnp.log(jnp.asarray(S0, dtype))

    def step_increment(block_key, t):
        kt = jax.random.fold_in(block_key, t)
        kz, kn, kj = (jax.random.fold_in(kt, d) for d in range(3))
        if cfg.antithetic:
            zh = jax.random.normal(kz, (half,), dtype)
            z = jnp.concatenate([zh, -zh])
            jh = jax.random.normal(kj, (half,), dtype)
            zj = jnp.concatenate([jh, -jh])
        else:
            z = jax.random.normal(kz, (cfg.path_block,), dtype)
            zj = jax.random.normal(kj, (cfg.path_block,), dtype)
        n_jumps = jax.random.poisson(kn, lam * dt,
                                     (cfg.path_block,)).astype(dtype)
        jump_sum = n_jumps * mu_j + sig_j * jnp.sqrt(n_jumps) * zj
        return drift + diffusion * z + jump_sum

    def sim_block(block_key):
        inc = jax.vmap(lambda t: step_increment(block_key, t))(
            jnp.arange(n_steps))                       # (n_steps, block)
        if return_paths:
            logs = logS0 + jnp.cumsum(inc, axis=0)
            first = jnp.full((1, cfg.path_block), logS0, dtype)
            return jnp.exp(jnp.concatenate([first, logs], axis=0))
        return jnp.exp(logS0 + jnp.sum(inc, axis=0))

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(
        first_block + jnp.arange(nb))
    out = jax.vmap(sim_block)(block_keys)
    if return_paths:
        return jnp.transpose(out, (1, 0, 2)).reshape(
            n_steps + 1, nb * cfg.path_block)
    return out.reshape(nb * cfg.path_block)


def merton_price(S0, K, T, r, params: MertonParams, cp=1.0, q=0.0,
                 n_terms: int = 40, dtype=jnp.float32):
    """Merton's closed-form European price by conditioning on the jump count:

        sum_n e^{-lam T} (lam T)^n / n! * e^{-rT} Black(F_n, K, sigma_n)

    with F_n = S0 e^{(r_n - q) T}, sigma_n^2 = sigma^2 + n sigma_j^2 / T and
    r_n = r - lam kbar + n log(1 + kbar) / T. Equivalent to the textbook
    lam' = lam(1+kbar) weighting of full BS-at-r_n formulas (the factor
    e^{(r - r_n)T} moves between the weight and the discount — pair them
    consistently). 40 terms cover lam*T up to ~10 (the tail decays
    factorially). Fully traceable jnp (vectorized over the terms), so it
    serves both as the MC tests' oracle and as the control-variate closed
    form inside jitted pricers (pricers/american._cv_adjustment).
    """
    from jax.scipy.special import gammaln

    # blackscholes.ndtr, not jax.scipy's: the latter breaks float64 under
    # explicit-x64 mode (f32 internal constant) and cancels in the left tail.
    from options_model_tpu.pricers.blackscholes import ndtr

    S0 = jnp.asarray(S0, dtype)
    T = jnp.asarray(T, dtype)
    sig2 = jnp.asarray(params.sigma, dtype) ** 2
    sig_j2 = jnp.asarray(params.sigma_j, dtype) ** 2
    lam = jnp.asarray(params.lam, dtype)
    kbar = jnp.exp(jnp.asarray(params.mu_j, dtype) + 0.5 * sig_j2) - 1.0
    log1k = jnp.log1p(kbar)

    n = jnp.arange(n_terms, dtype=dtype)
    lamT = lam * T
    logw = -lamT + n * jnp.log(jnp.maximum(lamT, 1e-30)) - gammaln(n + 1.0)
    w = jnp.where(lamT > 0, jnp.exp(logw), (n == 0).astype(dtype))

    sig_n = jnp.sqrt(sig2 + n * sig_j2 / T)
    r_n = r - lam * kbar + n * log1k / T
    F = S0 * jnp.exp((r_n - q) * T)
    sq = sig_n * jnp.sqrt(T)
    d1 = (jnp.log(F / K) + 0.5 * sig_n**2 * T) / sq
    d2 = d1 - sq
    black = cp * (F * ndtr(cp * d1) - K * ndtr(cp * d2))
    return jnp.exp(-r * T) * jnp.sum(w * black)
