"""Variance Gamma (Madan-Carr-Chang 1998) pure-jump Levy simulation.

Beyond-reference dynamics family (the reference has GBM, Heston and the NN
local vol). Step design: VG increments over ANY step are exact —
conditional on the gamma time increment G ~ Gamma(dt/nu, scale nu), the log
increment is (r - q + omega) dt + theta*G + sigma*sqrt(G)*Z — so each step is
two fixed-shape draws (gamma clock, normal) and pure elementwise math, and
the terminal law needs just ONE step (vg_terminal_exact: zero discretization
bias for European payoffs). Increments are independent across time, so the
path build is the same log-space parallel-prefix cumsum as GBM/Merton
(models/{gbm,merton}.py): no sequential scan.

Antithetic discipline: the NORMAL draw mirrors within a block as usual; the
gamma clock cannot be mirrored (no measure-preserving reflection of a gamma
variate — the same argument as the Poisson count in models/merton.py), so it
is drawn full-width. Pairs still share mirrored conditional-normal noise
(the dominant variance at moderate nu), and pair means remain the i.i.d.
unit for stderrs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import MCConfig, VGParams
from options_model_tpu.models.blocks import num_blocks


def _vg_omega(params: VGParams, dtype):
    """Traceable martingale compensator ln(1 - theta nu - sigma^2 nu/2)/nu."""
    sig = jnp.asarray(params.sigma, dtype)
    th = jnp.asarray(params.theta, dtype)
    nu = jnp.asarray(params.nu, dtype)
    # log1p: stable as nu -> 0 (the compensator tends to -theta - sigma^2/2)
    return jnp.log1p(-th * nu - 0.5 * sig**2 * nu) / nu


def _vg_increment(kt, params: VGParams, dt, cfg: MCConfig, dtype):
    """One exact VG log-increment over dt for a path block (antithetic z)."""
    kz, kg = (jax.random.fold_in(kt, d) for d in range(2))
    if cfg.antithetic:
        half = cfg.path_block // 2
        zh = jax.random.normal(kz, (half,), dtype)
        z = jnp.concatenate([zh, -zh])
    else:
        z = jax.random.normal(kz, (cfg.path_block,), dtype)
    nu = jnp.asarray(params.nu, dtype)
    G = nu * jax.random.gamma(kg, dt / nu, (cfg.path_block,), dtype)
    th = jnp.asarray(params.theta, dtype)
    sig = jnp.asarray(params.sigma, dtype)
    return th * G + sig * jnp.sqrt(G) * z


def simulate_vg(key: jax.Array, S0, r, T, params: VGParams, cfg: MCConfig,
                return_paths: bool = True, first_block=0):
    """Simulate Variance Gamma paths.

    Returns (n_steps+1, n_paths) when return_paths else terminal (n_paths,).
    ``r`` is the risk-neutral DRIFT (callers subtract any dividend yield);
    the compensator omega keeps the discounted price a martingale. Every
    increment is EXACT (the gamma bridge is not needed for a left-to-right
    build), so n_steps only sets the monitoring/exercise grid — there is no
    discretization bias to refine away.
    """
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    dt = jnp.asarray(T, dtype) / n_steps
    drift = (jnp.asarray(r, dtype) + _vg_omega(params, dtype)) * dt
    nb = num_blocks(cfg)
    logS0 = jnp.log(jnp.asarray(S0, dtype))

    def sim_block(block_key):
        inc = jax.vmap(lambda t: drift + _vg_increment(
            jax.random.fold_in(block_key, t), params, dt, cfg, dtype))(
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


def vg_terminal_exact(key: jax.Array, S0, r, T, params: VGParams,
                      cfg: MCConfig, first_block=0):
    """(n_paths,) EXACT terminal samples — one gamma + one normal per path
    (the VG law at T is known in closed conditional form; the European
    sampler needs no path). Same block/fold_in keying discipline as the path
    simulator so chunked calls stay on disjoint streams."""
    dtype = cfg.dtype
    T = jnp.asarray(T, dtype)
    drift = (jnp.asarray(r, dtype) + _vg_omega(params, dtype)) * T
    nb = num_blocks(cfg)
    logS0 = jnp.log(jnp.asarray(S0, dtype))

    def sim_block(block_key):
        x = _vg_increment(block_key, params, T, cfg, dtype)
        return jnp.exp(logS0 + drift + x)

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(
        first_block + jnp.arange(nb))
    return jax.vmap(sim_block)(block_keys).reshape(nb * cfg.path_block)
