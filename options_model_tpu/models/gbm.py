"""Geometric Brownian motion (Black-Scholes dynamics) path simulation.

Exact log-Euler scheme (the reference's simulator, Options_model.py:78-88,
options_model_3/options_model_3.py:471-480):

    S_t = S_{t-1} * exp((r - sigma^2/2) dt + sigma sqrt(dt) Z_t)

Design: because GBM increments are independent, the time loop is a
*cumulative sum in log space* — no sequential scan at all. XLA lowers cumsum to a
log-depth parallel prefix entirely on-device, and the terminal-only variant is a
single reduction (no path matrix ever materialized).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import MCConfig
from options_model_tpu.models.blocks import num_blocks


def _block_Z(block_key: jax.Array, n_steps: int, half: int, antithetic: bool, dtype):
    """(n_steps, 2*half) normals for one block, keyed by (block, step, draw=0)."""
    def step_draw(t):
        k = jax.random.fold_in(jax.random.fold_in(block_key, t), 0)
        if antithetic:
            zh = jax.random.normal(k, (half,), dtype)
            return jnp.concatenate([zh, -zh])
        return jax.random.normal(k, (2 * half,), dtype)

    return jax.vmap(step_draw)(jnp.arange(n_steps))


def simulate_gbm(key: jax.Array, S0, r, sigma, T, cfg: MCConfig,
                 return_paths: bool = True, first_block=0):
    """Simulate GBM paths.

    Returns (n_steps+1, n_paths) when return_paths else terminal (n_paths,),
    with n_paths = paths_rounded(cfg). ``first_block`` offsets the global
    path-block ids so chunked/sharded calls reproduce the unchunked stream.
    """
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    dt = jnp.asarray(T, dtype) / n_steps
    drift = (jnp.asarray(r, dtype) - 0.5 * jnp.asarray(sigma, dtype) ** 2) * dt
    diffusion = jnp.asarray(sigma, dtype) * jnp.sqrt(dt)
    half = cfg.path_block // 2
    nb = num_blocks(cfg)
    logS0 = jnp.log(jnp.asarray(S0, dtype))

    def sim_block(block_key):
        Z = _block_Z(block_key, n_steps, half, cfg.antithetic, dtype)
        increments = drift + diffusion * Z                      # (n_steps, block)
        if return_paths:
            log_paths = logS0 + jnp.cumsum(increments, axis=0)  # parallel prefix
            first = jnp.full((1, cfg.path_block), logS0, dtype)
            return jnp.exp(jnp.concatenate([first, log_paths], axis=0))
        return jnp.exp(logS0 + jnp.sum(increments, axis=0))

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(first_block + jnp.arange(nb))
    out = jax.vmap(sim_block)(block_keys)  # (nb, [n_steps+1,] block)
    if return_paths:
        return jnp.transpose(out, (1, 0, 2)).reshape(n_steps + 1, nb * cfg.path_block)
    return out.reshape(nb * cfg.path_block)


def gbm_step_normals(key: jax.Array, t, cfg: MCConfig, first_block=0):
    """Regenerate the step-t normals (n_paths,) of the stream simulate_gbm
    consumed — the RNG-counter rematerialization primitive behind the
    matrix-free LSM (pricers/replay.py). Bitwise identical to the forward
    pass's draws for the same (key, first_block, cfg)."""
    dtype = cfg.dtype
    half = cfg.path_block // 2
    nb = num_blocks(cfg)

    def block_draw(b):
        bk = jax.random.fold_in(key, b)
        k = jax.random.fold_in(jax.random.fold_in(bk, t), 0)
        if cfg.antithetic:
            zh = jax.random.normal(k, (half,), dtype)
            return jnp.concatenate([zh, -zh])
        return jax.random.normal(k, (cfg.path_block,), dtype)

    return jax.vmap(block_draw)(first_block + jnp.arange(nb)).reshape(-1)


def gbm_terminal_exact(key: jax.Array, S0, r, sigma, T, n_paths: int,
                       antithetic: bool = True, dtype=jnp.float32):
    """Single-draw exact terminal distribution S_T = S0 exp((r-sigma^2/2)T + sigma sqrt(T) Z).

    Statistically identical to the multi-step simulator for GBM (the log-normal
    law is exact at any horizon) at 1/n_steps the cost — the degenerate-optimal
    path for European pricing under constant vol.
    """
    half = n_paths // 2
    if antithetic:
        zh = jax.random.normal(key, (half,), dtype)
        Z = jnp.concatenate([zh, -zh])
    else:
        Z = jax.random.normal(key, (n_paths,), dtype)
    S0 = jnp.asarray(S0, dtype)
    T = jnp.asarray(T, dtype)
    return S0 * jnp.exp((r - 0.5 * sigma**2) * T + sigma * jnp.sqrt(T) * Z)
