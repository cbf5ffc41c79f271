"""Correlated multi-asset GBM simulation for basket/rainbow/spread options.

Beyond-reference capability (the reference is single-asset throughout).
Shape discipline: the asset axis is a LEADING length-n axis over (block)
path vectors, so every per-step op is an (n_assets, block) elementwise op
plus ONE small (n x n) matmul against the correlation Cholesky factor —
batched, static shapes, no per-asset Python.

As with GBM (models/gbm.py), increments are independent across time, so the
time loop is a parallel-prefix cumsum in log space — no sequential scan.

RNG discipline matches core/rng.py: normals are keyed by (block, step, draw),
with draw index = asset index, so prices are invariant to chunking/sharding.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from options_model_tpu.core.config import MCConfig
from options_model_tpu.models.blocks import num_blocks


def correlation_cholesky(corr) -> jnp.ndarray:
    """Lower Cholesky factor of a correlation matrix, with validation.

    Raises on non-symmetric or non-positive-definite input at trace time
    (host-side numpy — correlation matrices are tiny static model data).
    """
    c = np.asarray(corr, np.float64)
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError(f"corr must be square, got shape {c.shape}")
    if not np.allclose(c, c.T, atol=1e-8):
        raise ValueError("corr must be symmetric")
    if not np.allclose(np.diag(c), 1.0, atol=1e-8):
        raise ValueError("corr must have unit diagonal")
    try:
        L = np.linalg.cholesky(c)
    except np.linalg.LinAlgError as e:
        raise ValueError("corr must be positive definite") from e
    return jnp.asarray(L, jnp.float32)


def simulate_gbm_basket(key: jax.Array, S0, r, sigmas, corr, T,
                        cfg: MCConfig, *, div_yields=None,
                        return_paths: bool = False, first_block=0):
    """Simulate n correlated GBM assets.

    S0, sigmas, div_yields: (n_assets,); corr: (n, n) correlation of the
    driving Brownians. Returns terminal (n_assets, n_paths) or full paths
    (n_steps+1, n_assets, n_paths). Antithetic pairing mirrors the whole
    correlated normal VECTOR (payoffs of mirrored paths pair across every
    asset, so the pair-mean stderr discipline carries over unchanged).
    """
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    S0 = jnp.atleast_1d(jnp.asarray(S0, dtype))
    sigmas = jnp.atleast_1d(jnp.asarray(sigmas, dtype))
    n_assets = S0.shape[0]
    if sigmas.shape[0] != n_assets:
        raise ValueError("S0 and sigmas must have the same length")
    q = (jnp.zeros(n_assets, dtype) if div_yields is None
         else jnp.atleast_1d(jnp.asarray(div_yields, dtype)))
    L = correlation_cholesky(corr).astype(dtype)
    if L.shape[0] != n_assets:
        raise ValueError("corr dimension must match the number of assets")

    dt = jnp.asarray(T, dtype) / n_steps
    drift = ((jnp.asarray(r, dtype) - q - 0.5 * sigmas**2) * dt)[:, None]
    vol = (sigmas * jnp.sqrt(dt))[:, None]
    half = cfg.path_block // 2
    nb = num_blocks(cfg)
    logS0 = jnp.log(S0)[:, None]

    def step_Z(block_key, t):
        """(n_assets, block) correlated normals for one step."""
        k = jax.random.fold_in(block_key, t)
        if cfg.antithetic:
            zh = jax.random.normal(k, (n_assets, half), dtype)
            z = jnp.concatenate([zh, -zh], axis=1)
        else:
            z = jax.random.normal(k, (n_assets, cfg.path_block), dtype)
        # one tiny (n x n) x (n x block) matmul, pinned to full f32: a TF32
        # pass would round z to 10 mantissa bits
        return jnp.matmul(L, z, precision=jax.lax.Precision.HIGHEST)

    def sim_block(block_key):
        Z = jax.vmap(lambda t: step_Z(block_key, t))(jnp.arange(n_steps))
        increments = drift[None] + vol[None] * Z          # (steps, n, block)
        if return_paths:
            logs = logS0[None] + jnp.cumsum(increments, axis=0)
            first = jnp.broadcast_to(logS0[None], (1, n_assets, cfg.path_block))
            return jnp.exp(jnp.concatenate([first, logs], axis=0))
        return jnp.exp(logS0 + jnp.sum(increments, axis=0))

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(
        first_block + jnp.arange(nb))
    out = jax.vmap(sim_block)(block_keys)
    if return_paths:  # (nb, steps+1, n, block) -> (steps+1, n, n_paths)
        return jnp.transpose(out, (1, 2, 0, 3)).reshape(
            n_steps + 1, n_assets, nb * cfg.path_block)
    return jnp.transpose(out, (1, 0, 2)).reshape(n_assets, nb * cfg.path_block)


def gbm_basket_terminal_exact(key: jax.Array, S0, r, sigmas, corr, T,
                              n_paths: int, *, div_yields=None,
                              antithetic: bool = True, dtype=jnp.float32):
    """Single-draw exact terminal law (the GBM terminal distribution is exact
    at any horizon) — the degenerate-optimal sampler for European baskets.
    Returns (n_assets, n_paths)."""
    S0 = jnp.atleast_1d(jnp.asarray(S0, dtype))
    sigmas = jnp.atleast_1d(jnp.asarray(sigmas, dtype))
    n_assets = S0.shape[0]
    q = (jnp.zeros(n_assets, dtype) if div_yields is None
         else jnp.atleast_1d(jnp.asarray(div_yields, dtype)))
    L = correlation_cholesky(corr).astype(dtype)
    half = n_paths // 2
    if antithetic:
        zh = jax.random.normal(key, (n_assets, half), dtype)
        Z = jnp.concatenate([zh, -zh], axis=1)
    else:
        Z = jax.random.normal(key, (n_assets, n_paths), dtype)
    W = jnp.matmul(L, Z, precision=jax.lax.Precision.HIGHEST)  # no TF32
    T = jnp.asarray(T, dtype)
    return S0[:, None] * jnp.exp(
        ((r - q - 0.5 * sigmas**2) * T)[:, None]
        + (sigmas * jnp.sqrt(T))[:, None] * W)
