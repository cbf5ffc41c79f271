"""Local-volatility path simulation driven by a learned IV surface.

Per-step volatility sigma(S_t, tau_t) is queried from a caller-supplied function
(usually the IV-surface network, surface/model.py) *inside* the scan body —
the device-resident analogue of the reference's per-step NN inference
(simulate_local_vol_paths_antithetic, options_model_3/options_model_3.py:300-333;
torch version option_model_3_gpu.py:250-298). Because the surface net is a pure
function, the whole simulation jits into one XLA program: the tiny MLP matmuls
batch over all paths on the device with zero host round-trips (the reference paid a
device sync per step).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import MCConfig
from options_model_tpu.models.blocks import block_normals, num_blocks

# sigma_fn(S: (n,), tau: scalar) -> (n,) positive vols
SigmaFn = Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]


def simulate_local_vol(key: jax.Array, S0, r, T, sigma_fn: SigmaFn, cfg: MCConfig,
                       return_paths: bool = True, first_block=0):
    """Simulate local-vol paths: S_t = S_{t-1} exp((r - sigma^2/2) dt + sigma sqrt(dt) Z)
    with sigma = sigma_fn(S_{t-1}, tau_t), tau_t = max(T - (t-1) dt, 1e-6)."""
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    T_ = jnp.asarray(T, dtype)
    dt = T_ / n_steps
    sqrt_dt = jnp.sqrt(dt)
    half = cfg.path_block // 2
    nb = num_blocks(cfg)
    r_ = jnp.asarray(r, dtype)

    def sim_block(block_key):
        # See models/heston.py: carry must share the randomness' sharding
        # variance annotation under shard_map.
        vary0 = (jax.random.key_data(block_key).astype(dtype) * 0).sum()
        logS_init = jnp.full((cfg.path_block,), jnp.log(jnp.asarray(S0, dtype)), dtype) + vary0

        def step(logS, t):
            (z,) = block_normals(block_key, t, half, 1, cfg.antithetic, dtype)
            tau_t = jnp.maximum(T_ - t.astype(dtype) * dt, 1e-6)
            sig = jnp.maximum(sigma_fn(jnp.exp(logS), tau_t), 1e-6).astype(dtype)
            logS_new = logS + (r_ - 0.5 * sig**2) * dt + sig * sqrt_dt * z
            return logS_new, (logS_new if return_paths else None)

        logS_T, ys = jax.lax.scan(step, logS_init, jnp.arange(n_steps))
        if return_paths:
            return jnp.exp(jnp.concatenate([logS_init[None], ys], axis=0))
        return jnp.exp(logS_T)

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(first_block + jnp.arange(nb))
    out = jax.vmap(sim_block)(block_keys)
    if return_paths:
        return jnp.transpose(out, (1, 0, 2)).reshape(n_steps + 1, nb * cfg.path_block)
    return out.reshape(nb * cfg.path_block)
