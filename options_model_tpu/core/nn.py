"""Plain-JAX neural-network layers over nested-dict parameter pytrees.

Dense, LayerNorm and dropout with Flax's default initialisers and numerics
(lecun-normal kernels, zero biases, unit LayerNorm scale, epsilon 1e-6), and
the same parameter layout (``{"params": {"Dense_0": {"kernel", "bias"}, ...}}``),
so nets built on them keep their shapes and checkpoints.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_LECUN_NORMAL = jax.nn.initializers.lecun_normal()


def dense_init(key: jax.Array, d_in: int, d_out: int, dtype=jnp.float32) -> dict:
    return {"kernel": _LECUN_NORMAL(key, (d_in, d_out), dtype),
            "bias": jnp.zeros((d_out,), dtype)}


def dense(p: dict, x):
    return x @ p["kernel"] + p["bias"]


def layer_norm_init(d: int, dtype=jnp.float32) -> dict:
    return {"scale": jnp.ones((d,), dtype), "bias": jnp.zeros((d,), dtype)}


def layer_norm(p: dict, x, eps: float = 1e-6):
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(x * x, axis=-1, keepdims=True) - mean**2, 0.0)
    return (x - mean) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def dropout(x, rate: float, key):
    """Inverted dropout; identity when ``key`` is None (deterministic)."""
    if key is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep == 0.0:
        return jnp.zeros_like(x)
    mask = jax.random.bernoulli(key, keep, x.shape)
    return jnp.where(mask, x / keep, 0.0)


def dropout_key(rngs, deterministic: bool):
    """The dropout key of a Flax-style ``rngs={"dropout": key}`` argument."""
    if deterministic:
        return None
    if not rngs or "dropout" not in rngs:
        raise ValueError("non-deterministic apply needs rngs={'dropout': key}")
    return rngs["dropout"]
