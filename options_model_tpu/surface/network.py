"""IV-surface network (plain JAX, core/nn.py layers).

Rebuilds ImprovedIVNetwork (NN_training_stock_iv.py:109-155): 2 -> hidden
projection, ``num_hidden_layers`` residual blocks of
Dense -> LayerNorm -> GELU -> Dropout, linear head, output floored at
``epsilon``. The output bias is initialized to the target-mean IV by the
trainer (reference :487-492).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from options_model_tpu.core import nn
from options_model_tpu.core.config import SurfaceTrainConfig


@dataclasses.dataclass(frozen=True)
class IVNetwork:
    """``init(key, x)`` returns ``{"params": {"Dense_0", "Dense_i"/
    "LayerNorm_{i-1}" per residual block, "head"}}``; ``apply(params, x,
    deterministic, rngs={"dropout": key})`` runs the net."""

    hidden_dim: int = 64
    num_hidden_layers: int = 4
    dropout: float = 0.1
    epsilon: float = 1e-4

    def init(self, key: jax.Array, x, deterministic: bool = True) -> dict:
        h, n = self.hidden_dim, self.num_hidden_layers
        keys = jax.random.split(key, n + 2)
        p = {"Dense_0": nn.dense_init(keys[0], x.shape[-1], h)}
        for i in range(n):
            p[f"Dense_{i + 1}"] = nn.dense_init(keys[i + 1], h, h)
            p[f"LayerNorm_{i}"] = nn.layer_norm_init(h)
        p["head"] = nn.dense_init(keys[n + 1], h, 1)
        return {"params": p}

    def apply(self, params: dict, x, deterministic: bool = True, rngs=None):
        p = params["params"]
        key = nn.dropout_key(rngs, deterministic)
        h = jax.nn.gelu(nn.dense(p["Dense_0"], x))
        for i in range(self.num_hidden_layers):
            b = nn.dense(p[f"Dense_{i + 1}"], h)
            b = jax.nn.gelu(nn.layer_norm(p[f"LayerNorm_{i}"], b))
            b = nn.dropout(b, self.dropout,
                           None if key is None else jax.random.fold_in(key, i))
            h = h + b
        out = nn.dense(p["head"], h)
        # Leaky floor at epsilon: value ~= epsilon below the floor but the
        # gradient stays alive (slope 0.01). A hard max — like the reference's
        # .clamp(min=eps), NN_training_stock_iv.py:155 — has zero gradient
        # below the floor, and a few large early penalty steps can pin the
        # whole net there permanently (observed: all predictions == 1e-4).
        return jnp.maximum(out, self.epsilon) + 0.01 * jnp.minimum(out - self.epsilon, 0.0)


def make_network(cfg: SurfaceTrainConfig) -> IVNetwork:
    return IVNetwork(hidden_dim=cfg.hidden_dim,
                     num_hidden_layers=cfg.num_hidden_layers,
                     dropout=cfg.dropout, epsilon=cfg.epsilon)


def init_params(cfg: SurfaceTrainConfig, key: jax.Array, target_mean_iv: float):
    """Init with output = mean target IV exactly: bias = mean, head kernel = 0.

    The bias init follows the reference (NN_training_stock_iv.py:487-492); the
    zero kernel is an intended-behavior upgrade: with a random head kernel the
    initial output is mean +- O(0.4) — dropout noise then dominates the tiny
    IV signal (target std ~0.02) and training collapses toward a constant
    (observed). Zero head => exact-mean start and noise that only grows as the
    head learns.
    """
    net = make_network(cfg)
    params = net.init(key, jnp.zeros((1, 2)), deterministic=True)
    params = jax.tree_util.tree_map(lambda x: x, params)  # unfreeze-safe copy
    params["params"]["head"]["bias"] = (
        params["params"]["head"]["bias"] * 0.0 + jnp.asarray(target_mean_iv, jnp.float32))
    params["params"]["head"]["kernel"] = params["params"]["head"]["kernel"] * 0.0
    return params
