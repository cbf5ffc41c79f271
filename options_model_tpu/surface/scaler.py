"""Feature scaling for the IV surface: center (m, tau) with floor-guarded scales.

Rebuilds DataScaler (NN_training_stock_iv.py:64-107) as an immutable pytree so
it can ride inside jitted functions and orbax checkpoints.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from options_model_tpu.core.pytree import pytree_dataclass


@pytree_dataclass
class SurfaceScaler:
    m_mean: float = 0.0
    m_scale: float = 1.0
    tau_mean: float = 0.0
    tau_scale: float = 1.0
    S0: float = 0.0

    @classmethod
    def fit(cls, m, tau, S0: float) -> "SurfaceScaler":
        """Center/scale log-moneyness and time-to-expiry; minimum scales match
        the reference (1e-3 for m, 1e-4 for tau)."""
        m = np.asarray(m, np.float64)
        tau = np.asarray(tau, np.float64)
        return cls(
            m_mean=float(m.mean()),
            m_scale=float(max(m.std(), 1e-3)),
            tau_mean=float(tau.mean()),
            tau_scale=float(max(tau.std(), 1e-4)),
            S0=float(S0),
        )

    def transform(self, m, tau):
        m_norm = (m - self.m_mean) / self.m_scale
        tau_norm = (tau - self.tau_mean) / self.tau_scale
        return m_norm, tau_norm

    def features(self, K, S, tau):
        """(…, 2) network input from strike / spot / expiry. Elementwise-safe
        for jnp arrays (used inside the local-vol scan)."""
        m = jnp.log(jnp.maximum(K, 1e-8) / jnp.maximum(S, 1e-8))
        m_norm, tau_norm = self.transform(m, tau)
        m_norm, tau_norm = jnp.broadcast_arrays(m_norm, tau_norm)
        return jnp.stack([m_norm, tau_norm], axis=-1)

    def to_dict(self) -> dict:
        return {"m_mean": self.m_mean, "m_scale": self.m_scale,
                "tau_mean": self.tau_mean, "tau_scale": self.tau_scale,
                "S0": self.S0}

    @classmethod
    def from_dict(cls, d: dict) -> "SurfaceScaler":
        return cls(**{k: float(v) for k, v in d.items()})
