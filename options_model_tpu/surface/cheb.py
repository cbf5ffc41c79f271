"""Chebyshev slice compilation of an IV surface for the local-vol simulator.

The XLA local-vol simulator can run the surface MLP inside the scan (exact,
but each step is a batch of small matmuls). Instead we compile the surface
into per-step 1-D Chebyshev polynomials:

    sigma_t(m) ~= sum_k c[t, k] T_k((m - center) / half)

with m = log(K / S), which the simulator gets from its carried log S.
Evaluating a degree-7 polynomial is ~8 FMAs per path-step. Smooth IV surfaces
are captured to ~1e-4 vol by degree 7 over the +-4-sigma moneyness range
(tested in tests/test_pallas_localvol.py).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
from options_model_tpu.core.pytree import pytree_dataclass
import jax.numpy as jnp


@pytree_dataclass
class LocalVolTable:
    """Per-step Chebyshev slices of sigma(m, tau_t). Pytree — jit-safe."""

    coeffs: jnp.ndarray    # (n_steps, degree+1)
    m_center: float
    m_half: float
    K: float               # strike defining m = log(K / S)

    @property
    def degree(self) -> int:
        return self.coeffs.shape[1] - 1


def compile_localvol_table(sigma_fn: Callable, K: float, T: float,
                           n_steps: int, S0: float, *, degree: int = 7,
                           m_width_sigmas: float = 4.5,
                           ref_vol: float = 0.25,
                           S0_range=None) -> LocalVolTable:
    """Fit per-step Chebyshev slices of ``sigma_fn`` (the surface adapter from
    IVSurfaceModel.sigma_fn).

    The m-range covers +- m_width_sigmas * ref_vol * sqrt(T) of log-moneyness
    around log(K/S0) — paths outside evaluate the clamped edge polynomial
    value, matching the surface network's own flat extrapolation tendency.

    ``S0_range=(S0_min, S0_max)``: widen the fitted range so ONE table serves
    a whole spot grid (the curve sweep's S0 axis) — the range covers every
    starting moneyness in the grid plus the diffusion spread.
    """
    dt = T / n_steps
    spread = m_width_sigmas * ref_vol * np.sqrt(T)
    if S0_range is not None:
        m_lo = float(np.log(K / max(S0_range)))   # highest spot -> lowest m
        m_hi = float(np.log(K / min(S0_range)))
        m_center = 0.5 * (m_lo + m_hi)
        m_half = float(max(0.5 * (m_hi - m_lo) + spread, 0.05))
    else:
        m_center = float(np.log(K / S0))
        m_half = float(max(spread, 0.05))

    # Chebyshev nodes in u in [-1, 1]
    n_nodes = 4 * (degree + 1)
    u = np.cos(np.pi * (np.arange(n_nodes) + 0.5) / n_nodes)
    m = m_center + m_half * u
    S = K * np.exp(-m)  # from m = log(K/S)

    coeffs = np.zeros((n_steps, degree + 1), np.float32)
    for t in range(n_steps):
        tau_t = max(T - t * dt, 1e-6)
        sig = np.asarray(sigma_fn(jnp.asarray(S, jnp.float32),
                                  jnp.float32(tau_t)), np.float64)
        coeffs[t] = np.polynomial.chebyshev.chebfit(u, sig, degree).astype(np.float32)

    return LocalVolTable(coeffs=jnp.asarray(coeffs), m_center=m_center,
                         m_half=m_half, K=float(K))


def eval_table(table: LocalVolTable, S, t):
    """Reference (XLA) evaluation of a slice (t may be traced) — used for
    kernel parity tests and as the XLA fallback sigma_fn (table_sigma_fn)."""
    u = jnp.clip((jnp.log(table.K / S) - table.m_center) / table.m_half, -1.0, 1.0)
    c = table.coeffs[t]
    # Clenshaw recurrence
    b1 = jnp.zeros_like(u)
    b2 = jnp.zeros_like(u)
    for k in range(table.coeffs.shape[1] - 1, 0, -1):
        b1, b2 = c[k] + 2.0 * u * b1 - b2, b1
    return jnp.maximum(c[0] + u * b1 - b2, 1e-6)


def table_sigma_fn(table: LocalVolTable, T: float):
    """sigma(S, tau) adapter over the compiled table for the XLA local-vol
    simulator — a table-built sampler works identically on every backend.
    tau maps back to the step index the table
    was compiled on: tau_t = T - t*dt  =>  t = round((T - tau) * n_steps / T).
    """
    import jax.numpy as jnp

    n_steps = table.coeffs.shape[0]

    def fn(S, tau):
        t = jnp.clip(jnp.round((T - tau) * n_steps / T).astype(jnp.int32),
                     0, n_steps - 1)
        return eval_table(table, S, t)

    return fn
