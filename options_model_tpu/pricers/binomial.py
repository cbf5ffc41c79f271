"""Cox-Ross-Rubinstein binomial tree — the accuracy oracle.

The reference has no binomial pricer; BASELINE.json makes CRR the accuracy
ground truth ("American put within 0.1% of CRR binomial"). Two implementations
with identical semantics:

- ``crr_american`` / ``crr_price``: NumPy float64 backward induction (host-side
  oracle for tests; a tree is inherently sequential/triangular — host work).
- a native C++ version (native/crr.cpp, loaded via ctypes) used automatically
  when built, ~20x faster for large trees.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def _native_lib() -> Optional[ctypes.CDLL]:
    """Load the C++ CRR kernel if the shared object has been built."""
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    so = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native", "libcrr.so")
    if os.path.exists(so):
        try:
            lib = ctypes.CDLL(so)
            lib.crr_price.restype = ctypes.c_double
            lib.crr_price.argtypes = [
                ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            if hasattr(lib, "crr_price_q"):  # dividend-yield entry (r2+)
                lib.crr_price_q.restype = ctypes.c_double
                lib.crr_price_q.argtypes = [
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.c_double, ctypes.c_double, ctypes.c_double,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ]
            _LIB = lib
        except OSError:
            _LIB = None
    return _LIB


def crr_price(S0: float, K: float, T: float, r: float, sigma: float,
              cp: float = 1.0, n_steps: int = 2048, american: bool = True,
              use_native: bool = True, q: float = 0.0) -> float:
    """CRR binomial price. cp=+1 call / -1 put; american=False gives the
    European tree (useful to sanity-check convergence to Black-Scholes);
    ``q`` is the continuous dividend yield (growth r-q, discount r)."""
    lib = _native_lib() if use_native else None
    # A pre-r2 libcrr.so lacks the q entry point; only q=0 may route to it.
    if lib is not None and q != 0.0 and not hasattr(lib, "crr_price_q"):
        lib = None
    if lib is not None:
        fn = ((lambda: lib.crr_price_q(S0, K, T, r, q, sigma,
                                       int(1 if cp > 0 else -1),
                                       int(n_steps), int(1 if american else 0)))
              if hasattr(lib, "crr_price_q") else
              (lambda: lib.crr_price(S0, K, T, r, sigma,
                                     int(1 if cp > 0 else -1),
                                     int(n_steps), int(1 if american else 0))))
        out = float(fn())
        if np.isnan(out):
            raise ValueError("CRR risk-neutral prob outside (0,1); reduce dt")
        return out

    dt = T / n_steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-r * dt)
    p = (np.exp((r - q) * dt) - d) / (u - d)
    if not (0.0 < p < 1.0):
        raise ValueError(f"CRR risk-neutral prob p={p} outside (0,1); reduce dt")

    j = np.arange(n_steps + 1, dtype=np.float64)
    S_T = S0 * u ** (2.0 * j - n_steps)
    value = np.maximum(cp * (S_T - K), 0.0)

    for step in range(n_steps - 1, -1, -1):
        value = disc * (p * value[1:] + (1.0 - p) * value[:-1])
        if american:
            S_t = S0 * u ** (2.0 * j[: step + 1] - step)
            value = np.maximum(value, cp * (S_t - K))

    return float(value[0])


def crr_american(S0, K, T, r, sigma, cp=1.0, n_steps: int = 2048,
                 q: float = 0.0) -> float:
    return crr_price(S0, K, T, r, sigma, cp, n_steps, american=True, q=q)
