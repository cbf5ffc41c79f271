"""Synthetic Heston surfaces with known true parameters — the calibration test
oracle (create_synthetic_heston_data, heston_calibration.py:730-774), upgraded
to the intended behavior: implied vols come from exact COS prices inverted
through the IV solver, not the reference's ATM-vol + smile-effect approximation
(:751-756) which never actually reflected the input parameters.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from contextlib import nullcontext as _nullcontext

from options_model_tpu.core.config import (BatesParams, HestonParams,
                                           VGParams)
from options_model_tpu.calibration.charfn import (bates_cos_price,
                                                  heston_cos_price,
                                                  vg_cos_price)
from options_model_tpu.pricers.blackscholes import implied_vol
from options_model_tpu.utils.logging import get_logger

_log = get_logger("options_model_tpu.calibration.synthetic")


def create_synthetic_heston_surface(
    params: HestonParams,
    S0: float = 100.0,
    rate: float = 0.05,
    strikes: Optional[np.ndarray] = None,
    expiries_days=(30, 60, 90, 180),
    noise_std: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (strikes, expiries, ivs) flattened over the grid.

    ``dtype``: working precision of the COS->IV oracle chain. The float32
    default carries the chain's ~1e-4 IV rounding — calibrating against it
    bottoms out at the DATA's floor (~1e-3 weighted RMSE) no matter how good
    the objective is. np.float64 (requires explicit-x64 dtypes; the f64
    calibration objective enables them) produces data clean to <1e-7, which
    is what lets round trips demonstrate the f64 objective's true floor
    (bench.py's calibration leg uses it).
    """
    import jax

    if strikes is None:
        strikes = np.linspace(80.0, 120.0, 15)
    expiries = np.asarray(expiries_days, np.float64) / 365.0
    K, T = np.meshgrid(strikes, expiries)
    K, T = K.reshape(-1), T.reshape(-1)

    from options_model_tpu.calibration.calibrator import (
        _explicit_x64_scope, _try_enable_explicit_x64)
    want_f64 = np.dtype(dtype) == np.float64
    if want_f64 and not _try_enable_explicit_x64():
        # Never silently: a caller asking for the f64 oracle and getting f32
        # data would report round-trip RMSEs that measure the DATA's ~1e-4
        # IV rounding floor while claiming the f64 floor (<1e-7).
        _log.warning(
            "synthetic Heston oracle: float64 requested but explicit-x64 "
            "dtypes are unavailable — degrading to float32 (results carry "
            "the f32 chain's ~1e-4 IV rounding)")
        want_f64 = False
    jdt = jnp.float64 if want_f64 else jnp.float32

    # Pin the oracle to the CPU backend: the accelerator's f32/complex64 COS
    # chain adds ~1e-4 IV noise, enough to shift the weakly-identified kappa
    # in round-trip calibration tests, and the calibrator evaluates its f64
    # objective on the CPU device too.
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError:
        cpu = None
    pricer = (bates_cos_price if isinstance(params, BatesParams)
              else vg_cos_price if isinstance(params, VGParams)
              else heston_cos_price)
    # VG short-dated points need a long COS series (polynomial char-fn
    # decay; see calibrator._make_objective's n_terms note).
    n_terms = 4096 if isinstance(params, VGParams) else 256
    ctx = jax.default_device(cpu) if cpu is not None else _nullcontext()
    x64ctx = _explicit_x64_scope() if want_f64 else _nullcontext()
    with x64ctx, ctx:
        prices = pricer(S0, jnp.asarray(K, jdt),
                        jnp.asarray(T, jdt), rate, params,
                        cp=1.0, n_terms=n_terms, dtype=jdt)
        ivs = np.asarray(implied_vol(prices, S0, jnp.asarray(K, jdt),
                                     jnp.asarray(T, jdt), rate, cp=1.0),
                         np.float64)

    if noise_std > 0:
        rng = np.random.default_rng(seed)
        ivs = ivs + rng.normal(0.0, noise_std, ivs.shape)

    ivs = np.clip(ivs, 0.011, 1.99)
    return K, T, ivs


def create_synthetic_bates_surface(
    params: BatesParams,
    S0: float = 100.0,
    rate: float = 0.05,
    strikes: Optional[np.ndarray] = None,
    expiries_days=(7, 30, 90, 180, 365),
    noise_std: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Bates oracle surface (same COS->IV chain; bates_cos_price). The default
    expiry ladder reaches down to one WEEK: the jump triple is identified by
    short-dated smiles (diffusion smiles flatten like sqrt(T) there; jump
    smiles don't — see calibrator._JUMP_BOUNDS)."""
    return create_synthetic_heston_surface(
        params, S0=S0, rate=rate, strikes=strikes,
        expiries_days=expiries_days, noise_std=noise_std, seed=seed,
        dtype=dtype)


def create_synthetic_vg_surface(
    params: VGParams,
    S0: float = 100.0,
    rate: float = 0.05,
    strikes: Optional[np.ndarray] = None,
    expiries_days=(7, 30, 90, 180, 365, 730),
    noise_std: float = 0.0,
    seed: int = 0,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Variance Gamma oracle surface (vg_cos_price -> IV). The expiry ladder
    spans a week to two years: VG excess kurtosis decays like nu/T, so the
    TERM STRUCTURE of the smile identifies nu while the short-dated skew
    pins theta."""
    return create_synthetic_heston_surface(
        params, S0=S0, rate=rate, strikes=strikes,
        expiries_days=expiries_days, noise_std=noise_std, seed=seed,
        dtype=dtype)
