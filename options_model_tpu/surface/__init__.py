"""Implied-volatility surface modeling (reference component #12,
NN_training_stock_iv.py): a residual MLP over (log-moneyness, tau) with
vega-weighted loss, finite-difference no-arbitrage penalties, MC-dropout
uncertainty, early stopping, and orbax checkpointing with a real restore path
(the reference wrote checkpoints but never read them — SURVEY.md §5).
"""

from options_model_tpu.surface.scaler import SurfaceScaler
from options_model_tpu.surface.network import IVNetwork
from options_model_tpu.surface.loss import arbitrage_penalty_fd, vega_weights
from options_model_tpu.surface.train import SurfaceTrainResult, train_iv_surface
from options_model_tpu.surface.model import IVSurfaceModel
from options_model_tpu.surface.svi import (
    SVILocalVolEngine,
    SVISlice,
    SVISurface,
    fit_svi_from_chain,
    fit_svi_slice,
    fit_svi_surface,
    svi_butterfly_g,
    svi_total_variance,
)

__all__ = [
    "SVILocalVolEngine",
    "SVISlice",
    "SVISurface",
    "fit_svi_from_chain",
    "fit_svi_slice",
    "fit_svi_surface",
    "svi_butterfly_g",
    "svi_total_variance",
    "SurfaceScaler",
    "IVNetwork",
    "arbitrage_penalty_fd",
    "vega_weights",
    "SurfaceTrainResult",
    "train_iv_surface",
    "IVSurfaceModel",
]
