"""Dynamics layer (reference L4, SURVEY.md §1): path simulators for GBM, Heston
(full-truncation Euler), and NN-learned local volatility.

All simulators share the same contract:

    simulate_X(key, S0, ..., cfg: MCConfig, return_paths: bool)
      -> S_paths (n_steps+1, n_paths)  when return_paths
      -> S_T     (n_paths,)            otherwise (terminal-only; no path matrix)

RNG is block-structured: paths are organized into blocks of ``cfg.path_block``
and block ``b`` uses ``fold_in(key, b)`` — so prices are invariant to chunking
and sharding (core/rng.py). Antithetic pairing lives *inside* a block (first
half +Z, second half -Z), mirroring the reference's Z || -Z concatenation
(options_model_3/options_model_3.py:223-226) without odd-tail special cases.

The XLA `scan`+`vmap` implementations here are the semantic reference; the
fused GPU kernel in ops/triton_heston.py draws the same stream for the Heston
Euler terminal sampler.
"""

from options_model_tpu.models.gbm import simulate_gbm, gbm_terminal_exact
from options_model_tpu.models.heston import simulate_heston
from options_model_tpu.models.merton import merton_price, simulate_merton
from options_model_tpu.models.vg import simulate_vg, vg_terminal_exact
from options_model_tpu.models.bates import simulate_bates
from options_model_tpu.models.localvol import simulate_local_vol
from options_model_tpu.models.sabr import (
    calibrate_sabr,
    hagan_lognormal_iv,
    sabr_bs_price,
    sabr_european_mc,
    simulate_sabr,
)
from options_model_tpu.models.rbergomi import (
    rbergomi_european_mc,
    rbergomi_exact_chol,
    simulate_rbergomi,
)
from options_model_tpu.models.multiasset import (
    correlation_cholesky,
    gbm_basket_terminal_exact,
    simulate_gbm_basket,
)
from options_model_tpu.models.blocks import num_blocks, paths_rounded

__all__ = [
    "simulate_gbm",
    "gbm_terminal_exact",
    "simulate_heston",
    "simulate_merton",
    "merton_price",
    "simulate_vg",
    "vg_terminal_exact",
    "simulate_bates",
    "simulate_local_vol",
    "simulate_sabr",
    "simulate_rbergomi",
    "rbergomi_european_mc",
    "rbergomi_exact_chol",
    "sabr_european_mc",
    "sabr_bs_price",
    "hagan_lognormal_iv",
    "calibrate_sabr",
    "simulate_gbm_basket",
    "gbm_basket_terminal_exact",
    "correlation_cholesky",
    "num_blocks",
    "paths_rounded",
]
