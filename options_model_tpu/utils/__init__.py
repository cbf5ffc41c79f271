"""Utilities: logging, profiling/timing, plotting (import-gated)."""

from options_model_tpu.utils.logging import get_logger, setup_logging
from options_model_tpu.utils.profiling import (
    Timer,
    device_memory_stats,
    estimate_total_runtime,
)

__all__ = [
    "get_logger",
    "setup_logging",
    "Timer",
    "device_memory_stats",
    "estimate_total_runtime",
]
