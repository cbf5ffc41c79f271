"""Profiling and timing harness.

Rebuilds the reference's wall-clock spans and GPU telemetry (SURVEY.md §5
"Tracing / profiling"): Timer context, the pilot-run ETA feature
(options_model_v1.5.py:349-361), device memory stats (the JAX analogue of
torch.cuda.memory_allocated, option_model_3_gpu.py:54-59) and a profiler
trace hook. Time device work with jax.block_until_ready inside the span.
"""

from __future__ import annotations

import time
from typing import Dict

import jax


class Timer:
    """Wall-clock span: ``with Timer("phase") as t: ...; t.elapsed``."""

    def __init__(self, name: str = "", log=None):
        self.name = name
        self.log = log
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.log is not None:
            self.log.info(f"{self.name}: {self.elapsed:.2f}s")
        return False


def estimate_total_runtime(pilot_seconds: float, n_pilot_tasks: int,
                           n_total_tasks: int, n_parallel: int = 1) -> float:
    """Pilot-run ETA: extrapolate one task group's wall time to the full grid
    (the reference timed one S0 curve and multiplied,
    options_model_v1.5.py:349-361)."""
    if n_pilot_tasks <= 0:
        return 0.0
    per_task = pilot_seconds / n_pilot_tasks
    return per_task * n_total_tasks / max(n_parallel, 1)


def device_memory_stats(device=None) -> Dict[str, float]:
    """Per-device memory telemetry in MB (empty dict when the backend doesn't
    expose stats — e.g. CPU)."""
    dev = device or jax.devices()[0]
    try:
        stats = dev.memory_stats()
    except Exception:
        return {}
    if not stats:
        return {}
    mb = 1024 * 1024
    return {k: v / mb for k, v in stats.items()
            if isinstance(v, (int, float)) and "bytes" in k}


def trace(path: str):
    """jax.profiler trace context for deep dives: ``with trace('/tmp/tr'): ...``"""
    return jax.profiler.trace(path)
