"""Engine selection and the persistent compilation cache.

Every simulator runs as XLA code (models/). The ``triton`` engine routes one
sampler, the Heston/Bates full-truncation Euler terminal sampler, through the
fused GPU kernel of ops/triton_heston.py, which draws the XLA engine's own
normals; every other sampler and every full-path simulation stays XLA under
either engine. ``auto`` picks ``triton`` on a GPU backend and ``xla``
elsewhere.
"""

from __future__ import annotations

import os
import pathlib

import jax

ENGINES = ("auto", "xla", "triton")

# Fixed in-checkout cache directory (listed in .gitignore), used when
# JAX_COMPILATION_CACHE_DIR is unset.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def resolve_engine(engine: str) -> str:
    """'auto' -> 'triton' on a GPU backend, else 'xla'."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if engine == "auto":
        return "triton" if jax.default_backend() == "gpu" else "xla"
    return engine


def enable_compilation_cache(cache_dir: str | None = None,
                             min_compile_time_secs: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps the cache there and
    this sets no other directory. Otherwise the cache goes to ``cache_dir``,
    by default the fixed ``.jax_cache`` directory of the checkout. Call once at
    app start-up (the CLIs, bench.py and chip_smoke.py do); safe to repeat.
    """
    cache_dir = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
                 or str(cache_dir or DEFAULT_CACHE_DIR))
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_time_secs)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
