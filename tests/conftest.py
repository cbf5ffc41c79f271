"""Test environment: a virtual 8-device CPU mesh, and the ``gpu`` marker.

The CPU backend is sized to 8 devices before JAX initialises it, so the
multi-device tests run on a virtual mesh (SURVEY.md §4); the suite runs on
it under JAX_PLATFORMS=cpu. Tests marked ``gpu`` skip unless JAX's default
device is a GPU; on the card, ``pytest -m gpu`` runs them.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)
# Hermeticity: the CLI tests call enable_compilation_cache(), which would
# otherwise point the whole pytest process at an on-disk cache.
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests when the default device is not a GPU."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU: run `pytest -m gpu` on the card")


@pytest.fixture(scope="module", autouse=True)
def _bound_jit_memory_maps():
    """Keep the process under vm.max_map_count (default 65530).

    Every compiled XLA executable holds several anonymous mappings (JIT code
    + guard pages); the full suite compiles thousands of distinct programs
    and crosses the kernel limit near the end, at which point LLVM's JIT
    segfaults on the next big compile (observed: deterministic SIGSEGV in
    backend_compile_and_load at ~50k maps while compiling the surface
    program; isolated runs of the same test pass). Dropping compiled-program
    caches between modules releases the maps (verified: 300 jits 1364 maps
    -> 470 after clear_caches). Threshold-gated so cheap modules keep their
    warm caches."""
    yield
    try:
        with open("/proc/self/maps") as fh:
            n = sum(1 for _ in fh)
    except OSError:  # non-Linux: no limit to manage
        return
    if n > 25_000:
        jax.clear_caches()


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices()
    assert len(devs) >= 8, f"expected 8 virtual devices, got {len(devs)}"
    return devs[:8]


@pytest.fixture
def key():
    return jax.random.key(42)
