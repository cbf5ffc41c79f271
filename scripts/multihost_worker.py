"""One process of a multi-host (DCN) pricing run — the process-level analogue
of the reference's ProcessPoolExecutor fan-out (options_model_3/
options_model_3.py:1053-1056), rebuilt as a jax.distributed single-controller-
per-host program (SURVEY.md §2.2 comm-backend row).

Each process owns its local devices; meshes span ALL processes' devices and
the psum collectives ride DCN between hosts (ICI within). Because every
stream is keyed by GLOBAL block/tile/task ids (core/rng.py), the
process-spanning run reproduces the single-process prices on the same totals
— asserted by tests/test_multihost.py, which launches two of these workers
on localhost with gloo-backed CPU collectives.

Run (one line per process):
    python scripts/multihost_worker.py --coordinator localhost:PORT \
        --num-processes 2 --process-id {0,1} [--local-devices 2]

Prints one JSON line per process: prices from the global mesh plus the
process/device topology.
"""

import argparse
import json
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True,
                    help="host:port of process 0's coordinator service")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=2,
                    help="virtual CPU devices per process (test topology); "
                         "0 = use the platform's real devices (GPUs)")
    ap.add_argument("--backend", default="cpu", choices=["cpu", "native"],
                    help="cpu = hermetic gloo-backed virtual mesh (tests); "
                         "native = whatever the machine exposes (GPUs)")
    args = ap.parse_args()

    import jax
    if args.backend == "cpu":
        # Must run before first device use (tests/conftest.py rule).
        jax.config.update("jax_platforms", "cpu")
        if args.local_devices:
            jax.config.update("jax_num_cpu_devices", args.local_devices)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from options_model_tpu.parallel.mesh import (init_multihost, make_mesh,
                                                 process_info)
    init_multihost(coordinator_address=args.coordinator,
                   num_processes=args.num_processes,
                   process_id=args.process_id)

    import numpy as np
    from options_model_tpu.core.config import PUT, MCConfig, OptionSpec
    from options_model_tpu.parallel.batch import (
        price_american_sharded_paths, price_european_sharded)

    pidx, pcount = process_info()
    n_dev = jax.device_count()
    mesh = make_mesh(("paths",))          # spans every process's devices

    key = jax.random.key(7)
    S0, K, T = 100.0, 100.0, 0.5
    spec = OptionSpec(strike=K, rate=0.05, cp=PUT, sigma=0.2)

    cfg_e = MCConfig(n_paths=n_dev * 2048, n_steps=16, path_block=1024)
    mean, se, n = price_european_sharded(key, S0, T, spec, cfg_e, mesh)

    cfg_a = MCConfig(n_paths=n_dev * 2048, n_steps=20, path_block=1024)
    p_am, se_am = price_american_sharded_paths(key, S0, T, spec, cfg_a, mesh)

    print(json.dumps({
        "process_index": pidx,
        "process_count": pcount,
        "local_devices": jax.local_device_count(),
        "global_devices": n_dev,
        "european_price": float(mean),
        "european_stderr": float(se),
        "european_n": float(n),
        "american_price": float(p_am),
        "american_stderr": float(se_am),
    }))
    sys.stdout.flush()


if __name__ == "__main__":
    main()
