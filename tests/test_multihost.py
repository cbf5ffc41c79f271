"""Multi-host (DCN) execution: two real OS processes join one jax.distributed
runtime over localhost (gloo-backed CPU collectives) and price on the
process-spanning mesh — the comm-backend row of SURVEY.md §2.2 that the
in-process virtual mesh cannot cover.

The workers run scripts/multihost_worker.py (the same entry a multi-host launch
uses); the assertions here are

- topology: each process sees its local devices and the global device count;
- cross-process agreement: both processes compute identical global prices;
- single-process equivalence: the 2-process x 2-device mesh reproduces the
  1-process x 4-device prices on the same totals — the global-index RNG
  (core/rng.py) makes the streams identical, so the only daylight is psum
  reduction order (observed bitwise-equal; asserted at 1e-6 relative).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multihost_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(port: int, num: int, pid: int, local_devices: int):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # The workers manage their own platform config; scrub the suite's flags
    # so the subprocess starts from a clean slate.
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen(
        [sys.executable, WORKER, "--coordinator", f"localhost:{port}",
         "--num-processes", str(num), "--process-id", str(pid),
         "--local-devices", str(local_devices)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)


@pytest.mark.slow
def test_two_process_mesh_matches_single_process(key):
    port = _free_port()
    procs = [_launch(port, 2, i, 2) for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    by_pid = {o["process_index"]: o for o in outs}
    assert set(by_pid) == {0, 1}
    for o in outs:
        assert o["process_count"] == 2
        assert o["local_devices"] == 2
        assert o["global_devices"] == 4

    # both processes return the same GLOBAL result
    np.testing.assert_allclose(by_pid[0]["european_price"],
                               by_pid[1]["european_price"], rtol=0)
    np.testing.assert_allclose(by_pid[0]["american_price"],
                               by_pid[1]["american_price"], rtol=0)

    # single-process reference on the same global totals (4 virtual devices
    # of this suite's hermetic 8-device mesh)
    import jax
    from options_model_tpu.core.config import PUT, MCConfig, OptionSpec
    from options_model_tpu.parallel import make_mesh
    from options_model_tpu.parallel.batch import (
        price_american_sharded_paths, price_european_sharded)

    mesh4 = make_mesh(("paths",), devices=jax.devices()[:4])
    k7 = jax.random.key(7)
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
    cfg_e = MCConfig(n_paths=4 * 2048, n_steps=16, path_block=1024)
    mean, se, n = price_european_sharded(k7, 100.0, 0.5, spec, cfg_e, mesh4)
    np.testing.assert_allclose(by_pid[0]["european_price"], float(mean),
                               rtol=1e-6)
    np.testing.assert_allclose(by_pid[0]["european_stderr"], float(se),
                               rtol=1e-5)
    assert by_pid[0]["european_n"] == float(n)

    cfg_a = MCConfig(n_paths=4 * 2048, n_steps=20, path_block=1024)
    p_am, _ = price_american_sharded_paths(k7, 100.0, 0.5, spec, cfg_a, mesh4)
    np.testing.assert_allclose(by_pid[0]["american_price"], float(p_am),
                               rtol=1e-6)
