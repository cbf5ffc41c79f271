"""What lets the library run where only jax, numpy, scipy and optax exist:
imports without flax/pandas/orbax, the plain-JAX nets, the frozen-dataclass
pytrees, and chip_smoke.py's refusal to run without a GPU."""

import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.core.config import (
    HestonParams, LSMConfig, MCConfig, SurfaceTrainConfig)
from options_model_tpu.core.stats import WelfordState
from options_model_tpu.pricers.regressors import ContinuationMLP
from options_model_tpu.surface.network import IVNetwork, init_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ["core", "models", "ops", "pricers", "parallel", "calibration",
            "surface"]

_IMPORT_PROBE = r"""
import importlib, importlib.abc, json, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("flax", "pandas", "orbax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
out = {}
for pkg in sys.argv[1:]:
    try:
        if pkg == "__graft_entry__":
            import __graft_entry__
            fn, args = __graft_entry__.entry()
            fn(*args)
        else:
            importlib.import_module("options_model_tpu." + pkg)
        out[pkg] = "ok"
    except Exception as e:
        out[pkg] = f"{type(e).__name__}: {e}"
print(json.dumps(out))
"""


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def blocked_imports():
    r = subprocess.run(
        [sys.executable, "-c", _IMPORT_PROBE, *PACKAGES, "__graft_entry__"],
        cwd=ROOT, env=_cpu_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("pkg", PACKAGES + ["__graft_entry__"])
def test_imports_without_flax_pandas_orbax(blocked_imports, pkg):
    assert blocked_imports[pkg] == "ok", blocked_imports[pkg]


class TestContinuationMLP:
    def test_param_shapes_and_initialisers(self):
        net = ContinuationMLP(hidden=64, num_layers=3, dropout=0.1)
        p = net.init(jax.random.key(0), jnp.zeros((1, 7)))["params"]
        assert sorted(p) == ["Dense_0", "Dense_1", "Dense_2", "Dense_3"]
        shapes = [p[f"Dense_{i}"]["kernel"].shape for i in range(4)]
        assert shapes == [(7, 64), (64, 64), (64, 64), (64, 1)]
        for i in range(4):
            assert not np.any(np.asarray(p[f"Dense_{i}"]["bias"]))
        # lecun normal: std sqrt(1 / fan_in)
        std = float(jnp.std(p["Dense_1"]["kernel"]))
        assert abs(std * np.sqrt(64) - 1.0) < 0.1

    def test_dropout_determinism(self):
        net = ContinuationMLP(hidden=32, num_layers=2, dropout=0.5)
        x = jax.random.normal(jax.random.key(1), (16, 7))
        params = net.init(jax.random.key(0), x)
        det = net.apply(params, x)
        np.testing.assert_array_equal(
            np.asarray(det), np.asarray(net.apply(params, x, True,
                                                  {"dropout": jax.random.key(9)})))
        a = net.apply(params, x, False, {"dropout": jax.random.key(2)})
        b = net.apply(params, x, False, {"dropout": jax.random.key(2)})
        c = net.apply(params, x, False, {"dropout": jax.random.key(3)})
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert not np.allclose(np.asarray(a), np.asarray(c))
        assert a.shape == det.shape == (16, 1)
        with pytest.raises(ValueError):
            net.apply(params, x, deterministic=False)


class TestIVNetwork:
    def test_param_shapes_and_initialisers(self):
        net = IVNetwork(hidden_dim=16, num_hidden_layers=2)
        p = net.init(jax.random.key(0), jnp.zeros((1, 2)))["params"]
        assert sorted(p) == ["Dense_0", "Dense_1", "Dense_2", "LayerNorm_0",
                             "LayerNorm_1", "head"]
        assert p["Dense_0"]["kernel"].shape == (2, 16)
        assert p["Dense_2"]["kernel"].shape == (16, 16)
        assert p["head"]["kernel"].shape == (16, 1)
        np.testing.assert_array_equal(np.asarray(p["LayerNorm_1"]["scale"]),
                                      np.ones(16))
        assert not np.any(np.asarray(p["LayerNorm_0"]["bias"]))

    def test_init_params_start_at_target_mean(self):
        cfg = SurfaceTrainConfig(hidden_dim=8, num_hidden_layers=1)
        params = init_params(cfg, jax.random.key(0), 0.23)
        x = jax.random.normal(jax.random.key(1), (5, 2))
        out = IVNetwork(hidden_dim=8, num_hidden_layers=1).apply(params, x)
        np.testing.assert_allclose(np.asarray(out), 0.23, rtol=1e-6)

    def test_dropout_determinism(self):
        net = IVNetwork(hidden_dim=16, num_hidden_layers=2, dropout=0.3)
        x = jax.random.normal(jax.random.key(1), (8, 2))
        params = net.init(jax.random.key(0), x)
        a = net.apply(params, x, False, {"dropout": jax.random.key(4)})
        b = net.apply(params, x, False, {"dropout": jax.random.key(4)})
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert not np.allclose(np.asarray(a), np.asarray(net.apply(params, x)))


class TestPytreeDataclasses:
    def test_replace_returns_a_modified_copy(self):
        mc = MCConfig(n_paths=1024)
        mc2 = mc.replace(n_steps=7)
        assert (mc.n_steps, mc2.n_steps, mc2.n_paths) == (50, 7, 1024)
        with pytest.raises(dataclasses.FrozenInstanceError):
            mc.n_paths = 1

    def test_hash_and_equality_by_value(self):
        a, b = LSMConfig(poly_degree=5), LSMConfig(poly_degree=5)
        assert a == b and hash(a) == hash(b)
        assert a != a.replace(poly_degree=4)
        f = jax.jit(lambda x, cfg: x * cfg.n_steps, static_argnums=1)
        assert float(f(2.0, MCConfig(n_steps=3))) == 6.0

    def test_static_fields_live_in_the_treedef(self):
        leaves = jax.tree_util.tree_leaves(LSMConfig())
        assert "poly" not in leaves and len(leaves) == 8
        assert (jax.tree_util.tree_structure(LSMConfig(poly_degree=3))
                != jax.tree_util.tree_structure(LSMConfig(poly_degree=4)))
        hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
        doubled = jax.tree_util.tree_map(lambda v: 2 * v, hp)
        assert isinstance(doubled, HestonParams) and doubled.kappa == 4.0
        st = jax.jit(lambda s: s.replace(count=s.count + 1))(
            WelfordState(count=jnp.float32(1), mean=jnp.float32(0),
                         m2=jnp.float32(0)))
        assert float(st.count) == 2.0


class TestChipSmokeRefusesCpu:
    def test_exits_nonzero_without_gpu(self):
        r = subprocess.run([sys.executable, "chip_smoke.py", "--phase",
                            "parity"], cwd=ROOT, env=_cpu_env(),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert "no GPU" in r.stderr

    def test_exits_nonzero_outside_the_repo(self, tmp_path):
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=dict(_cpu_env(), PYTHONPATH=""),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
