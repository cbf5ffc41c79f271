"""Device-count invariance of the path-sharded pricers.

Every simulator keys its threefry stream by GLOBAL block index, and each
device of a ("paths",) mesh simulates its own global block range
(first_block = rank * blocks_per_device). So a sharded pricing sees exactly
the paths an unsharded one does, and its result may differ only by the float
reduction order of the psum'ed statistics (Welford partials, regression
Grams), which can flip a few boundary exercise decisions. Each case runs the
same total paths on several device counts and compares.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.core.config import (
    PUT, BatesParams, HestonParams, MCConfig, OptionSpec)
from options_model_tpu.parallel import (
    make_mesh,
    price_american_bracket_sharded,
    price_american_sharded_paths,
    price_european_sharded,
)
from options_model_tpu.parallel.batch import (
    _path_shard_geometry,
    price_american_grid_2d,
)
from options_model_tpu.pricers.american import lsm_poly_backward, simulate_paths
from options_model_tpu.pricers.european import (make_terminal_sampler,
                                                price_european_mc)

S0, K, T, R, SIG = 100.0, 100.0, 0.5, 0.05, 0.2
HP = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
BP = BatesParams(heston=HP, lam=0.3, mu_j=-0.1, sigma_j=0.15)
FAMILY_KW = {"gbm": {}, "heston": {"heston": HP}, "bates": {"bates": BP}}


def _spec(model):
    return OptionSpec(strike=K, rate=R, cp=PUT,
                      sigma=SIG if model == "gbm" else None)


class TestGeometry:
    def test_single_block_granularity(self):
        mc = MCConfig(n_paths=8 * 1024, path_block=1024)
        assert _path_shard_geometry(mc, 8) == (8, 1)

    def test_pads_to_whole_blocks_per_device(self):
        mc = MCConfig(n_paths=5 * 1024, path_block=1024)
        nb, per = _path_shard_geometry(mc, 4)
        assert (nb, per) == (8, 2)


class TestShardedAmericanInvariance:
    @pytest.mark.parametrize("model", ["gbm", "heston", "bates"])
    def test_device_count_invariance(self, key, devices8, model):
        cfg = MCConfig(n_paths=8 * 1024, n_steps=8, path_block=1024)
        spec = _spec(model)
        out = {}
        for ndev in (8, 2):
            mesh = make_mesh(("paths",), devices=devices8[:ndev])
            p, se = price_american_sharded_paths(key, S0, T, spec, cfg, mesh,
                                                 model=model,
                                                 **FAMILY_KW[model])
            out[ndev] = (float(p), float(se))
        want_v = model != "gbm"
        sim = simulate_paths(key, S0, T, cfg, model, sigma=spec.sigma,
                             rate=R, return_variance=want_v,
                             **FAMILY_KW[model])
        S_paths, v_paths = sim if want_v else (sim, None)
        p_u, _ = lsm_poly_backward(S_paths, spec, T, v_paths=v_paths)
        # psum order can flip O(1) boundary exercise decisions
        # (tests/test_parallel.py: rel 9e-4 at 8k paths)
        np.testing.assert_allclose(out[8][0], out[2][0], rtol=2e-3)
        np.testing.assert_allclose(out[8][0], float(p_u), rtol=2e-3)
        np.testing.assert_allclose(out[8][1], out[2][1], rtol=2e-2)

    def test_price_sane_vs_crr(self, key, devices8):
        from options_model_tpu.pricers import crr_american
        cfg = MCConfig(n_paths=8 * 4096, n_steps=50, path_block=4096)
        mesh = make_mesh(("paths",), devices=devices8)
        p, _ = price_american_sharded_paths(key, S0, T, _spec("gbm"), cfg,
                                            mesh)
        oracle = crr_american(S0, K, T, R, SIG, cp=-1.0, n_steps=2048)
        assert abs(float(p) - oracle) / oracle < 0.02


class TestEuropeanShardedInvariance:
    @pytest.mark.parametrize("model", ["gbm", "heston", "bates"])
    def test_device_count_invariance(self, key, devices8, model):
        cfg = MCConfig(n_paths=8 * 2048, n_steps=8, path_block=1024)
        spec = _spec(model)
        vals = []
        for ndev in (8, 2):
            mesh = make_mesh(("paths",), devices=devices8[:ndev])
            m, se, n = price_european_sharded(key, S0, T, spec, cfg, mesh,
                                              model=model, **FAMILY_KW[model])
            vals.append((float(m), float(se), float(n)))
        sampler = make_terminal_sampler(model, S0, R, T, sigma=spec.sigma,
                                        engine="xla", **FAMILY_KW[model])
        m_u, se_u, n_u = price_european_mc(key, sampler, spec, T, cfg)
        for m, se, n in vals:
            np.testing.assert_allclose(m, float(m_u), rtol=1e-5)
            np.testing.assert_allclose(se, float(se_u), rtol=1e-4)
            assert n == float(n_u)

    def test_price_converges_to_bs(self, key, devices8):
        from options_model_tpu.pricers import bs_price
        cfg = MCConfig(n_paths=8 * 16384, n_steps=8, path_block=4096)
        mesh = make_mesh(("paths",), devices=devices8)
        m, se, _ = price_european_sharded(key, S0, T, _spec("gbm"), cfg, mesh)
        ref = float(bs_price(S0, K, T, R, SIG, PUT))
        assert abs(float(m) - ref) < 4 * float(se) + 1e-3


class TestGrid2DInvariance:
    @pytest.mark.parametrize("model", ["gbm", "heston", "bates"])
    def test_mesh_factorization_invariance(self, key, devices8, model):
        S0s = jnp.array([90.0, 100.0, 110.0, 100.0])
        Ks = jnp.full((4,), K)
        Ts = jnp.full((4,), T)
        cfg = MCConfig(n_paths=8 * 1024, n_steps=8, path_block=1024)
        kw = dict(FAMILY_KW[model], model=model)
        if model == "gbm":
            kw["sigma"] = SIG
        out = {}
        for shape in ((1, 8), (2, 4), (4, 2)):
            mesh = make_mesh(("tasks", "paths"), shape=shape,
                             devices=devices8)
            out[shape] = np.asarray(price_american_grid_2d(
                key, S0s, Ks, Ts, R, cfg, mesh, **kw))
        np.testing.assert_allclose(out[(1, 8)], out[(2, 4)], rtol=2e-3)
        np.testing.assert_allclose(out[(1, 8)], out[(4, 2)], rtol=2e-3)


class TestBracketShardedInvariance:
    @pytest.mark.parametrize("model", ["gbm", "heston"])
    def test_device_count_invariance(self, key, devices8, model):
        cfg = MCConfig(n_paths=8 * 1024, n_steps=8, path_block=1024)
        brs = []
        for ndev in (8, 2):
            mesh = make_mesh(("paths",), devices=devices8[:ndev])
            brs.append(price_american_bracket_sharded(
                key, S0, T, _spec(model), cfg, mesh, model=model,
                heston=HP if model == "heston" else None, n_inner=8))
        np.testing.assert_allclose(float(brs[0].low), float(brs[1].low),
                                   rtol=2e-3)
        np.testing.assert_allclose(float(brs[0].high), float(brs[1].high),
                                   rtol=2e-3)
        b = brs[0]
        assert float(b.low) <= float(b.high) + 3 * float(b.low_stderr
                                                          + b.high_stderr)

    def test_oos_split_on_odd_blocks_per_device(self, key, devices8):
        # 3 blocks per device: the OOS parity must follow the GLOBAL block
        # index, not the local one.
        cfg = MCConfig(n_paths=6 * 1024, n_steps=8, path_block=1024)
        lows = []
        for ndev in (2, 1):
            mesh = make_mesh(("paths",), devices=devices8[:ndev])
            br = price_american_bracket_sharded(key, S0, T, _spec("gbm"), cfg,
                                                mesh, n_inner=8)
            lows.append(float(br.low))
        np.testing.assert_allclose(lows[0], lows[1], rtol=2e-3)
