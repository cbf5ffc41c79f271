"""Andersen QE-M Heston scheme: weak convergence vs the COS closed form,
martingale property, scheme dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.core.config import HestonParams, MCConfig
from options_model_tpu.calibration import heston_cos_price
from options_model_tpu.models.heston import simulate_heston

HP = HestonParams(kappa=2.0, theta=0.04, xi=0.6, rho=-0.7, v0=0.04)


def _euro_call(key, scheme, steps, n_paths=2**18):
    cfg = MCConfig(n_paths=n_paths, n_steps=steps, path_block=4096)
    S_T = simulate_heston(key, 100.0, 0.05, 1.0, HP, cfg, return_paths=False,
                          scheme=scheme)
    pay = jnp.maximum(S_T - 100.0, 0.0) * np.exp(-0.05)
    return float(jnp.mean(pay)), float(jnp.std(pay)) / np.sqrt(S_T.size)


class TestQE:
    def test_coarse_qe_beats_fine_euler(self, key):
        cos = float(heston_cos_price(100.0, 100.0, 1.0, 0.05, HP, 1.0))
        p_qe, se = _euro_call(key, "qe", 8)
        p_eu, _ = _euro_call(key, "euler", 32)
        assert abs(p_qe - cos) < abs(p_eu - cos), (p_qe, p_eu, cos)
        assert abs(p_qe - cos) < max(4 * se, 0.05)

    def test_martingale(self, key):
        cfg = MCConfig(n_paths=2**18, n_steps=8, path_block=4096)
        S_T = simulate_heston(key, 100.0, 0.05, 1.0, HP, cfg,
                              return_paths=False, scheme="qe")
        expected = 100.0 * np.exp(0.05)
        # QE-M martingale correction: drift error well under 0.1%
        assert abs(float(jnp.mean(S_T)) - expected) / expected < 1e-3

    def test_variance_nonnegative_and_paths_shape(self, key):
        cfg = MCConfig(n_paths=4096, n_steps=16, path_block=1024)
        S, v = simulate_heston(key, 100.0, 0.05, 1.0, HP, cfg,
                               return_paths=True, return_variance=True,
                               scheme="qe")
        assert S.shape == (17, 4096) and v.shape == (17, 4096)
        assert float(jnp.min(v)) >= 0.0
        np.testing.assert_allclose(S[0], 100.0, rtol=1e-6)

    def test_high_xi_exponential_branch(self, key):
        # xi >> kappa*theta forces psi > 1.5 often: the mixture branch must
        # stay finite and unbiased-ish.
        hp = HestonParams(kappa=0.5, theta=0.04, xi=1.5, rho=-0.5, v0=0.04)
        cfg = MCConfig(n_paths=2**17, n_steps=16, path_block=4096)
        S_T = simulate_heston(key, 100.0, 0.05, 1.0, hp, cfg,
                              return_paths=False, scheme="qe")
        assert np.isfinite(np.asarray(S_T)).all()
        expected = 100.0 * np.exp(0.05)
        assert abs(float(jnp.mean(S_T)) - expected) / expected < 5e-3

    def test_bad_scheme_rejected(self, key):
        with pytest.raises(ValueError):
            simulate_heston(key, 100.0, 0.05, 1.0, HP, MCConfig(n_paths=1024),
                            scheme="milstein")

    def test_chunk_invariance(self, key):
        full = simulate_heston(key, 100.0, 0.05, 1.0, HP,
                               MCConfig(n_paths=4096, n_steps=8, path_block=1024),
                               return_paths=False, scheme="qe")
        c1 = simulate_heston(key, 100.0, 0.05, 1.0, HP,
                             MCConfig(n_paths=2048, n_steps=8, path_block=1024),
                             return_paths=False, scheme="qe", first_block=0)
        c2 = simulate_heston(key, 100.0, 0.05, 1.0, HP,
                             MCConfig(n_paths=2048, n_steps=8, path_block=1024),
                             return_paths=False, scheme="qe", first_block=2)
        np.testing.assert_allclose(full, jnp.concatenate([c1, c2]), rtol=1e-6)


class TestQEAmerican:
    def test_american_put_qe_vs_euler(self, key):
        from options_model_tpu.core.config import OptionSpec, PUT
        from options_model_tpu.pricers.american import (
            lsm_poly_backward, simulate_paths)

        spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
        # QE at 16 steps vs Euler at 64: should agree within MC noise.
        Sq = simulate_paths(key, 100.0, 0.5, MCConfig(n_paths=2**16, n_steps=16,
                                                      path_block=4096),
                            "heston", rate=0.05, heston=HP, engine="xla",
                            heston_scheme="qe")
        pq, seq = lsm_poly_backward(Sq, spec, 0.5)
        Se = simulate_paths(key, 100.0, 0.5, MCConfig(n_paths=2**16, n_steps=64,
                                                      path_block=4096),
                            "heston", rate=0.05, heston=HP, engine="xla")
        pe, see = lsm_poly_backward(Se, spec, 0.5)
        assert abs(float(pq) - float(pe)) < 4 * (float(seq) + float(see))


class TestQEKernel:
    def test_sampler_dispatch_qe_pallas(self, key):
        # The QE terminal sampler is XLA under every engine (the GPU kernel
        # covers the Euler scheme only).
        from options_model_tpu.pricers.european import make_terminal_sampler
        sampler = make_terminal_sampler("heston", 100.0, 0.05, 1.0, heston=HP,
                                        engine="xla", heston_scheme="qe")
        from options_model_tpu.core.config import MCConfig
        S_T = sampler(key, 0, MCConfig(n_paths=2048, n_steps=4, path_block=1024))
        assert np.isfinite(np.asarray(S_T)).all()


class TestQEVarianceBasis:
    def test_qe_grid_with_variance(self, key, devices8):
        """QE-scheme Heston grid pricing with the variance-augmented basis
        (the QE simulator emits v too)."""
        import numpy as np
        from options_model_tpu.core.config import PUT, MCConfig
        from options_model_tpu.parallel import make_mesh, price_american_grid

        mesh = make_mesh(("tasks",), devices=devices8)
        mc = MCConfig(n_paths=16384, n_steps=12, path_block=2048)
        p = price_american_grid(
            key, np.array([100.0]), np.array([100.0]), np.array([0.5]),
            0.05, mc, mesh, cp=PUT, sigma=None, heston=HP,
            model="heston", heston_scheme="qe", engine="xla")
        assert np.isfinite(float(p[0])) and float(p[0]) > 0
