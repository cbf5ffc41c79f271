"""Chebyshev local-vol surface compilation and the table-driven samplers."""

import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.surface.cheb import (
    LocalVolTable,
    compile_localvol_table,
    eval_table,
)

def _analytic_sigma_fn(S, tau):
    # the synthetic smile formula as a direct function (no NN needed)
    m = jnp.log(jnp.asarray(S) / 100.0)
    iv = 0.2 + 0.1 * jnp.abs(m) + 0.05 * m**2 + 0.02 * jnp.sqrt(tau)
    return jnp.clip(iv, 0.05, 1.0)


class TestChebCompilation:
    def test_fit_accuracy(self):
        table = compile_localvol_table(_analytic_sigma_fn, 100.0, 0.5, 20, 100.0)
        S = jnp.linspace(80.0, 125.0, 128)
        for t in [0, 10, 19]:
            tau = max(0.5 - t * 0.025, 1e-6)
            a = np.asarray(_analytic_sigma_fn(S, tau))
            b = np.asarray(eval_table(table, S, t))
            # the analytic oracle has a |m| kink at ATM that a degree-7
            # polynomial can't match exactly (smooth NN surfaces fit to
            # ~1e-4 vol); ~1e-2 there is expected
            assert np.abs(a - b).max() < 1.2e-2

    def test_table_shapes(self):
        table = compile_localvol_table(_analytic_sigma_fn, 100.0, 0.5, 16,
                                       100.0, degree=5)
        assert table.coeffs.shape == (16, 6)
        assert table.degree == 5
        assert table.m_half > 0

    def test_clamps_outside_range(self):
        table = compile_localvol_table(_analytic_sigma_fn, 100.0, 0.5, 4, 100.0)
        v_in = float(eval_table(table, jnp.array([100.0]), 0)[0])
        v_far = float(eval_table(table, jnp.array([1e6]), 0)[0])
        assert np.isfinite(v_far) and v_far > 0
        assert 0.1 < v_in < 0.5


class TestTableSamplerBackendConsistency:
    def test_xla_fallback_with_table_only(self, key):
        from options_model_tpu.core.config import CALL, MCConfig, OptionSpec
        from options_model_tpu.pricers.european import (
            make_terminal_sampler, price_european_mc)

        table = compile_localvol_table(_analytic_sigma_fn, 100.0, 0.5, 16, 100.0)
        sampler = make_terminal_sampler("localvol", 100.0, 0.05, 0.5,
                                        localvol_table=table, engine="xla")
        spec = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=None)
        cfg = MCConfig(n_paths=2**15, n_steps=16, path_block=4096)
        p, se, _ = price_european_mc(key, sampler, spec, 0.5, cfg)
        assert np.isfinite(float(p)) and 2.0 < float(p) < 12.0

    def test_bad_heston_scheme_rejected_everywhere(self, key):
        from options_model_tpu.core.config import HestonParams, MCConfig
        from options_model_tpu.pricers.american import simulate_paths

        hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
        with pytest.raises(ValueError):
            simulate_paths(key, 100.0, 0.5, MCConfig(n_paths=1024), "heston",
                           rate=0.05, heston=hp, heston_scheme="milstein")

    @pytest.mark.slow
    def test_richardson_supports_nn(self, key):
        # r2 rejected the nn regressor here; r3 reads both Richardson levels
        # off one shared continuation net (american.richardson_nn_stat).
        from options_model_tpu.core.config import (
            PUT, LSMConfig, MCConfig, OptionSpec)
        from options_model_tpu.pricers.american import price_american_richardson

        p, se = price_american_richardson(
            key, 100.0, 0.5, OptionSpec(strike=100.0, rate=0.05, cp=PUT,
                                        sigma=0.2),
            MCConfig(n_paths=4096, n_steps=10, path_block=1024),
            LSMConfig(regressor="nn", nn_epochs=2, nn_hidden=8, nn_layers=1))
        assert np.isfinite(float(p)) and np.isfinite(float(se))


class TestLocalVolPathsKernel:
    def test_simulate_paths_dispatch(self, key):
        from options_model_tpu.core.config import MCConfig
        from options_model_tpu.pricers.american import simulate_paths

        table = compile_localvol_table(_analytic_sigma_fn, 100.0, 0.5, 8, 100.0)
        # XLA fallback path (table -> table_sigma_fn) works everywhere
        S = simulate_paths(key, 100.0, 0.5, MCConfig(n_paths=2048, n_steps=8,
                                                     path_block=1024),
                           "localvol", rate=0.05, localvol_table=table,
                           engine="xla")
        assert S.shape == (9, 2048)
        assert np.isfinite(np.asarray(S)).all()


class TestLocalVolGridPath:
    """The batched grid pricer + curve sweep route local-vol through compiled
    Chebyshev tables, evaluated by the XLA table evaluator."""

    def test_grid_constant_vol_matches_crr(self, key, devices8):
        # A constant surface makes the table exact: localvol == GBM sigma=0.2.
        from options_model_tpu.core.config import MCConfig
        from options_model_tpu.parallel import make_mesh, price_american_grid
        from options_model_tpu.pricers import crr_american

        const = lambda S, tau: jnp.full_like(jnp.asarray(S), 0.2)
        mc = MCConfig(n_paths=32768, n_steps=20, path_block=2048)
        table = compile_localvol_table(const, 100.0, 0.5, 20, 100.0,
                                       S0_range=(95.0, 105.0))
        mesh = make_mesh(("tasks",), devices=devices8)
        S0s = np.array([95.0, 100.0, 105.0, 110.0], np.float32)
        Ks = np.full(4, 100.0, np.float32)
        Ts = np.full(4, 0.5, np.float32)
        prices, stderrs = price_american_grid(
            key, S0s, Ks, Ts, 0.05, mc, mesh, cp=-1.0, model="localvol",
            localvol_table=table, engine="xla", return_stderr=True)
        for s0, p, se in zip(S0s, np.asarray(prices), np.asarray(stderrs)):
            oracle = crr_american(float(s0), 100.0, 0.5, 0.05, 0.2, cp=-1.0,
                                  n_steps=2048)
            assert abs(float(p) - oracle) < max(4.0 * float(se), 0.05), (
                f"S0={s0}: {p} vs CRR {oracle}")

    def test_curves_localvol_sweep(self, key):
        # Smile surface through the full sweep orchestration: one table per
        # (steps, day) bucket; prices match the MLP-in-scan reference path
        # (compute_curve_for_S0 with the raw sigma_fn) within MC+table error.
        from options_model_tpu.apps.curves import (
            CurveRequest, compute_curve_for_S0, compute_curves)

        req = CurveRequest(s0_list=[100.0], strike=100.0, rate=0.05, cp=-1.0,
                           intervals_per_day=1, total_points=2,
                           num_simulations=16384, model="localvol",
                           sigma_fn=_analytic_sigma_fn, engine="xla",
                           use_control_variate=False, seed=42)
        df = compute_curves(req)
        assert len(df) == 2 and np.isfinite(df["Option Value"]).all()
        ref = compute_curve_for_S0(key, 100.0, 100.0, 0.05, -1.0,
                                   intervals_per_day=1, total_points=2,
                                   num_simulations=16384, model="localvol",
                                   sigma_fn=_analytic_sigma_fn,
                                   use_control_variate=False, engine="xla")
        for row, r in zip(df.sort_values("Days to Expiry").itertuples(),
                          sorted(ref, key=lambda x: x["Days to Expiry"])):
            assert abs(row._3 - r["Option Value"]) < 0.05

    def test_curves_localvol_requires_sigma_fn(self):
        from options_model_tpu.apps.curves import CurveRequest, compute_curves

        req = CurveRequest(s0_list=[100.0], strike=100.0, rate=0.05,
                           model="localvol", num_simulations=2048)
        with pytest.raises(ValueError, match="sigma_fn"):
            compute_curves(req)
