"""Heston characteristic function, COS pricing, and calibration
(BASELINE.json configs[3])."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.core.config import CalibrationConfig, HestonParams, MCConfig
from options_model_tpu.calibration import (
    MarketSurface,
    calibrate_heston_to_data,
    create_synthetic_heston_surface,
    detect_regime,
    heston_charfn,
    heston_cos_price,
)
from options_model_tpu.calibration.calibrator import _objective_core
from options_model_tpu.models.heston import simulate_heston
from options_model_tpu.pricers.blackscholes import bs_price, implied_vol

TRUE = HestonParams(kappa=2.5, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
S0, R = 100.0, 0.05


class TestCharFn:
    def test_at_zero_frequency(self):
        # phi(0) = 1 exactly.
        phi = heston_charfn(jnp.array([0.0]), 1.0, R, TRUE)
        np.testing.assert_allclose(np.asarray(phi), 1.0 + 0.0j, atol=1e-5)

    def test_conjugate_symmetry(self):
        # phi(-u) = conj(phi(u)) for real u.
        u = jnp.array([0.5, 1.0, 5.0, 20.0])
        a = np.asarray(heston_charfn(u, 1.0, R, TRUE))
        b = np.asarray(heston_charfn(-u, 1.0, R, TRUE))
        np.testing.assert_allclose(b, np.conj(a), rtol=1e-4)

    def test_modulus_bounded(self):
        u = jnp.linspace(0.1, 100.0, 64)
        phi = np.asarray(heston_charfn(u, 2.0, R, TRUE))
        assert np.all(np.abs(phi) <= 1.0 + 1e-5)

    def test_long_maturity_stable(self):
        # The little-trap branch must not blow up at long T.
        u = jnp.linspace(0.1, 50.0, 32)
        phi = np.asarray(heston_charfn(u, 10.0, R, TRUE))
        assert np.all(np.isfinite(phi.real)) and np.all(np.isfinite(phi.imag))


class TestCOSPricer:
    def test_bs_limit(self):
        # xi -> 0 with v0 = theta reduces Heston to BS at sigma = sqrt(theta).
        p = HestonParams(kappa=2.0, theta=0.04, xi=0.02, rho=0.0, v0=0.04)
        cos = float(heston_cos_price(S0, 100.0, 1.0, R, p, 1.0))
        bs = float(bs_price(S0, 100.0, 1.0, R, 0.2, 1.0))
        np.testing.assert_allclose(cos, bs, rtol=2e-3)

    def test_matches_monte_carlo(self, key):
        cfg = MCConfig(n_paths=2**19, n_steps=200, path_block=4096)
        S_T = simulate_heston(key, S0, R, 0.5, TRUE, cfg, return_paths=False)
        disc = np.exp(-R * 0.5)
        for K in [90.0, 100.0, 110.0]:
            mc_pay = jnp.maximum(S_T - K, 0.0) * disc
            mc = float(jnp.mean(mc_pay))
            se = float(jnp.std(mc_pay)) / np.sqrt(S_T.size)
            cos = float(heston_cos_price(S0, K, 0.5, R, TRUE, 1.0))
            assert abs(cos - mc) < max(4 * se, 0.02), (
                f"K={K}: COS {cos:.4f} vs MC {mc:.4f} +- {se:.4f}")

    def test_put_call_parity(self):
        Ks = jnp.array([85.0, 100.0, 115.0])
        call = heston_cos_price(S0, Ks, 0.5, R, TRUE, 1.0)
        put = heston_cos_price(S0, Ks, 0.5, R, TRUE, -1.0)
        np.testing.assert_allclose(np.asarray(call - put),
                                   S0 - np.asarray(Ks) * np.exp(-R * 0.5),
                                   atol=2e-3)

    def test_surface_vectorization(self):
        Ks = jnp.linspace(80.0, 120.0, 8)
        Ts = jnp.linspace(0.1, 1.0, 5)
        Km, Tm = jnp.meshgrid(Ks, Ts)
        prices = heston_cos_price(S0, Km, Tm, R, TRUE, 1.0)
        assert prices.shape == (5, 8)
        # monotone decreasing in strike at fixed T
        assert np.all(np.diff(np.asarray(prices), axis=1) < 0)

    def test_differentiable_in_params(self):
        def price_of(x):
            p = HestonParams(kappa=x[0], theta=x[1], xi=x[2], rho=x[3], v0=x[4])
            return heston_cos_price(S0, 100.0, 0.5, R, p, 1.0)

        g = np.asarray(jax.grad(lambda x: price_of(x).sum())(
            jnp.array([2.5, 0.04, 0.3, -0.7, 0.04], jnp.float32)))
        assert np.all(np.isfinite(g))
        assert g[4] > 0  # price increases in v0


class TestRegime:
    def test_thresholds(self):
        assert detect_regime(0.10) == "low_vol"
        assert detect_regime(0.25) == "normal_vol"
        assert detect_regime(0.50) == "high_vol"


class TestMarketSurface:
    def test_filters_invalid_rows(self):
        s = MarketSurface(strikes=[100.0, -5.0, 100.0, 100.0],
                          expiries=[0.5, 0.5, 0.0001, 0.5],
                          ivs=[0.2, 0.2, 0.2, 5.0], S0=100.0)
        assert len(s) == 1

    def test_rejects_all_invalid(self):
        with pytest.raises(ValueError):
            MarketSurface(strikes=[-1.0], expiries=[0.5], ivs=[0.2], S0=100.0)


class TestObjectivePrecision:
    """The f32 COS chain has an ~1e-3 objective noise floor (coherent
    per-term rounding over the series, correlated with the CPU-generated
    synthetic data only on CPU); the f64 path drops it below 1e-7 on every
    backend. See calibrator._make_objective's analysis."""

    def _x64(self):
        from options_model_tpu.calibration.calibrator import (
            _try_enable_explicit_x64)
        if not _try_enable_explicit_x64():
            pytest.skip("explicit x64 dtypes unavailable")

    def _cpu(self):
        # The f64/complex128 COS chain is a CPU-evaluated objective (the
        # calibrator's candidate chain picks f64 on the CPU device) — pin
        # these precision claims to CPU so they hold on any default backend.
        # Explicit-x64 mode is entered HERE (scoped, not leaked: the library
        # probe never flips the process-global flag —
        # calibrator._explicit_x64_scope).
        from contextlib import ExitStack
        from options_model_tpu.calibration.calibrator import (
            _explicit_x64_scope)
        st = ExitStack()
        st.enter_context(_explicit_x64_scope())
        st.enter_context(jax.default_device(jax.devices("cpu")[0]))
        return st

    def test_x64_probe_does_not_leak_global_mode(self):
        """Neither the probe nor f64 surface generation may leave the
        process-global jax_explicit_x64_dtypes flag flipped (review fix: the
        leak changed np.float64 canonicalization library-wide, and f64
        HestonParams leaking into the complex chain means a complex128
        program the accelerator backend cannot compile)."""
        from options_model_tpu.calibration.calibrator import (
            _try_enable_explicit_x64)
        before = jax.config.jax_explicit_x64_dtypes
        _try_enable_explicit_x64()
        assert jax.config.jax_explicit_x64_dtypes == before
        create_synthetic_heston_surface(TRUE, dtype=np.float64)
        assert jax.config.jax_explicit_x64_dtypes == before

    def test_f64_objective_floor(self):
        """On f64-GENERATED data the f64 objective at truth is essentially
        zero (< 1e-6); on f32-generated data it bottoms out at the DATA's
        f32 rounding floor (~1e-4) — while the f32 CPU objective on the same
        f32 data reads near-zero only because the data's rounding is
        bit-correlated with the evaluator (the artificially-low CPU baseline
        of the r1/r2 reports)."""
        self._x64()
        from options_model_tpu.pricers.blackscholes import implied_vol

        with self._cpu():
            x64 = jnp.array([2.5, 0.04, 0.3, -0.7, 0.04], jnp.float64)
            # f64 generator: same grid as create_synthetic_heston_surface
            Ks = np.linspace(80.0, 120.0, 15)
            Ts = np.asarray([30, 60, 90, 180], np.float64) / 365.0
            Kg, Tg = np.meshgrid(Ks, Ts)
            Kg, Tg = Kg.reshape(-1), Tg.reshape(-1)
            K64 = jnp.asarray(Kg, jnp.float64)
            T64 = jnp.asarray(Tg, jnp.float64)
            p64 = heston_cos_price(S0, K64, T64, R, TRUE, cp=1.0,
                                   dtype=jnp.float64)
            iv64 = implied_vol(p64, S0, K64, T64, R, cp=1.0)
            v64_clean = float(_objective_core(x64, K64, T64, iv64, S0, R,
                                              dtype=jnp.float64))
            assert v64_clean < 1e-6
            # f32-generated data: the floor is the data's rounding, not ours
            K, T, iv = create_synthetic_heston_surface(TRUE)
            v64_f32data = float(_objective_core(
                x64, jnp.asarray(K, jnp.float64), jnp.asarray(T, jnp.float64),
                jnp.asarray(iv, jnp.float64), S0, R, dtype=jnp.float64))
            assert v64_clean < v64_f32data < 1e-3

    def test_f64_cos_price_precision(self):
        """f64 COS prices match an independent high-precision reference (the
        f32 path's documented ~2e-3 floor must be gone)."""
        self._x64()
        with self._cpu():
            K, T, _ = create_synthetic_heston_surface(TRUE)
            p32 = np.asarray(heston_cos_price(
                S0, jnp.asarray(K, jnp.float32), jnp.asarray(T, jnp.float32),
                R, TRUE, cp=1.0))
            p64 = np.asarray(heston_cos_price(
                S0, jnp.asarray(K, jnp.float64), jnp.asarray(T, jnp.float64),
                R, TRUE, cp=1.0, dtype=jnp.float64))
            # doubling the term count changes f64 prices by < 1e-6
            # (converged), while f32-vs-f64 shows the f32 rounding floor
            p64b = np.asarray(heston_cos_price(
                S0, jnp.asarray(K, jnp.float64), jnp.asarray(T, jnp.float64),
                R, TRUE, cp=1.0, n_terms=512, dtype=jnp.float64))
            assert np.max(np.abs(p64 - p64b)) < 1e-6
            assert np.max(np.abs(p32 - p64)) < 5e-3  # the f32 floor, bounded

    @pytest.mark.gpu
    def test_f64_fallback_on_accelerator(self):
        """On the GPU the calibrator must land on the f64 objective (on the
        CPU device), never the f32 accelerator combination whose ~1e-3
        objective floor stalls the optimizer."""
        from options_model_tpu.calibration.calibrator import HestonCalibrator

        self._x64()
        with self._cpu():
            K, T, iv = create_synthetic_heston_surface(TRUE)
        surf = MarketSurface(strikes=K, expiries=T, ivs=iv, S0=S0, rate=R)
        cal = HestonCalibrator(CalibrationConfig(max_iterations=1))
        cal._make_objective(surf)
        assert cal._objective_dtype == np.float64
        assert cal._objective_device is not None
        assert cal._objective_device.platform == "cpu"

    def test_calibrator_selects_f64(self):
        """The objective factory must pick the f64 path when available."""
        from options_model_tpu.calibration.calibrator import HestonCalibrator

        self._x64()
        K, T, iv = create_synthetic_heston_surface(TRUE)
        surf = MarketSurface(strikes=K, expiries=T, ivs=iv, S0=S0, rate=R)
        cal = HestonCalibrator(CalibrationConfig(max_iterations=1))
        cal._make_objective(surf)
        assert cal._objective_dtype == np.float64


class TestCalibration:
    def test_objective_zero_at_truth(self):
        K, T, iv = create_synthetic_heston_surface(TRUE)
        v = _objective_core(jnp.array([2.5, 0.04, 0.3, -0.7, 0.04], jnp.float32),
                            jnp.asarray(K, jnp.float32), jnp.asarray(T, jnp.float32),
                            jnp.asarray(iv, jnp.float32), S0, R)
        assert float(v) < 1e-3

    def test_objective_increases_away_from_truth(self):
        K, T, iv = create_synthetic_heston_surface(TRUE)
        args = (jnp.asarray(K, jnp.float32), jnp.asarray(T, jnp.float32),
                jnp.asarray(iv, jnp.float32), S0, R)
        at_truth = float(_objective_core(
            jnp.array([2.5, 0.04, 0.3, -0.7, 0.04], jnp.float32), *args))
        away = float(_objective_core(
            jnp.array([2.5, 0.09, 0.3, -0.7, 0.09], jnp.float32), *args))
        assert away > at_truth + 1e-3

    def test_round_trip_recovers_parameters(self):
        # Full round trip with the gradient-driven stage only (fast path).
        K, T, iv = create_synthetic_heston_surface(TRUE)
        cfg = CalibrationConfig(optimization_methods=("L-BFGS-B",), verbose=False)
        params, summary = calibrate_heston_to_data(K, T, iv, S0=S0, config=cfg)
        assert summary["error"] < 0.01  # < 1 vol point weighted RMSE
        assert abs(params.theta - TRUE.theta) < 0.02
        assert abs(params.v0 - TRUE.v0) < 0.02
        assert abs(params.rho - TRUE.rho) < 0.25

    def test_round_trip_f64_data_recovers_tightly(self):
        """On f64-generated data the f64 objective's floor (<1e-7) lets the
        round trip recover EVERY parameter to ~0.1% and the weighted IV RMSE
        to <1e-4 — the bench.py calibration leg's configuration (the f32-data
        round trip above stops at the data's own rounding floor)."""
        from options_model_tpu.calibration.calibrator import (
            _try_enable_explicit_x64)
        if not _try_enable_explicit_x64():
            pytest.skip("explicit x64 dtypes unavailable")
        K, T, iv = create_synthetic_heston_surface(TRUE, dtype=np.float64)
        cfg = CalibrationConfig(optimization_methods=("L-BFGS-B",), verbose=False)
        params, summary = calibrate_heston_to_data(K, T, iv, S0=S0, config=cfg)
        assert summary["error"] < 1e-4
        for name in ("kappa", "theta", "xi", "rho", "v0"):
            got, true = getattr(params, name), getattr(TRUE, name)
            assert abs(got / true - 1.0) < 1e-2, (name, got, true)

    def test_feller_penalty_active(self):
        K, T, iv = create_synthetic_heston_surface(TRUE)
        args = (jnp.asarray(K, jnp.float32), jnp.asarray(T, jnp.float32),
                jnp.asarray(iv, jnp.float32), S0, R)
        violating = float(_objective_core(
            jnp.array([0.6, 0.02, 2.0, -0.7, 0.04], jnp.float32), *args))
        assert violating > 100.0  # dominated by the Feller penalty


class TestNoisyCalibration:
    """Recovery under quote noise — the operating condition live chains
    actually present (VERDICT r3 next #5). Facts these pin (measured across
    seeds in scripts-level probes):

    - the weighted IV RMSE bottoms out AT the noise level (the objective
      cannot beat the data);
    - theta/v0/xi/rho stay identified (few-% recovery), while kappa is the
      classic weakly-identified direction under noise (term-structure
      trade-off vs theta/v0) and may wander tens of percent — asserting it
      tightly would pin noise, not skill;
    - the regime detector drives the bounds on noisy surfaces too (summary
      carries the detected regime).
    """

    def _x64_or_skip(self):
        from options_model_tpu.calibration.calibrator import (
            _try_enable_explicit_x64)
        if not _try_enable_explicit_x64():
            pytest.skip("explicit x64 dtypes unavailable")

    @pytest.mark.slow
    def test_half_volpoint_noise_recovery(self):
        self._x64_or_skip()
        K, T, iv = create_synthetic_heston_surface(TRUE, noise_std=0.005,
                                                   seed=4, dtype=np.float64)
        cfg = CalibrationConfig(optimization_methods=("L-BFGS-B",),
                                verbose=False)
        params, summary = calibrate_heston_to_data(K, T, iv, S0=S0,
                                                   config=cfg)
        assert summary["regime"] == "normal_vol"
        # noise floor: within 50% above the injected stddev, and not
        # implausibly below it (overfit guard)
        assert 0.002 < summary["error"] < 0.0075
        assert abs(params.theta - TRUE.theta) < 0.01
        assert abs(params.v0 - TRUE.v0) < 0.01
        assert abs(params.rho - TRUE.rho) < 0.15
        assert abs(params.xi / TRUE.xi - 1.0) < 0.3

    @pytest.mark.slow
    def test_sparse_two_expiry_chain(self):
        """A 2-expiry chain (30/90d) with noise — the realistic thin-market
        shape; the variance levels must still come back."""
        self._x64_or_skip()
        K, T, iv = create_synthetic_heston_surface(
            TRUE, noise_std=0.005, seed=7, dtype=np.float64,
            expiries_days=(30, 90))
        cfg = CalibrationConfig(optimization_methods=("L-BFGS-B",),
                                verbose=False)
        params, summary = calibrate_heston_to_data(K, T, iv, S0=S0,
                                                   config=cfg)
        assert summary["error"] < 0.0075
        assert abs(params.theta - TRUE.theta) < 0.01
        assert abs(params.v0 - TRUE.v0) < 0.01

    @pytest.mark.slow
    def test_low_vol_regime_bounds_drive_noisy_fit(self):
        """Mean IV ~11% -> low_vol bounds; theta/v0 ~0.012 sit BELOW the
        normal_vol floor rescued in r2 (0.02), so recovery here proves the
        regime actually switched the box."""
        self._x64_or_skip()
        low = HestonParams(kappa=3.0, theta=0.012, xi=0.15, rho=-0.3,
                           v0=0.012)
        K, T, iv = create_synthetic_heston_surface(low, noise_std=0.003,
                                                   seed=9, dtype=np.float64)
        cfg = CalibrationConfig(optimization_methods=("L-BFGS-B",),
                                verbose=False)
        params, summary = calibrate_heston_to_data(K, T, iv, S0=S0,
                                                   config=cfg)
        assert summary["regime"] == "low_vol"
        assert summary["error"] < 0.005
        assert abs(params.theta - low.theta) < 0.005
        assert abs(params.v0 - low.v0) < 0.005

    def test_regime_detection_drives_summary(self):
        """Detection across the three IV levels reaches the summary (cheap:
        no optimizer run needed to check the surface->regime wiring)."""
        from options_model_tpu.calibration.calibrator import (
            HestonCalibrator, MarketSurface)
        for level, want in ((0.10, "low_vol"), (0.22, "normal_vol"),
                            (0.45, "high_vol")):
            surf = MarketSurface(strikes=np.full(8, 100.0),
                                 expiries=np.linspace(0.1, 1.0, 8),
                                 ivs=np.full(8, level), S0=100.0, rate=0.05)
            assert surf.regime == want
            cal = HestonCalibrator()
            cal.last_regime = surf.regime
            cal.best_params = TRUE
            cal.best_error = 0.0
            assert cal.get_calibration_summary()["regime"] == want


class TestSyntheticSurface:
    def test_smile_shape(self):
        K, T, iv = create_synthetic_heston_surface(TRUE)
        # negative rho -> downward-sloping skew in strike at fixed expiry
        row = iv[:15]  # first expiry block
        assert row[0] > row[-1]

    def test_noise_reproducible(self):
        _, _, a = create_synthetic_heston_surface(TRUE, noise_std=0.005, seed=1)
        _, _, b = create_synthetic_heston_surface(TRUE, noise_std=0.005, seed=1)
        np.testing.assert_array_equal(a, b)


class TestCosLKnob:
    def test_cos_l_has_effect(self):
        """CalibrationConfig.cos_L must actually reach the COS pricer
        (VERDICT r1 weak #4: dead knob). A far-too-narrow truncation width
        visibly degrades the objective at the true parameters."""
        K, T, iv = create_synthetic_heston_surface(TRUE)
        args = (jnp.asarray(K, jnp.float32), jnp.asarray(T, jnp.float32),
                jnp.asarray(iv, jnp.float32), S0, R)
        x_true = jnp.array([2.5, 0.04, 0.3, -0.7, 0.04], jnp.float32)
        wide = float(_objective_core(x_true, *args, cos_L=12.0))
        narrow = float(_objective_core(x_true, *args, cos_L=1.0))
        assert wide < 1e-3
        assert narrow > wide * 5.0

    @pytest.mark.slow
    def test_cos_l_flows_from_config(self):
        """The calibrator's jitted objective closes over cfg.cos_L."""
        from options_model_tpu.calibration.calibrator import (
            HestonCalibrator, MarketSurface)
        K, T, iv = create_synthetic_heston_surface(TRUE)
        surface = MarketSurface(strikes=K, expiries=T, ivs=iv, S0=S0, rate=R)
        good = HestonCalibrator(CalibrationConfig(cos_L=12.0))
        bad = HestonCalibrator(CalibrationConfig(cos_L=1.0))
        x = np.array([2.5, 0.04, 0.3, -0.7, 0.04], np.float64)
        f_good = good._make_objective(surface)[0](x)
        f_bad = bad._make_objective(surface)[0](x)
        assert f_bad > f_good * 5.0
