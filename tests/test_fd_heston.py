"""Heston ADI finite-difference oracle + the variance-augmented LSM basis.

The FD solver (pricers/fd_heston.py) is the first external check on American
prices under stochastic vol (CRR only covers constant vol). It exposed a real
defect: the S-only LSM basis priced ~0.7% below the oracle because the
continuation value depends on the state (S, v); the variance-augmented basis
(LSMConfig.variance_basis, default ON) closes the gap to noise level
(5-seed mean -0.07% at 262k paths)."""

import jax
import numpy as np
import pytest

from options_model_tpu.core.config import (
    PUT, HestonParams, LSMConfig, MCConfig, OptionSpec)
from options_model_tpu.calibration.charfn import heston_cos_price
from options_model_tpu.pricers.fd_heston import heston_fd_price

HP = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
S0, K, T, R = 100.0, 100.0, 0.5, 0.05


class TestFDOracle:
    def test_european_matches_cos(self):
        for cp in (1.0, -1.0):
            fd = heston_fd_price(S0, K, T, R, HP, cp=cp, american=False)
            cos = float(heston_cos_price(S0, K, T, R, HP, cp))
            assert abs(fd / cos - 1.0) < 3e-3, (cp, fd, cos)

    def test_european_matches_cos_with_q(self):
        fd = heston_fd_price(S0, K, 1.0, R, HP, cp=1.0, american=False,
                             q=0.03)
        cos = float(heston_cos_price(S0, K, 1.0, R, HP, 1.0, q=0.03))
        assert abs(fd / cos - 1.0) < 3e-3

    def test_american_dominates(self):
        eu = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=False)
        am = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True)
        assert am > eu + 1e-3              # early-exercise premium
        deep = heston_fd_price(60.0, K, T, R, HP, cp=-1.0, american=True)
        assert deep >= (K - 60.0) - 1e-6   # >= intrinsic

    def test_bermudan_mode_orders_and_converges(self):
        """exercise_dates: the matched-dates Bermudan oracle (the contract
        an n-step LSM discretizes). Bermudan < American, monotone in the
        date count, and projecting at every step recovers the continuous
        mode. This mode is what isolates LSM policy bias from the
        Bermudan->American date gap (bench.py pooled-seed leg: LSM berm@50
        vs ADI berm@50 measured -0.03% +- 0.03%)."""
        g = dict(n_s=120, n_v=60, n_t=120)
        am = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True, **g)
        b10 = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True,
                              exercise_dates=10, **g)
        b40 = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True,
                              exercise_dates=40, **g)
        b120 = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True,
                               exercise_dates=120, **g)
        eu = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=False, **g)
        assert eu < b10 < b40 < b120 <= am + 1e-12
        assert abs(b120 - am) < 1e-9      # every-step projection == American

    def test_bermudan_mode_validates(self):
        with pytest.raises(ValueError, match="multiple"):
            heston_fd_price(S0, K, T, R, HP, american=True, n_t=100,
                            exercise_dates=7)
        with pytest.raises(ValueError, match="american"):
            heston_fd_price(S0, K, T, R, HP, american=False, n_t=100,
                            exercise_dates=50)

    def test_grid_convergence(self):
        # the early-exercise projection converges ~O(dt): halving the grid
        # moves the price a few parts in 1e3 (measured 0.36% 150->300,
        # 0.1% 300->600)
        a = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True,
                            n_s=150, n_v=75, n_t=150)
        b = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True,
                            n_s=300, n_v=150, n_t=300)
        assert abs(a / b - 1.0) < 6e-3


class TestVarianceBasis:
    @pytest.mark.slow
    def test_variance_basis_closes_the_gap(self, key):
        """S-only LSM sits measurably below the ADI oracle; the variance
        columns recover it (one seed, loose-but-ordering-preserving bands;
        5-seed tight check documented in the module docstring)."""
        from options_model_tpu.pricers import price_american

        oracle = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True,
                                 n_s=300, n_v=150, n_t=300)
        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=None)
        mc = MCConfig(n_paths=65536, n_steps=50, path_block=4096)
        p_v, _ = price_american(key, S0, T, spec, mc,
                                LSMConfig(variance_basis=True),
                                model="heston", heston=HP, engine="xla")
        p_s, _ = price_american(key, S0, T, spec, mc,
                                LSMConfig(variance_basis=False),
                                model="heston", heston=HP, engine="xla")
        # same paths, same CV: the variance basis must move the price UP
        # toward the oracle (a better policy can only add value in-sample)
        assert float(p_v) > float(p_s)
        assert abs(float(p_v) / oracle - 1.0) < 0.008
        # and the S-only price sits below the oracle (the documented bias)
        assert float(p_s) < oracle

    @pytest.mark.slow
    def test_grid_pricer_uses_variance_basis(self, key, devices8):
        from options_model_tpu.parallel import make_mesh, price_american_grid

        mesh = make_mesh(("tasks",), devices=devices8)
        mc = MCConfig(n_paths=32768, n_steps=25, path_block=4096)
        kw = dict(cp=PUT, sigma=None, heston=HP, model="heston",
                  engine="xla", return_stderr=False)
        p_v = price_american_grid(key, np.array([S0]), np.array([K]),
                                  np.array([T]), R, mc, mesh,
                                  lsm=LSMConfig(variance_basis=True), **kw)
        p_s = price_american_grid(key, np.array([S0]), np.array([K]),
                                  np.array([T]), R, mc, mesh,
                                  lsm=LSMConfig(variance_basis=False), **kw)
        assert float(p_v[0]) > float(p_s[0])  # same paths, better policy

    def test_shared_sweep_uses_variance_basis(self, key):
        from options_model_tpu.pricers.surface_american import (
            price_american_curve_shared)

        mc = MCConfig(n_paths=131072, n_steps=50, path_block=4096)
        oracle = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True)
        prices, se = price_american_curve_shared(
            key, np.array([S0], np.float32), K, T, R, mc, cp=PUT,
            model="heston", heston=HP, engine="xla",
            use_control_variate=True)
        # 50 dates (Bermudan gap ~-0.13%) + ~3.5 sigma of MC noise inside a
        # 1% band — still catches a missing variance basis (-0.7% systematic
        # would stack on the gap).
        assert abs(float(prices[0]) / oracle - 1.0) < 0.01

    @pytest.mark.slow
    def test_cubic_variance_block_and_degree_knob(self, key):
        """variance_basis_degree=3 appends the cubic (u, w) cross terms —
        the accuracy config that closed the pooled -0.165% policy bias to
        -0.056% (bench.py; decomposition in ROUND_NOTES r5). Same paths,
        richer basis: the induced policy must not lose value beyond noise,
        and the knob must validate."""
        from options_model_tpu.pricers import price_american

        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=None)
        mc = MCConfig(n_paths=32768, n_steps=25, path_block=4096)
        p2, se2 = price_american(key, S0, T, spec, mc,
                                 LSMConfig(variance_basis_degree=2),
                                 model="heston", heston=HP, engine="xla")
        p3, se3 = price_american(key, S0, T, spec, mc,
                                 LSMConfig(variance_basis_degree=3),
                                 model="heston", heston=HP, engine="xla")
        assert float(p3) > float(p2) - 0.5 * float(se2)
        with pytest.raises(ValueError, match="variance_basis_degree"):
            LSMConfig(variance_basis_degree=4).validate()

    def test_sharded_paths_variance_psum(self, key, devices8):
        """Path-sharded 2-D grid with the variance basis: psum'ed Grams over
        the bigger (S, v) basis still match the unsharded backward."""
        from options_model_tpu.parallel import (
            make_mesh, price_american_grid_2d)
        from options_model_tpu.pricers.american import (
            lsm_poly_backward, simulate_paths)

        mesh = make_mesh(("tasks", "paths"), shape=(1, 8), devices=devices8)
        mc = MCConfig(n_paths=16384, n_steps=10, path_block=2048)
        p2d = price_american_grid_2d(
            key, np.array([S0]), np.array([K]), np.array([T]), R, mc, mesh,
            cp=PUT, sigma=None, heston=HP, model="heston")
        tk = jax.random.fold_in(key, 0)
        S, V = simulate_paths(tk, S0, T, mc, "heston", heston=HP, rate=R,
                              engine="xla", return_variance=True)
        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=None)
        ref, _ = lsm_poly_backward(S, spec, T, stat_pair_block=mc.path_block,
                                   v_paths=V)
        assert abs(float(p2d[0]) / float(ref) - 1.0) < 3e-3


class TestVarianceKernels:
    def test_return_variance_rejected_for_gbm(self, key):
        from options_model_tpu.pricers.american import simulate_paths
        mc = MCConfig(n_paths=2048, n_steps=4, path_block=1024)
        with pytest.raises(ValueError, match="variance"):
            simulate_paths(key, 100.0, 0.5, mc, "gbm", sigma=0.2, rate=0.05,
                           return_variance=True)

    @pytest.mark.slow
    def test_nn_regressor_gets_variance_feature(self, key):
        """The NN two-pass scheme also receives v as an input feature under
        Heston (8-dim instead of 7-dim): prices stay finite and inside a
        loose oracle band (the terminal-cashflow targets make this scheme
        intrinsically cruder than the per-date poly backward)."""
        from options_model_tpu.pricers.american import price_american_lsm

        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=None)
        mc = MCConfig(n_paths=16384, n_steps=12, path_block=2048)
        lsm = LSMConfig(regressor="nn", nn_epochs=20, nn_hidden=32,
                        nn_layers=2, nn_dropout=0.0, nn_lr=3e-3)
        p, se = price_american_lsm(key, S0, T, spec, mc, lsm, model="heston",
                                   heston=HP, engine="xla")
        oracle = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True)
        assert np.isfinite(float(p)) and float(se) > 0
        assert abs(float(p) / oracle - 1.0) < 0.05

    def test_variance_basis_off_honored_everywhere(self, key):
        """variance_basis=False must reach EVERY Heston LSM route (review
        r2): shared sweep, 2-D grid and sharded paths all drop the variance
        columns — detected by exact equality with the S-only reference on
        identical paths where available, and by the price ordering."""
        from options_model_tpu.parallel import (
            make_mesh, price_american_grid_2d)
        from options_model_tpu.pricers.surface_american import (
            price_american_curve_shared)

        mc = MCConfig(n_paths=16384, n_steps=10, path_block=2048)
        # shared sweep: S-only (off) must price BELOW the (S, v) policy
        p_v, _ = price_american_curve_shared(
            key, np.array([S0], np.float32), K, T, R, mc, cp=PUT,
            model="heston", heston=HP, engine="xla", variance_basis=True)
        p_s, _ = price_american_curve_shared(
            key, np.array([S0], np.float32), K, T, R, mc, cp=PUT,
            model="heston", heston=HP, engine="xla", variance_basis=False)
        assert float(p_v[0]) > float(p_s[0])

    def test_with_stats_uses_variance_basis(self, key):
        from options_model_tpu.pricers.american import (
            price_american_with_stats)

        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=None)
        mc = MCConfig(n_paths=16384, n_steps=10, path_block=2048)
        p_v, _, _ = price_american_with_stats(
            key, S0, T, spec, mc, LSMConfig(variance_basis=True),
            model="heston", heston=HP, engine="xla")
        p_s, _, _ = price_american_with_stats(
            key, S0, T, spec, mc, LSMConfig(variance_basis=False),
            model="heston", heston=HP, engine="xla")
        assert float(p_v) > float(p_s)
