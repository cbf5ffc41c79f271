"""NN-LSM as a first-class estimator (VERDICT r2 next #2/#6).

The reference's flagship scheme is the control variate COMPOSED with the
shared continuation network (price_american_with_control_variate wrapping
price_american_enhanced_lsm, options_model_3/options_model_3.py:653-677).
These tests pin the r3 compositions: CV around the nn backward, the OOS
split, verbose stats, the shared-net Richardson extrapolation, and the
epoch-level best-weights criterion (reference :599-613).
"""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from options_model_tpu.core.config import (
    PUT,
    HestonParams,
    LSMConfig,
    MCConfig,
    OptionSpec,
)
from options_model_tpu.pricers import crr_american
from options_model_tpu.pricers.american import (
    _cv_adjustment,
    lsm_nn_backward,
    price_american,
    price_american_with_control_variate,
    price_american_with_stats,
    richardson_nn_stat,
    simulate_paths,
)

S0, K, T, R, SIG = 100.0, 100.0, 0.5, 0.05, 0.2
PUT_SPEC = OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG)
NN = LSMConfig(regressor="nn", nn_epochs=5, nn_hidden=32, nn_layers=2)
MC = MCConfig(n_paths=16 * 2048, n_steps=12, path_block=1024)


class TestNNControlVariate:
    @pytest.mark.slow
    def test_cv_beats_plain_nn_stderr(self, key):
        """The composed estimator must report a smaller error than the plain
        NN estimate on the same paths. The workload is an American CALL (no
        dividends: never exercised early, so the stopped cashflow is ~the
        terminal payoff and the European variate cancels it almost exactly —
        measured 4x stderr reduction). On an ATM put the variate is a wash
        against the pair-mean plain estimator: the NN policy's cash
        correlates only ~0.70 with the terminal payoff and antithetic pairs
        already cancel the same monotone component."""
        call = OptionSpec(strike=K, rate=R, cp=1.0, sigma=SIG)
        _, se_plain = price_american(key, S0, T, call, MC,
                                     NN.replace(use_control_variate=False),
                                     engine="xla")
        p_cv, se_cv = price_american_with_control_variate(
            key, S0, T, call, MC, NN, engine="xla")
        assert float(se_cv) < 0.7 * float(se_plain)
        from options_model_tpu.pricers.blackscholes import bs_price
        bs = float(bs_price(S0, K, T, R, SIG, 1.0))  # call AM = EU here
        assert abs(float(p_cv) - bs) / bs < 0.01

    @pytest.mark.slow
    def test_put_accuracy_vs_crr(self, key):
        p_cv, _ = price_american_with_control_variate(
            key, S0, T, PUT_SPEC, MC, NN, engine="xla")
        oracle = crr_american(S0, K, T, R, SIG, cp=-1.0, n_steps=2048)
        # residual baseline + policy iteration (LSMConfig.nn_policy_iters)
        # removed the raw reference scheme's ~2-3% low bias; the remaining
        # band is 12-date Bermudan gap + MC noise at this small config
        assert abs(float(p_cv) - oracle) / oracle < 0.02

    @pytest.mark.slow
    def test_dispatcher_routes_nn_cv(self, key):
        """price_american with regressor='nn' + use_control_variate must
        return the CV-composed estimate, not silently drop the variate
        (the r2 fallback, VERDICT r2 missing #1)."""
        p_dispatch, se_dispatch = price_american(key, S0, T, PUT_SPEC, MC, NN,
                                                 engine="xla")
        p_cv, se_cv = price_american_with_control_variate(
            key, S0, T, PUT_SPEC, MC, NN, engine="xla")
        np.testing.assert_allclose(float(p_dispatch), float(p_cv), rtol=1e-6)
        np.testing.assert_allclose(float(se_dispatch), float(se_cv), rtol=1e-5)

    @pytest.mark.slow
    def test_cv_statistic_construction(self, key):
        """The CV price equals mean(cash + beta*adjustment) over the same
        paths, with beta the pair-mean variance-minimizing coefficient
        (LSMConfig.cv_beta default 'opt'; 'one' pins the reference's fixed
        coefficient exactly)."""
        from options_model_tpu.core.stats import optimal_cv_beta
        sim_key, fit_key = jax.random.split(key)
        S_paths = simulate_paths(sim_key, S0, T, MC, "gbm", sigma=SIG, rate=R,
                                 engine="xla")
        _, _, (cash, mask) = lsm_nn_backward(fit_key, S_paths, PUT_SPEC, T, NN,
                                             return_cash=True)
        adj = _cv_adjustment(S_paths, PUT_SPEC, T)
        pb = MC.path_block
        beta = optimal_cv_beta(cash, adj, mask, None, pb)
        p_cv, _ = price_american_with_control_variate(
            key, S0, T, PUT_SPEC, MC, NN, engine="xla")
        np.testing.assert_allclose(float(p_cv),
                                   float(jnp.mean(cash + beta * adj)),
                                   rtol=1e-5)
        p_one, _ = price_american_with_control_variate(
            key, S0, T, PUT_SPEC, MC, NN.replace(cv_beta="one"), engine="xla")
        np.testing.assert_allclose(float(p_one), float(jnp.mean(cash + adj)),
                                   rtol=1e-5)


class TestNNStats:
    @pytest.mark.slow
    def test_with_stats_nn(self, key):
        price, se, stats = price_american_with_stats(
            key, S0, T, PUT_SPEC, MC, NN, engine="xla")
        assert np.isfinite(float(price)) and float(se) > 0
        assert 0.0 <= stats["p_worthless"] <= 1.0
        assert stats["min"] <= stats["mean"] <= stats["max"]
        # ATM put: a substantial fraction of paths expires worthless
        assert stats["p_worthless"] > 0.2


class TestNNRichardson:
    def test_shared_net_two_levels(self, key):
        """Fine and coarse policies from ONE net: the statistic is
        2*cash_fine - cash_coarse (+CV), and the extrapolated price must be
        >= the coarse Bermudan price (fewer exercise dates = lower value)."""
        sim_key, fit_key = jax.random.split(key)
        S_paths = simulate_paths(sim_key, S0, T, MC, "gbm", sigma=SIG, rate=R,
                                 engine="xla")
        stat, mask = richardson_nn_stat(
            fit_key, S_paths, None, PUT_SPEC, T,
            NN.replace(use_control_variate=True), model="gbm",
            pair_block=MC.path_block)
        assert stat.shape == (S_paths.shape[1],)
        p = float(jnp.mean(stat))
        oracle = crr_american(S0, K, T, R, SIG, cp=-1.0, n_steps=2048)
        # small-config band: residual MC noise + the 12-date policy's own
        # regression error (the extrapolation removes only the Bermudan gap)
        assert abs(p - oracle) / oracle < 0.05

    def test_price_american_richardson_nn(self, key):
        from options_model_tpu.pricers.american import price_american_richardson
        p, se = price_american_richardson(key, S0, T, PUT_SPEC, MC,
                                          NN.replace(richardson=True),
                                          engine="xla")
        assert np.isfinite(float(p)) and float(se) > 0


class TestPolicyIteration:
    """Residual baseline + policy iteration (pricers/american._policy_targets,
    LSMConfig.nn_policy_iters): the reference's pass-1 targets are discounted
    TERMINAL cashflows, whose true regression function is the EUROPEAN value
    — the induced policy exercises wherever time value is negative and
    prices ~2.6-3.4% below CRR regardless of net capacity. Refitting on the
    cashflows realized under the current policy converges to a
    self-consistent policy (measured: -0.14% at 2^16 paths, 3 rounds)."""

    def test_policy_targets_match_forward_definition(self, key):
        """_policy_targets (one backward scan) must equal the forward
        definition: target[t, p] = the policy's cashflow from dates > t,
        discounted to date t — first exercise date t' > t pays
        disc^(t'-t) * immediate[t'], no exercise pays disc^(n_dates-t) *
        terminal (terminal sits one step after the LAST exercise row
        n_dates-1, i.e. n_dates - t steps after row t)."""
        from options_model_tpu.pricers.american import _policy_targets

        n_dates, n_paths = 6, 64
        k1, k2, k3 = jax.random.split(key, 3)
        immediate = jax.random.uniform(k1, (n_dates, n_paths)) * 5.0
        cont = jax.random.uniform(k2, (n_dates, n_paths)) * 5.0
        terminal = jax.random.uniform(k3, (n_paths,)) * 5.0
        disc1 = 0.97
        got = np.asarray(_policy_targets(immediate, cont, terminal, disc1))

        imm, cnt, term = (np.asarray(immediate), np.asarray(cont),
                          np.asarray(terminal))
        ex = (imm > cnt) & (imm > 0)
        want = np.empty_like(imm)
        for t in range(n_dates):
            for p in range(n_paths):
                later = np.nonzero(ex[t + 1:, p])[0]
                if later.size:
                    tp = t + 1 + later[0]
                    want[t, p] = disc1 ** (tp - t) * imm[tp, p]
                else:
                    want[t, p] = disc1 ** (n_dates - t) * term[p]
        np.testing.assert_allclose(got, want, rtol=1e-6)

    @pytest.mark.slow
    def test_iterated_policy_beats_reference_scheme(self, key):
        """nn_policy_iters=1 (reference-exact European targets) must price
        the ATM put measurably BELOW the iterated policy on the same paths
        — the premature-exercise bias the iteration exists to remove
        (measured at this config: -2.2% vs +0.6%, gap ~5 stderr; the bias
        is TARGET-structural, so the small net shows it just as the
        default net does)."""
        mc = MCConfig(n_paths=1 << 14, n_steps=30, path_block=1024)
        base = NN.replace(nn_epochs=8, use_control_variate=False)
        p1, se1 = price_american(key, S0, T, PUT_SPEC, mc,
                                 base.replace(nn_policy_iters=1),
                                 engine="xla")
        p3, se3 = price_american(key, S0, T, PUT_SPEC, mc,
                                 base.replace(nn_policy_iters=3),
                                 engine="xla")
        assert float(p1) < float(p3) - 2.0 * float(se3)

    def test_policy_iters_validated(self):
        import pytest
        with pytest.raises(ValueError, match="nn_policy_iters"):
            LSMConfig(regressor="nn", nn_policy_iters=0).validate()


class TestEpochBestWeights:
    def test_best_params_minimize_full_loss(self, key):
        """The returned params must score the MINIMUM of the per-epoch
        full-data losses — i.e. best-weight tracking is epoch-granular on the
        loss the estimator cares about, not a lucky minibatch (VERDICT r2
        weak #4; reference options_model_3.py:599-613)."""
        from options_model_tpu.pricers.regressors import (
            fit_continuation_mlp, full_weighted_loss)

        n, d = 4096, 3
        k1, k2, k3 = jax.random.split(key, 3)
        X = jax.random.normal(k1, (n, d))
        y = jnp.sin(X[:, 0]) + 0.1 * jax.random.normal(k2, (n,))
        w = (jax.random.uniform(k3, (n,)) > 0.3).astype(jnp.float32)
        cfg = LSMConfig(regressor="nn", nn_epochs=6, nn_hidden=16,
                        nn_layers=1, nn_batch=256)
        params, epoch_losses = fit_continuation_mlp(key, X, y, w, cfg)
        assert epoch_losses.shape == (cfg.nn_epochs,)
        best = float(full_weighted_loss(params, X, y, w, cfg))
        np.testing.assert_allclose(best, float(jnp.min(epoch_losses)),
                                   rtol=1e-5)
        # ... and in particular no worse than the last epoch's params
        assert best <= float(epoch_losses[-1]) + 1e-7

    def test_chunked_full_loss_matches_direct(self, key):
        from options_model_tpu.pricers.regressors import (
            ContinuationMLP, full_weighted_loss)

        n, d = 1000, 3  # deliberately not a multiple of the chunk
        k1, k2 = jax.random.split(key)
        X = jax.random.normal(k1, (n, d))
        y = jax.random.normal(k2, (n,))
        w = jnp.ones((n,))
        cfg = LSMConfig(regressor="nn", nn_hidden=8, nn_layers=1)
        model = ContinuationMLP(hidden=8, num_layers=1, dropout=cfg.nn_dropout)
        params = model.init(key, X[:1], deterministic=True)
        direct = jnp.mean(
            (model.apply(params, X, deterministic=True)[:, 0] - y) ** 2)
        chunked = full_weighted_loss(params, X, y, w, cfg, chunk=256)
        np.testing.assert_allclose(float(chunked), float(direct), rtol=1e-5)


class TestNNGrid:
    @pytest.mark.slow
    def test_grid_nn_cv_and_richardson(self, key, devices8):
        """The task-sharded grid pricer honors CV and Richardson for nn."""
        from options_model_tpu.parallel import make_mesh, price_american_grid

        mesh = make_mesh(("tasks",), devices=devices8)
        mc = MCConfig(n_paths=8 * 1024, n_steps=10, path_block=1024)
        nn = LSMConfig(regressor="nn", nn_epochs=2, nn_hidden=8, nn_layers=1)
        S0s = np.full(8, S0, np.float32)
        Ks = np.full(8, K, np.float32)
        Ts = np.full(8, T, np.float32)
        # calls: the European variate nearly cancels the (never-early-
        # exercised) stopped cashflow — see test_cv_beats_plain_nn_stderr
        p_plain, se_plain = price_american_grid(
            key, S0s, Ks, Ts, R, mc, mesh, cp=1.0, sigma=SIG, model="gbm",
            engine="xla", use_control_variate=False, lsm=nn,
            return_stderr=True)
        p_cv, se_cv = price_american_grid(
            key, S0s, Ks, Ts, R, mc, mesh, cp=1.0, sigma=SIG, model="gbm",
            engine="xla", use_control_variate=True, lsm=nn,
            return_stderr=True)
        assert float(se_cv[0]) < float(se_plain[0])
        p_rich = price_american_grid(
            key, S0s, Ks, Ts, R, mc, mesh, cp=PUT, sigma=SIG, model="gbm",
            engine="xla", use_control_variate=True,
            lsm=nn.replace(richardson=True))
        assert np.isfinite(np.asarray(p_rich)).all()

    @pytest.mark.slow
    def test_grid_nn_heston_variance_feature(self, key, devices8):
        """nn + Heston routes the variance path matrix as the 8th feature."""
        from options_model_tpu.parallel import make_mesh, price_american_grid

        mesh = make_mesh(("tasks",), devices=devices8)
        mc = MCConfig(n_paths=8 * 1024, n_steps=10, path_block=1024)
        nn = LSMConfig(regressor="nn", nn_epochs=2, nn_hidden=8, nn_layers=1)
        hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
        S0s = np.full(8, S0, np.float32)
        Ks = np.full(8, K, np.float32)
        Ts = np.full(8, T, np.float32)
        p = price_american_grid(
            key, S0s, Ks, Ts, R, mc, mesh, cp=PUT, heston=hp, model="heston",
            engine="xla", use_control_variate=True, lsm=nn)
        assert np.isfinite(np.asarray(p)).all()
