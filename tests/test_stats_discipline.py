"""Antithetic pair-mean statistics discipline across every estimator.

Raw antithetic samples are not i.i.d. (core/stats.pair_mean_reduce), so every
reported stderr must be computed over pair means. These tests pin the VERDICT
r1 findings: the grid pricer's european_approximation and control-variate
branches, and the NN-LSM backward, all report the pair-mean stderr.
"""

import pytest
import jax
import numpy as np

from options_model_tpu.core.config import (
    PUT,
    LSMConfig,
    MCConfig,
    OptionSpec,
)
from options_model_tpu.core.payoff import vanilla_payoff
from options_model_tpu.core.stats import masked_mean_stderr
from options_model_tpu.parallel import make_mesh, price_american_grid
from options_model_tpu.pricers.american import (
    _cv_adjustment,
    lsm_nn_backward,
    lsm_poly_backward,
    simulate_paths,
)

S0, K, T, R, SIG = 100.0, 100.0, 0.5, 0.05, 0.2
MC = MCConfig(n_paths=8 * 2048, n_steps=12, path_block=1024)


def _grid_args(key, n_tasks=8):
    S0s = np.full(n_tasks, S0, np.float32)
    Ks = np.full(n_tasks, K, np.float32)
    Ts = np.full(n_tasks, T, np.float32)
    return key, S0s, Ks, Ts


def _task0_paths(key):
    """The exact path matrix the grid pricer simulates for task 0."""
    task_key = jax.random.fold_in(key, np.int32(0))
    return simulate_paths(task_key, S0, T, MC, "gbm", sigma=SIG, rate=R,
                          engine="xla")


class TestGridEuropeanApproxStderr:
    @pytest.mark.slow
    def test_equals_pair_mean_stderr(self, key, devices8):
        mesh = make_mesh(("tasks",), devices=devices8)
        k, S0s, Ks, Ts = _grid_args(key)
        prices, stderrs = price_american_grid(
            k, S0s, Ks, Ts, R, MC, mesh, cp=PUT, sigma=SIG, model="gbm",
            engine="xla", european_approximation=True, return_stderr=True)

        S_paths = _task0_paths(key)
        pay = vanilla_payoff(S_paths[-1], K, PUT) * np.exp(-R * T)
        pb = MC.path_block
        mean_p, se_pair, _ = masked_mean_stderr(pay, None, None, pb)
        se_raw = float(np.std(np.asarray(pay)) / np.sqrt(pay.size))

        np.testing.assert_allclose(float(prices[0]), float(mean_p), rtol=1e-6)
        np.testing.assert_allclose(float(stderrs[0]), float(se_pair), rtol=1e-5)
        # put payoff is monotone in S_T -> pairs anticorrelated -> raw stderr
        # strictly overstates; the reported one must be the smaller pair one
        assert float(stderrs[0]) < 0.9 * se_raw


class TestGridControlVariateStderr:
    def test_describes_cv_statistic(self, key, devices8):
        mesh = make_mesh(("tasks",), devices=devices8)
        k, S0s, Ks, Ts = _grid_args(key)
        prices, stderrs = price_american_grid(
            k, S0s, Ks, Ts, R, MC, mesh, cp=PUT, sigma=SIG, model="gbm",
            engine="xla", use_control_variate=True, return_stderr=True)

        S_paths = _task0_paths(key)
        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG)
        pb = MC.path_block
        _, se_raw, (cash, mask) = lsm_poly_backward(S_paths, spec, T,
                                                    return_cash=True)
        # default cv_beta='opt': the grid applies the pair-mean
        # variance-minimizing coefficient (core/stats.optimal_cv_beta)
        from options_model_tpu.core.stats import optimal_cv_beta
        adj = _cv_adjustment(S_paths, spec, T)
        cv = cash + optimal_cv_beta(cash, adj, mask, None, pb) * adj
        mean_cv, se_cv, _ = masked_mean_stderr(cv, mask, None, pb)

        np.testing.assert_allclose(float(prices[0]), float(mean_cv), rtol=1e-6)
        np.testing.assert_allclose(float(stderrs[0]), float(se_cv), rtol=1e-5)
        # the CV statistic's error sits below the raw LSM stderr
        assert float(stderrs[0]) < 0.95 * float(se_raw)


class TestOptimalCVBeta:
    """core/stats.optimal_cv_beta — the variance-minimizing control-variate
    coefficient, estimated over antithetic PAIR MEANS (the stderr's own
    granularity). The reference's fixed beta=1 is a measured wash-or-worse
    on ATM puts (se 0.0165 vs plain 0.0130 at 2^16 paths) because pairing
    already cancels the monotone component both legs share; the pair-mean
    beta* (~0.3-0.5 there) restores a guaranteed reduction."""

    def test_recovers_planted_coefficient(self, key):
        from options_model_tpu.core.stats import optimal_cv_beta
        import jax.numpy as jnp
        k1, k2 = jax.random.split(key)
        adj = jax.random.normal(k1, (1 << 16,))
        cash = 5.0 - 0.7 * adj + 0.01 * jax.random.normal(k2, (1 << 16,))
        beta = optimal_cv_beta(cash, adj)
        np.testing.assert_allclose(float(beta), 0.7, atol=2e-3)
        # a mask must restrict the moments to the masked rows
        mask = (jnp.arange(1 << 16) % 2 == 0).astype(cash.dtype)
        cash2 = jnp.where(mask > 0, cash, 1e3)  # poison unmasked rows
        beta_m = optimal_cv_beta(cash2, adj, mask)
        np.testing.assert_allclose(float(beta_m), 0.7, atol=3e-3)

    def test_put_cv_never_hurts(self, key):
        """cv_beta='opt' must report a stderr <= both the plain pricer's and
        the reference's beta=1 on the adversarial case (ATM put)."""
        from options_model_tpu.pricers.american import (
            price_american, price_american_with_control_variate)
        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG)
        _, se_plain = price_american(
            key, S0, T, spec, MC, LSMConfig(use_control_variate=False),
            engine="xla")
        p_one, se_one = price_american_with_control_variate(
            key, S0, T, spec, MC, LSMConfig(cv_beta="one"), engine="xla")
        p_opt, se_opt = price_american_with_control_variate(
            key, S0, T, spec, MC, LSMConfig(), engine="xla")
        assert float(se_opt) <= float(se_one)
        assert float(se_opt) <= 1.01 * float(se_plain)
        # both estimators price the same option (within joint MC noise)
        assert abs(float(p_opt) - float(p_one)) < 4 * (float(se_opt)
                                                       + float(se_one))


class TestReplayLSMStderr:
    def test_pair_aware(self, key):
        from options_model_tpu.pricers.replay import (
            price_american_lsm_gbm_replay)

        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG)
        p_raw, se_raw = price_american_lsm_gbm_replay(
            key, S0, T, spec, MC, stat_pair_block=None)
        p_pair, se_pair = price_american_lsm_gbm_replay(
            key, S0, T, spec, MC, stat_pair_block=MC.path_block)
        # same estimator, different (correct) error accounting; the replayed
        # XLA GBM stream mirrors within path_block, and put cashflows are
        # anticorrelated across pairs -> the pair stderr is strictly smaller
        np.testing.assert_allclose(float(p_raw), float(p_pair), rtol=1e-6)
        assert float(se_pair) < float(se_raw)
        # the DEFAULT derives the pair block from mc like every sibling
        # estimator — no caller has to thread it (review fix: it was opt-in)
        p_auto, se_auto = price_american_lsm_gbm_replay(key, S0, T, spec, MC)
        np.testing.assert_array_equal(float(p_auto), float(p_pair))
        np.testing.assert_array_equal(float(se_auto), float(se_pair))


class TestNNLSMStderr:
    def test_pair_aware(self, key):
        S_paths = _task0_paths(key)
        spec = OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG)
        lsm = LSMConfig(regressor="nn", nn_epochs=3, nn_hidden=16, nn_layers=1)
        pb = MC.path_block
        fit_key = jax.random.fold_in(key, 7)
        p_raw, se_raw = lsm_nn_backward(fit_key, S_paths, spec, T, lsm)
        p_pair, se_pair = lsm_nn_backward(fit_key, S_paths, spec, T, lsm,
                                          stat_pair_block=pb)
        # same estimator, different (correct) error accounting
        np.testing.assert_allclose(float(p_raw), float(p_pair), rtol=1e-6)
        assert float(se_pair) < float(se_raw)
