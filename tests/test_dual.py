"""Martingale-dual upper bound and the primal-dual bracket (pricers/dual.py).

The dual is the one estimator family that bounds the price from ABOVE — these
tests pin (a) that the policy fit is bitwise the poly backward, (b) that the
bracket contains the CRR oracle from both sides, (c) tightness (the headline
claim: ~0.1-0.2% above the oracle at 50 dates), and (d) the repo's stderr and
determinism disciplines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.core.config import (HestonParams, LSMConfig, MCConfig,
                                            OptionSpec)
from options_model_tpu.pricers.american import lsm_poly_backward, simulate_paths
from options_model_tpu.pricers.binomial import crr_american
from options_model_tpu.pricers.dual import (
    LSMPolicy,
    dual_upper_from_policy,
    fit_lsm_policy,
    price_american_bracket,
)
from options_model_tpu.pricers.fd_heston import heston_fd_price

S0, K, T, R, SIG = 100.0, 100.0, 0.5, 0.05, 0.2
PUT_SPEC = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=SIG)
MC = MCConfig(n_paths=1 << 16, n_steps=50, path_block=4096)
HP = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
H_SPEC = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None)


@pytest.fixture(scope="module")
def oracle():
    return crr_american(S0, K, T, R, SIG, cp=-1.0, n_steps=4096)


@pytest.fixture(scope="module")
def bracket():
    return price_american_bracket(jax.random.key(0), S0, T, PUT_SPEC, MC)


class TestPolicyFit:
    def test_cash_matches_lsm_poly_backward_bitwise(self, key):
        """fit_lsm_policy is the same algorithm as lsm_poly_backward with the
        regressions additionally returned — the stopped cash must be
        IDENTICAL, not merely close."""
        mc = MCConfig(n_paths=1 << 14, n_steps=20, path_block=4096)
        S = simulate_paths(key, S0, T, mc, "gbm", sigma=SIG, rate=R,
                           engine="xla")
        policy, cash = fit_lsm_policy(S, PUT_SPEC, T)
        _, _, (cash_ref, _) = lsm_poly_backward(S, PUT_SPEC, T,
                                                return_cash=True)
        assert bool(jnp.all(cash == cash_ref))
        assert policy.betas.shape == (mc.n_steps - 1, 5)  # degree 3 + 2

    def test_policy_dates_forward_order(self, key):
        """betas[0] belongs to date t=1: a near-expiry date has a much wider
        ITM x-spread than t=1, so the standardization scale x_rstd must be
        LARGER at the start of the array than at the end if the order is
        forward."""
        mc = MCConfig(n_paths=1 << 14, n_steps=20, path_block=4096)
        S = simulate_paths(key, S0, T, mc, "gbm", sigma=SIG, rate=R,
                           engine="xla")
        policy, _ = fit_lsm_policy(S, PUT_SPEC, T)
        assert float(policy.x_rstd[0]) > float(policy.x_rstd[-1])


class TestBracket:
    def test_contains_oracle(self, bracket, oracle):
        """low - 4se <= CRR <= high + 4se — the whole point of the bracket.
        (The dual bounds the 50-date Bermudan value, which sits ~0.13% below
        the continuous CRR limit; the measured upper still clears CRR with
        ~0.1% to spare, but the assertion allows the Bermudan gap.)"""
        lo = float(bracket.low) - 4 * float(bracket.low_stderr)
        hi = float(bracket.high) + 4 * float(bracket.high_stderr)
        assert lo <= oracle
        assert hi >= oracle * (1.0 - 0.0015)  # Bermudan-vs-continuous slack

    def test_tightness(self, bracket, oracle):
        """Headline: the dual sits within 1% of the oracle (measured ~0.11%)
        and the whole bracket is under 1.5% wide — this is a bound on the
        estimator BIAS, far tighter than any a-priori LSM error analysis."""
        assert float(bracket.high) <= oracle * 1.01
        width = float(bracket.high) - float(bracket.low)
        assert 0.0 < width < oracle * 0.015

    def test_deterministic(self, bracket):
        br2 = price_american_bracket(jax.random.key(0), S0, T, PUT_SPEC, MC)
        assert float(br2.low) == float(bracket.low)
        assert float(br2.high) == float(bracket.high)

    def test_call_with_dividends(self, key):
        spec = OptionSpec(strike=K, rate=R, cp=1.0, sigma=SIG, div_yield=0.03)
        oc = crr_american(S0, K, T, R, SIG, cp=1.0, n_steps=4096, q=0.03)
        br = price_american_bracket(jax.random.key(1), S0, T, spec, MC)
        assert float(br.low) - 4 * float(br.low_stderr) <= oc
        assert float(br.high) + 4 * float(br.high_stderr) >= oc * 0.9985
        assert float(br.high) <= oc * 1.01

    def test_in_sample_diagnostic_mode(self, oracle):
        """out_of_sample=False is documented as approximate (the policy has
        seen the eval paths) but should still sit above the oracle here."""
        br = price_american_bracket(jax.random.key(2), S0, T, PUT_SPEC, MC,
                                    out_of_sample=False)
        assert float(br.high) >= oracle * (1.0 - 0.0015)
        assert float(br.low) <= float(br.high)

    def test_requires_sigma(self):
        spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None)
        with pytest.raises(ValueError, match="sigma"):
            price_american_bracket(jax.random.key(0), S0, T, spec, MC)


class TestHestonBracket:
    """The bracket under Heston dynamics: the policy carries the variance
    basis, the dual's inner sampler replicates the full-truncation Euler
    transition, and the ADI solver (pricers/fd_heston.py) is the independent
    oracle the bracket must contain."""

    @pytest.fixture(scope="class")
    def oracle_h(self):
        return heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True)

    @pytest.fixture(scope="class")
    def bracket_h(self):
        return price_american_bracket(jax.random.key(0), S0, T, H_SPEC, MC,
                                      model="heston", heston=HP)

    def test_contains_oracle(self, bracket_h, oracle_h):
        """low - 4se <= ADI <= high + 4se (with the Bermudan-vs-continuous
        slack on the upper side, as in the GBM test — the 50-date dual bounds
        the discretized price). Measured: [-0.73%, +0.42%] around the oracle,
        so both sides clear with room."""
        lo = float(bracket_h.low) - 4 * float(bracket_h.low_stderr)
        hi = float(bracket_h.high) + 4 * float(bracket_h.high_stderr)
        assert lo <= oracle_h
        assert hi >= oracle_h * (1.0 - 0.0015)

    def test_tightness(self, bracket_h, oracle_h):
        """The Heston dual sits within 1% of the ADI oracle (measured ~0.42%
        — looser than GBM's ~0.11% because the surrogate's European floor is
        a moment-matched BS price, not the exact Heston value) and the whole
        bracket is under 2% wide."""
        assert float(bracket_h.high) <= oracle_h * 1.01
        width = float(bracket_h.high) - float(bracket_h.low)
        assert 0.0 < width < oracle_h * 0.02

    def test_policy_cash_matches_variance_basis_backward(self, key):
        """fit_lsm_policy(v_paths=...) must be bitwise lsm_poly_backward with
        the variance basis — same masked WLS on the same 7-column design."""
        mc = MCConfig(n_paths=1 << 14, n_steps=20, path_block=4096)
        S, v = simulate_paths(key, S0, T, mc, "heston", heston=HP, rate=R,
                              engine="xla", return_variance=True)
        policy, cash = fit_lsm_policy(S, H_SPEC, T, v_paths=v)
        _, _, (cash_ref, _) = lsm_poly_backward(S, H_SPEC, T, v_paths=v,
                                                return_cash=True)
        assert bool(jnp.all(cash == cash_ref))
        assert policy.betas.shape == (mc.n_steps - 1, 8)  # degree 3 + 2 + 3
        assert policy.v_mean is not None and policy.v_rstd is not None

    @pytest.mark.slow
    def test_deterministic(self, bracket_h):
        br2 = price_american_bracket(jax.random.key(0), S0, T, H_SPEC, MC,
                                     model="heston", heston=HP)
        assert float(br2.low) == float(bracket_h.low)
        assert float(br2.high) == float(bracket_h.high)

    def test_requires_heston_params(self):
        with pytest.raises(ValueError, match="heston"):
            price_american_bracket(jax.random.key(0), S0, T, H_SPEC, MC,
                                   model="heston")

    def test_rejects_sigma_under_heston(self, key):
        """spec.sigma must be None under model='heston' — the variance state
        drives the vol; a constant sigma would silently be ignored."""
        mc = MCConfig(n_paths=4096, n_steps=10, path_block=1024)
        S, v = simulate_paths(key, S0, T, mc, "heston", heston=HP, rate=R,
                              engine="xla", return_variance=True)
        policy, _ = fit_lsm_policy(S, H_SPEC, T, v_paths=v)
        with pytest.raises(ValueError, match="sigma"):
            dual_upper_from_policy(key, S, PUT_SPEC, T, policy,
                                   model="heston", heston=HP, v_paths=v)

    def test_rejects_gbm_policy(self, key):
        """A policy fitted WITHOUT the variance basis cannot drive the Heston
        dual (its surrogate has no variance columns)."""
        mc = MCConfig(n_paths=4096, n_steps=10, path_block=1024)
        S, v = simulate_paths(key, S0, T, mc, "heston", heston=HP, rate=R,
                              engine="xla", return_variance=True)
        policy, _ = fit_lsm_policy(S, H_SPEC, T)  # no v_paths
        with pytest.raises(ValueError, match="v_paths"):
            dual_upper_from_policy(key, S, H_SPEC, T, policy,
                                   model="heston", heston=HP, v_paths=v)


class TestShardedBracket:
    """Mesh-sharded bracket (parallel.batch.price_american_bracket_sharded):
    the sharding-invariance discipline extends to the dual — global-block
    OOS parity, psum'ed policy Grams, and inner draws keyed by GLOBAL path
    block, so the mesh result equals the single-device one."""

    def _mesh(self, devices8):
        from options_model_tpu.parallel import make_mesh
        return make_mesh(("paths",), devices=devices8)

    @pytest.mark.slow
    def test_equals_single_device_gbm(self, devices8):
        from options_model_tpu.parallel import price_american_bracket_sharded
        mc = MCConfig(n_paths=8 * 2048, n_steps=20, path_block=1024)
        br_s = price_american_bracket_sharded(
            jax.random.key(7), S0, T, PUT_SPEC, mc, self._mesh(devices8))
        br_u = price_american_bracket(jax.random.key(7), S0, T, PUT_SPEC, mc,
                                      engine="xla")
        np.testing.assert_allclose(float(br_s.low), float(br_u.low),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(br_s.high), float(br_u.high),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(br_s.low_stderr),
                                   float(br_u.low_stderr), rtol=1e-3)
        np.testing.assert_allclose(float(br_s.high_stderr),
                                   float(br_u.high_stderr), rtol=1e-3)

    @pytest.mark.slow
    def test_equals_single_device_heston(self, devices8):
        from options_model_tpu.parallel import price_american_bracket_sharded
        mc = MCConfig(n_paths=8 * 2048, n_steps=20, path_block=1024)
        br_s = price_american_bracket_sharded(
            jax.random.key(8), S0, T, H_SPEC, mc, self._mesh(devices8),
            model="heston", heston=HP)
        br_u = price_american_bracket(jax.random.key(8), S0, T, H_SPEC, mc,
                                      engine="xla", model="heston",
                                      heston=HP)
        np.testing.assert_allclose(float(br_s.low), float(br_u.low),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(br_s.high), float(br_u.high),
                                   rtol=2e-5)

    @pytest.mark.slow
    def test_odd_blocks_per_device(self, devices8):
        """3 blocks/device: the global OOS parity alternates across ranks —
        the local-parity bug this test exists to catch would split 2/1 the
        same way on every rank and shift the low estimate."""
        from options_model_tpu.parallel import price_american_bracket_sharded
        mc = MCConfig(n_paths=8 * 3 * 1024, n_steps=10, path_block=1024)
        br_s = price_american_bracket_sharded(
            jax.random.key(9), S0, T, PUT_SPEC, mc, self._mesh(devices8))
        br_u = price_american_bracket(jax.random.key(9), S0, T, PUT_SPEC, mc,
                                      engine="xla")
        np.testing.assert_allclose(float(br_s.low), float(br_u.low),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(br_s.high), float(br_u.high),
                                   rtol=2e-5)

    def test_contains_oracle_on_mesh(self, devices8, oracle):
        from options_model_tpu.parallel import price_american_bracket_sharded
        mc = MCConfig(n_paths=8 * 8192, n_steps=50, path_block=1024)
        br = price_american_bracket_sharded(
            jax.random.key(10), S0, T, PUT_SPEC, mc, self._mesh(devices8))
        assert float(br.low) - 4 * float(br.low_stderr) <= oracle
        assert float(br.high) + 4 * float(br.high_stderr) >= oracle * 0.9985
        assert float(br.high) <= oracle * 1.01


class TestNNBracket:
    """Bracket around the reference's FLAGSHIP estimator — the shared
    continuation NETWORK (lsm=LSMConfig(regressor='nn') routes
    fit_nn_policy / dual_upper_from_nn_policy). With the residual European
    baseline + policy iteration (pricers/american._nn_continuation,
    LSMConfig.nn_policy_iters) the NN bracket is nearly as tight as the
    poly one: measured [-0.61%, +0.09%] around CRR at 2^16 paths (the raw
    reference scheme sat at [-3.8%, +2.6%])."""

    # CPU-budget config: NN training is ~6x slower on the 8-virtual-device
    # mesh than single-device, and the nn dual evaluates the net at
    # n_inner x paths inner samples PER DATE — the full-size config
    # (2^16 x 50 x 64, default net) takes ~25 min here (fine on an accelerator).
    # Small net + 2^14 x 50 x 16 keeps each bracket ~70 s; the thresholds
    # below are measured at THIS config.
    NN = LSMConfig(regressor="nn", nn_epochs=8, nn_hidden=32, nn_layers=2)
    MC_NN = MCConfig(n_paths=1 << 14, n_steps=50, path_block=1024)

    @pytest.fixture(scope="class")
    def bracket_nn(self):
        return price_american_bracket(jax.random.key(0), S0, T, PUT_SPEC,
                                      self.MC_NN, lsm=self.NN, n_inner=16)

    def test_contains_oracle(self, bracket_nn, oracle):
        lo = float(bracket_nn.low) - 4 * float(bracket_nn.low_stderr)
        hi = float(bracket_nn.high) + 4 * float(bracket_nn.high_stderr)
        assert lo <= oracle
        assert hi >= oracle * (1.0 - 0.0015)

    def test_tightness(self, bracket_nn, oracle):
        """Measured at this config: [-0.12%, +0.25%] around CRR (at 2^16
        paths / 64 inner draws / default net: [-0.61%, +0.09%]). No
        positivity assertion on the width: low carries ~0.9% MC noise at
        2^14 eval paths and can legitimately land above the dual."""
        assert float(bracket_nn.high) <= oracle * 1.015
        width = float(bracket_nn.high) - float(bracket_nn.low)
        assert width < oracle * 0.03

    @pytest.mark.slow
    def test_heston_contains_adi(self):
        hp_fd = heston_fd_price(S0, K, T, R, HP, cp=-1.0, american=True)
        br = price_american_bracket(jax.random.key(0), S0, T, H_SPEC,
                                    self.MC_NN, model="heston", heston=HP,
                                    lsm=self.NN, n_inner=16)
        assert float(br.low) - 4 * float(br.low_stderr) <= hp_fd
        assert float(br.high) + 4 * float(br.high_stderr) >= hp_fd * 0.9985
        assert float(br.high) <= hp_fd * 1.025

    @pytest.mark.slow
    def test_heston_rejects_gbm_net(self, key):
        """A net trained without the variance feature (7 inputs) cannot
        drive the Heston dual — its continuation ignores the vol state."""
        from options_model_tpu.pricers.dual import (dual_upper_from_nn_policy,
                                                    fit_nn_policy)
        mc = MCConfig(n_paths=4096, n_steps=10, path_block=1024)
        S, v = simulate_paths(key, S0, T, mc, "heston", heston=HP, rate=R,
                              engine="xla", return_variance=True)
        policy, _ = fit_nn_policy(key, S, H_SPEC, T, self.NN)  # no v_paths
        with pytest.raises(ValueError, match="variance feature"):
            dual_upper_from_nn_policy(key, S, H_SPEC, T, policy, self.NN,
                                      model="heston", heston=HP, v_paths=v)


class TestDualEstimator:
    def test_policy_shape_mismatch_rejected(self, key):
        mc = MCConfig(n_paths=4096, n_steps=10, path_block=1024)
        S = simulate_paths(key, S0, T, mc, "gbm", sigma=SIG, rate=R,
                           engine="xla")
        bad = LSMPolicy(betas=jnp.zeros((3, 5)), x_mean=jnp.zeros(3),
                        x_rstd=jnp.ones(3))
        with pytest.raises(ValueError, match="dates"):
            dual_upper_from_policy(key, S, PUT_SPEC, T, bad)

    def test_odd_inner_count_rejected(self, key):
        mc = MCConfig(n_paths=4096, n_steps=10, path_block=1024)
        S = simulate_paths(key, S0, T, mc, "gbm", sigma=SIG, rate=R,
                           engine="xla")
        policy, _ = fit_lsm_policy(S, PUT_SPEC, T)
        with pytest.raises(ValueError, match="n_inner"):
            dual_upper_from_policy(key, S, PUT_SPEC, T, policy, n_inner=7)

    def test_stderr_pair_discipline(self, key):
        """The reported stderr must be over antithetic pair means (the repo's
        statistics discipline) — same point estimate, different (correct)
        error accounting."""
        mc = MCConfig(n_paths=1 << 14, n_steps=20, path_block=1024)
        S = simulate_paths(key, S0, T, mc, "gbm", sigma=SIG, rate=R,
                           engine="xla")
        policy, _ = fit_lsm_policy(S, PUT_SPEC, T)
        k_in = jax.random.fold_in(key, 99)
        up_raw, se_raw = dual_upper_from_policy(k_in, S, PUT_SPEC, T, policy)
        up_pair, se_pair = dual_upper_from_policy(
            k_in, S, PUT_SPEC, T, policy, stat_pair_block=mc.path_block)
        np.testing.assert_allclose(float(up_raw), float(up_pair), rtol=1e-6)
        assert float(se_pair) != float(se_raw)

    def test_more_inner_samples_tighter(self, key):
        """Inner noise only loosens the bound; averaging over seeds, more
        inner draws must not loosen it. Single comparison with a wide inner
        gap (4 vs 256) so the ordering is deterministic in practice."""
        mc = MCConfig(n_paths=1 << 14, n_steps=20, path_block=1024)
        S = simulate_paths(key, S0, T, mc, "gbm", sigma=SIG, rate=R,
                           engine="xla")
        policy, _ = fit_lsm_policy(S, PUT_SPEC, T)
        k_in = jax.random.fold_in(key, 5)
        up_few, _ = dual_upper_from_policy(k_in, S, PUT_SPEC, T, policy,
                                           n_inner=4)
        up_many, _ = dual_upper_from_policy(k_in, S, PUT_SPEC, T, policy,
                                            n_inner=256)
        assert float(up_many) <= float(up_few)


class TestJumpFamilyBrackets:
    """Merton/Bates primal-dual brackets: the inner one-step sampler gains
    the simulator's exact compound-jump increment and the terminal closed
    form becomes the Poisson-mixture Black (dual._one_step_jump_black)."""

    MP_J = None  # set lazily to avoid import at collection

    def _params(self):
        from options_model_tpu.core.config import BatesParams, MertonParams
        mp = MertonParams(sigma=0.2, lam=0.5, mu_j=-0.1, sigma_j=0.15)
        bp = BatesParams(heston=HP, lam=0.3, mu_j=-0.1, sigma_j=0.15)
        return mp, bp

    @pytest.mark.slow
    def test_merton_bracket_contains_cv_estimate(self, key):
        from options_model_tpu.core.config import LSMConfig
        from options_model_tpu.pricers import price_american
        mp, _ = self._params()
        spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=0.2)
        mc = MCConfig(n_paths=1 << 15, n_steps=25, path_block=2048)
        br = price_american_bracket(key, S0, T, spec, mc, model="merton",
                                    merton=mp, engine="xla")
        p, se = price_american(jax.random.fold_in(key, 9), S0, T, spec, mc,
                               LSMConfig(use_control_variate=True),
                               model="merton", merton=mp, engine="xla")
        lo = float(br.low) - 3 * float(br.low_stderr)
        hi = float(br.high) + 3 * float(br.high_stderr)
        assert lo <= float(p) <= hi, (lo, float(p), hi)
        assert (float(br.high) - float(br.low)) / float(p) < 0.05

    @pytest.mark.slow
    def test_merton_upper_above_european(self, key):
        from options_model_tpu.models.merton import merton_price
        mp, _ = self._params()
        spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=0.2)
        mc = MCConfig(n_paths=1 << 14, n_steps=20, path_block=2048)
        br = price_american_bracket(key, S0, T, spec, mc, model="merton",
                                    merton=mp, engine="xla")
        eu = float(merton_price(S0, K, T, R, mp, cp=-1.0))
        assert float(br.high) + 3 * float(br.high_stderr) > eu

    @pytest.mark.slow
    def test_bates_bracket_contains_cv_estimate(self, key):
        from options_model_tpu.core.config import LSMConfig
        from options_model_tpu.pricers import price_american
        _, bp = self._params()
        spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None)
        mc = MCConfig(n_paths=1 << 15, n_steps=25, path_block=2048)
        br = price_american_bracket(key, S0, T, spec, mc, model="bates",
                                    bates=bp, engine="xla")
        p, se = price_american(jax.random.fold_in(key, 9), S0, T, spec, mc,
                               LSMConfig(use_control_variate=True),
                               model="bates", bates=bp, engine="xla")
        lo = float(br.low) - 3 * float(br.low_stderr)
        hi = float(br.high) + 3 * float(br.high_stderr)
        assert lo <= float(p) <= hi, (lo, float(p), hi)
        assert (float(br.high) - float(br.low)) / float(p) < 0.06

    @pytest.mark.slow
    def test_bates_lam_zero_matches_heston_dual(self, key):
        """lam=0 bates dual must equal the heston dual on the same paths
        (the jump layer degenerates: Poisson(0) counts, zero compensator)."""
        from options_model_tpu.core.config import BatesParams
        from options_model_tpu.pricers.american import simulate_paths as sim
        from options_model_tpu.pricers.dual import (dual_upper_from_policy,
                                                    fit_lsm_policy)
        b0 = BatesParams(heston=HP, lam=0.0, mu_j=0.0, sigma_j=0.1)
        spec = OptionSpec(strike=K, rate=R, cp=-1.0, sigma=None)
        mc = MCConfig(n_paths=1 << 13, n_steps=10, path_block=1024)
        S, v = sim(key, S0, T, mc, "heston", rate=R, heston=HP,
                   engine="xla", return_variance=True)
        policy, _ = fit_lsm_policy(S, spec, T, v_paths=v)
        k_in = jax.random.fold_in(key, 3)
        up_h, _ = dual_upper_from_policy(k_in, S, spec, T, policy,
                                         model="heston", heston=HP,
                                         v_paths=v, n_inner=8)
        up_b, _ = dual_upper_from_policy(k_in, S, spec, T, policy,
                                         model="bates", bates=b0,
                                         v_paths=v, n_inner=8)
        # same normals; the jump layer adds Poisson(0)=0 counts and a
        # zero compensator -> values agree to float tolerance
        np.testing.assert_allclose(float(up_b), float(up_h), rtol=2e-5)

    def test_nn_policy_rejected_for_jump_models(self, key):
        from options_model_tpu.core.config import LSMConfig, MertonParams
        mp = MertonParams(sigma=0.2, lam=0.5, mu_j=-0.1, sigma_j=0.15)
        with pytest.raises(ValueError, match="nn-policy"):
            price_american_bracket(
                key, S0, T, OptionSpec(strike=K, rate=R, cp=-1.0, sigma=0.2),
                MCConfig(n_paths=4096, n_steps=10, path_block=1024),
                model="merton", merton=mp, lsm=LSMConfig(regressor="nn"))


@pytest.mark.slow
class TestSABRBracket:
    """SABR (beta=1) primal-dual bracket: the inner sampler replicates
    simulate_sabr's exact-lognormal alpha step and spot-converted log-Euler
    F step; anchored by the (F, alpha) Douglas-ADI oracle (fd_sabr.py)."""

    SP = None

    def _sabr(self):
        from options_model_tpu.core.config import SABRParams
        return SABRParams(alpha=0.2, beta=1.0, rho=-0.4, nu=0.6)

    @pytest.mark.slow
    def test_contains_fd_oracle(self, key):
        from options_model_tpu.pricers.fd_sabr import sabr_fd_price
        mc = MCConfig(n_paths=1 << 15, n_steps=40, path_block=2048)
        br = price_american_bracket(key, S0, T, H_SPEC, mc, model="sabr",
                                    sabr=self._sabr(), engine="xla")
        fd = sabr_fd_price(S0, K, T, R, self._sabr(), cp=-1.0)
        lo = float(br.low) - 3 * float(br.low_stderr)
        hi = float(br.high) + 3 * float(br.high_stderr)
        assert lo <= fd <= hi, (lo, fd, hi)
        # tightness: same ballpark as the Heston bracket
        assert (hi - lo) / fd < 0.05

    def test_beta_below_one_rejected(self, key):
        from options_model_tpu.core.config import SABRParams
        sp = SABRParams(alpha=0.2, beta=0.7, rho=-0.4, nu=0.6)
        mc = MCConfig(n_paths=1 << 13, n_steps=10, path_block=2048)
        with pytest.raises(ValueError, match="beta=1"):
            price_american_bracket(key, S0, T, H_SPEC, mc, model="sabr",
                                   sabr=sp, engine="xla")


@pytest.mark.slow
class TestRBergomiBracket:
    """Rough-Bergomi primal-dual bracket — the ONLY certification available
    for H < 1/2 (no PDE oracle exists; the LSM policy is a documented
    Markovian-projection LOWER bound). The inner one-step law is EXACT via
    the frozen Volterra history (simulate_rbergomi return_dual_state)."""

    def test_markovian_limit_contains_drift_adi(self, key):
        """H = 1/2: rBergomi is SABR(beta=1, nu=eta/2) with alpha drift
        -eta^2/8 — the drift-extended ADI (fd_sabr alpha_drift) must land
        inside the bracket."""
        from options_model_tpu.core.config import RBergomiParams, SABRParams
        from options_model_tpu.pricers.fd_sabr import sabr_fd_price
        rb = RBergomiParams(H=0.5, eta=1.0, rho=-0.5, xi0=0.04)
        mc = MCConfig(n_paths=1 << 15, n_steps=40, path_block=2048)
        br = price_american_bracket(key, S0, T, H_SPEC, mc, model="rbergomi",
                                    rbergomi=rb)
        sab = SABRParams(alpha=float(np.sqrt(rb.xi0)), beta=1.0, rho=rb.rho,
                         nu=rb.eta / 2)
        fd = sabr_fd_price(S0, K, T, R, sab, cp=-1.0,
                           alpha_drift=-rb.eta**2 / 8)
        lo = float(br.low) - 3 * float(br.low_stderr)
        hi = float(br.high) + 3 * float(br.high_stderr)
        assert lo <= fd <= hi, (lo, fd, hi)
        assert (hi - lo) / fd < 0.05

    @pytest.mark.slow
    def test_rough_bracket_ordered_and_finite(self, key):
        """H = 0.1: no oracle exists — the bracket itself is the evidence.
        It is VALID (exact inner law) but honestly wide: the (S, v)
        surrogate cannot track the history-dependent value process."""
        from options_model_tpu.core.config import RBergomiParams
        rb = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
        mc = MCConfig(n_paths=1 << 14, n_steps=30, path_block=2048)
        br = price_american_bracket(key, S0, T, H_SPEC, mc, model="rbergomi",
                                    rbergomi=rb)
        lo, hi = float(br.low), float(br.high)
        assert np.isfinite([lo, hi]).all()
        assert lo < hi
        # the low estimate must at least clear the European (exercise at T
        # is feasible), and the bracket must not be vacuous
        from options_model_tpu.models.rbergomi import rbergomi_european_mc
        eu, eu_se = rbergomi_european_mc(jax.random.fold_in(key, 3), S0, K,
                                         R, T, rb, mc, cp=-1.0)
        assert hi + 3 * float(br.high_stderr) > float(eu)
        assert (hi - lo) / lo < 0.5

    def test_missing_hist_rejected(self, key):
        from options_model_tpu.core.config import RBergomiParams
        from options_model_tpu.models.rbergomi import simulate_rbergomi
        from options_model_tpu.pricers.dual import (dual_upper_from_policy,
                                                    fit_lsm_policy)
        rb = RBergomiParams(H=0.3, eta=1.0, rho=-0.5, xi0=0.04)
        mc = MCConfig(n_paths=1 << 12, n_steps=10, path_block=2048)
        Sp, vp = simulate_rbergomi(jax.random.key(1), S0, T, rb, mc, rate=R,
                                   return_paths=True, return_variance=True)
        pol, _ = fit_lsm_policy(Sp, H_SPEC, T, v_paths=vp)
        with pytest.raises(ValueError, match="rb_hist"):
            dual_upper_from_policy(jax.random.key(2), Sp, H_SPEC, T, pol,
                                   model="rbergomi", rbergomi=rb, v_paths=vp)
