"""American-Asian LSM vs the Hull-White lattice oracle + the Kemna-Vorst CV.

Anchor construction (difference-of-differences): the lattice's absolute level
carries binomial-dynamics + representative-average interpolation bias that is
COMMON to its European and American legs (measured: EU leg ~+0.3% at
substeps=6, n_avg=400, converging from above in n_avg), so the American
anchor is the exact MC European price (geometric-CV stderr ~4e-4) plus the
lattice's early-exercise PREMIUM, where the common-mode bias cancels.
Measured at the test settings: LSM+CV sits ~0.3% below the anchor (in-sample
policy suboptimality + residual lattice error), well inside the 1% gate —
the same tolerance the Heston ADI oracle uses (tests/test_fd_heston.py).
"""

import jax
import jax.numpy as jnp
import pytest

from options_model_tpu.core.config import MCConfig, OptionSpec
from options_model_tpu.core.stats import masked_mean_stderr
from options_model_tpu.models.heston import HestonParams
from options_model_tpu.pricers.american import simulate_paths
from options_model_tpu.pricers.american_asian import (lsm_asian_backward,
                                                      price_american_asian,
                                                      running_average)
from options_model_tpu.pricers.exotics import (geometric_asian_bs_price,
                                               price_asian_mc)
from options_model_tpu.pricers.fd_asian import asian_binomial_price

S0, K, T, R, SIG = 100.0, 100.0, 1.0, 0.05, 0.2
MC = MCConfig(n_paths=1 << 16, n_steps=25, path_block=4096)
PUT = OptionSpec(strike=K, rate=R, sigma=SIG, cp=-1.0)
CALL = OptionSpec(strike=K, rate=R, sigma=SIG, cp=1.0)
KEY = jax.random.PRNGKey(7)


class TestGeometricClosedForm:
    def test_matches_mc_geometric_asian(self):
        cf = geometric_asian_bs_price(S0, K, T, R, SIG, MC.n_steps, cp=-1.0)
        mc, se = price_asian_mc(KEY, S0, T, PUT, MC, average="geometric")
        assert abs(float(cf) - float(mc)) < 3.5 * float(se)

    def test_call_parity_with_forward(self):
        # cp=+1 minus cp=-1 equals the discounted forward-minus-strike of
        # the geometric average (model-free within the lognormal family)
        call = geometric_asian_bs_price(S0, K, T, R, SIG, 25, cp=1.0)
        put = geometric_asian_bs_price(S0, K, T, R, SIG, 25, cp=-1.0)
        n = 25.0
        mu = jnp.log(S0) + (R - 0.5 * SIG**2) * T * (n + 1) / (2 * n)
        var = SIG**2 * T * (n + 1) * (2 * n + 1) / (6 * n * n)
        F = jnp.exp(mu + 0.5 * var)
        expected = jnp.exp(-R * T) * (F - K)
        assert abs(float(call - put - expected)) < 1e-3


class TestKemnaVorstCV:
    def test_cv_cuts_stderr(self):
        _, se_cv = price_asian_mc(KEY, S0, T, PUT, MC)
        _, se_plain = price_asian_mc(KEY, S0, T, PUT, MC,
                                     control_variate="off")
        assert float(se_cv) < float(se_plain) / 10.0  # measured ~32x

    def test_cv_agrees_with_plain(self):
        p_cv, se_cv = price_asian_mc(KEY, S0, T, PUT, MC)
        p, se = price_asian_mc(KEY, S0, T, PUT, MC, control_variate="off")
        assert abs(float(p_cv) - float(p)) < 4.0 * float(se)

    def test_cv_on_rejects_ineligible(self):
        with pytest.raises(ValueError, match="control_variate"):
            price_asian_mc(KEY, S0, T, PUT, MC, average="geometric",
                           control_variate="on")


class TestEuropeanLimit:
    def test_exercise_from_n_equals_european(self):
        """exercise_from = n_steps suppresses every early-exercise date, so
        the backward scan must reproduce the European Asian on the SAME
        paths bitwise-near."""
        S = simulate_paths(KEY, S0, T, MC, "gbm", sigma=SIG, rate=R)
        pb = MC.path_block
        eu_lsm, _ = lsm_asian_backward(S, PUT, T, exercise_from=MC.n_steps,
                                       stat_pair_block=pb)
        A = running_average(S)
        pay = jnp.maximum(PUT.cp * (A[-1] - K), 0.0)
        disc = jnp.exp(-R * jnp.asarray(T, S.dtype))
        eu, _, _ = masked_mean_stderr(pay * disc, pair_block=pb)
        assert abs(float(eu_lsm) - float(eu)) < 1e-4

    def test_american_above_european(self):
        am, am_se = price_american_asian(KEY, S0, T, PUT, MC)
        eu, eu_se = price_asian_mc(KEY, S0, T, PUT, MC)
        assert float(am) > float(eu) + 0.1  # premium measured ~0.62


class TestLatticeOracle:
    def test_lsm_vs_composite_anchor(self):
        """LSM+CV within 1% of (exact MC European) + (lattice premium)."""
        eu_mc, _ = price_asian_mc(KEY, S0, T, PUT, MC)
        tree_eu = asian_binomial_price(S0, K, T, R, SIG, MC.n_steps, cp=-1.0,
                                       substeps=6, n_avg=400, american=False)
        tree_am = asian_binomial_price(S0, K, T, R, SIG, MC.n_steps, cp=-1.0,
                                       substeps=6, n_avg=400, american=True)
        anchor = float(eu_mc) + (tree_am - tree_eu)
        am, _ = price_american_asian(KEY, S0, T, PUT, MC)
        assert abs(float(am) - anchor) / anchor < 0.01

    def test_lattice_call_no_early_exercise_without_q(self):
        """Fixed-strike Asian CALL under r>0, q=0: the discounted running
        average is a submartingale early on, and the lattice premium must be
        tiny relative to price (sanity that 'american' wiring doesn't leak
        value)."""
        eu = asian_binomial_price(S0, K, T, R, SIG, 10, cp=1.0, substeps=4,
                                  n_avg=200, american=False)
        am = asian_binomial_price(S0, K, T, R, SIG, 10, cp=1.0, substeps=4,
                                  n_avg=200, american=True)
        assert am >= eu - 1e-12
        assert (am - eu) / eu < 0.25  # averaging locks in: SOME premium


class TestFloatingStrike:
    def test_floating_put_above_european(self):
        am, _ = price_american_asian(KEY, S0, T, PUT, MC,
                                     strike_type="floating")
        eu, _ = price_asian_mc(KEY, S0, T, PUT, MC, strike_type="floating")
        assert float(am) >= float(eu) - 1e-3

    def test_cv_on_rejects_floating(self):
        with pytest.raises(ValueError, match="control_variate"):
            price_american_asian(KEY, S0, T, PUT, MC,
                                 strike_type="floating",
                                 control_variate="on")


class TestEstimatorVariants:
    def test_oos_consistent_with_in_sample(self):
        am, se = price_american_asian(KEY, S0, T, PUT, MC,
                                      control_variate="off")
        oos, oos_se = price_american_asian(KEY, S0, T, PUT, MC,
                                           out_of_sample=True,
                                           control_variate="off")
        tol = 4.0 * (float(se) ** 2 + float(oos_se) ** 2) ** 0.5 + 0.02
        assert abs(float(am) - float(oos)) < tol
        assert float(oos) <= float(am) + 2.0 * tol  # OOS is the low-biased leg

    def test_cv_cuts_or_matches_stderr(self):
        _, se_cv = price_american_asian(KEY, S0, T, CALL, MC)
        _, se = price_american_asian(KEY, S0, T, CALL, MC,
                                     control_variate="off")
        assert float(se_cv) <= float(se) * 1.05


class TestHestonAsian:
    def test_heston_american_above_european(self):
        hp = HestonParams(kappa=2.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04)
        am, _ = price_american_asian(KEY, S0, T, PUT, MC, model="heston",
                                     heston=hp)
        eu, eu_se = price_asian_mc(KEY, S0, T, PUT, MC, model="heston",
                                   heston=hp)
        assert float(am) >= float(eu) - 2.0 * float(eu_se)
        assert 0.5 < float(am) < 10.0
