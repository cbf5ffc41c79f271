"""Randomized QMC: Sobol net correctness, bridge covariance, variance wins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.core.config import CALL, PUT, HestonParams, MCConfig, OptionSpec
from options_model_tpu.core.qmc import (
    bb_increments,
    brownian_bridge,
    brownian_bridge_tables,
    sobol_directions,
    sobol_normals,
    sobol_uniforms,
)
from options_model_tpu.pricers import bs_price
from options_model_tpu.pricers.qmc import price_asian_qmc, price_european_qmc

S0, K, T, R, SIG = 100.0, 100.0, 0.5, 0.05, 0.2
CALL_SPEC = OptionSpec(strike=K, rate=R, cp=CALL, sigma=SIG)
PUT_SPEC = OptionSpec(strike=K, rate=R, cp=PUT, sigma=SIG)
HESTON = HestonParams(v0=0.04, kappa=2.0, theta=0.04, xi=0.5, rho=-0.7)


class TestSobolNet:
    def test_matches_scipy_unscrambled(self):
        from scipy.stats import qmc as sqmc

        d, n = 5, 64
        sv, shift = sobol_directions(d)
        ours = np.asarray(sobol_uniforms(sv, shift, 0, n))
        ref = sqmc.Sobol(d=d, scramble=False).random(n)
        # ours sits at cell centers: ref + 0.5 * 2^-30
        assert np.max(np.abs(ours - ref)) <= 2.0 ** -30 + 1e-12

    def test_chunk_invariance(self):
        sv, shift = sobol_directions(4, scramble_seed=7)
        whole = np.asarray(sobol_uniforms(sv, shift, 0, 32))
        parts = np.concatenate([np.asarray(sobol_uniforms(sv, shift, i0, 8))
                                for i0 in (0, 8, 16, 24)])
        np.testing.assert_array_equal(whole, parts)

    def test_scramble_randomizes_but_balances(self):
        # Two scrambles give different points, each set balanced: the mean of
        # a 2^k-point scrambled net estimates 1/2 per dim to O(2^-k).
        sv1, sh1 = sobol_directions(3, scramble_seed=1)
        sv2, sh2 = sobol_directions(3, scramble_seed=2)
        u1 = np.asarray(sobol_uniforms(sv1, sh1, 0, 256))
        u2 = np.asarray(sobol_uniforms(sv2, sh2, 0, 256))
        assert np.max(np.abs(u1 - u2)) > 1e-3
        assert np.max(np.abs(u1.mean(axis=0) - 0.5)) < 0.005
        assert np.max(np.abs(u2.mean(axis=0) - 0.5)) < 0.005

    def test_normals_tail_finite(self):
        sv, sh = sobol_directions(2, scramble_seed=3)
        z = np.asarray(sobol_normals(sv, sh, 0, 1 << 12))
        assert np.all(np.isfinite(z))
        assert abs(z.mean()) < 0.02


class TestBrownianBridge:
    def test_tables_cover_all_steps(self):
        for n in (1, 2, 7, 16, 50):
            m, l, r, wl, wr, sd = brownian_bridge_tables(n)
            assert sorted(m.tolist()) == list(range(1, n + 1))
            assert np.all(sd > 0)

    def test_exact_covariance(self):
        # The bridge is linear: feeding basis vectors extracts the matrix A
        # with W = A Z, so Cov(W) = A A^T must equal min(t_i, t_j) exactly.
        # brownian_bridge maps (n_paths, n_steps) -> (n_steps, n_paths);
        # with Z = I each "path" j is the unit vector e_j, so output column j
        # is A e_j: the returned matrix IS A.
        n = 8
        A = np.asarray(brownian_bridge(jnp.eye(n), T=1.0))
        cov = A @ A.T
        t = (np.arange(1, n + 1)) / n
        expected = np.minimum.outer(t, t)
        np.testing.assert_allclose(cov, expected, atol=2e-6)

    def test_increments_sum_to_terminal(self):
        n = 16
        Z = jnp.asarray(np.random.default_rng(0).normal(size=(32, n)),
                        jnp.float32)
        W = np.asarray(brownian_bridge(Z, T=2.0))
        dW = np.asarray(bb_increments(Z, T=2.0))
        np.testing.assert_allclose(dW.cumsum(axis=0), W, atol=1e-5)


class TestQMCPricing:
    def test_european_gbm_matches_bs_tightly(self):
        price, se, n = price_european_qmc(11, "gbm", S0, CALL_SPEC, T,
                                          n_paths=1 << 12, replicates=8)
        ref = float(bs_price(S0, K, T, R, SIG, 1.0))
        assert abs(float(price) - ref) < max(4.0 * float(se), 2e-3)
        assert float(se) < 2e-3  # ~0.03% of the ~4.6 premium

    def test_european_gbm_beats_mc(self):
        from options_model_tpu.pricers.european import price_european_gbm_exact
        import jax

        n_total = 8 * (1 << 12)
        _, se_q, _ = price_european_qmc(5, "gbm", S0, CALL_SPEC, T,
                                        n_paths=1 << 12, replicates=8)
        _, se_mc, _ = price_european_gbm_exact(jax.random.key(5), S0,
                                               CALL_SPEC, T, n_paths=n_total)
        assert float(se_q) * 5.0 < float(se_mc)

    def test_european_heston_matches_mc_euler(self):
        # QMC and MC estimate the SAME 64-step Euler law — compare directly.
        import jax
        from options_model_tpu.pricers.european import (
            make_terminal_sampler, price_european_mc)

        n_steps = 64
        price_q, se_q, _ = price_european_qmc(
            3, "heston", S0, PUT_SPEC, T, heston=HESTON,
            n_paths=1 << 12, n_steps=n_steps, replicates=8)
        cfg = MCConfig(n_paths=1 << 17, n_steps=n_steps, path_block=4096)
        sampler = make_terminal_sampler("heston", S0, R, T, heston=HESTON,
                                        engine="xla")
        price_m, se_m, _ = price_european_mc(jax.random.key(9), sampler,
                                             PUT_SPEC, T, cfg)
        tol = 4.0 * float(jnp.sqrt(se_q ** 2 + se_m ** 2))
        assert abs(float(price_q) - float(price_m)) < max(tol, 5e-3)

    def test_asian_gbm_matches_mc_and_beats_it(self):
        import jax
        from options_model_tpu.pricers.exotics import price_asian_mc

        n_steps = 32
        p_q, se_q, _ = price_asian_qmc(7, S0, T, CALL_SPEC, n_steps=n_steps,
                                       n_paths=1 << 12, replicates=8)
        cfg = MCConfig(n_paths=8 * (1 << 12), n_steps=n_steps,
                       path_block=4096)
        p_m, se_m = price_asian_mc(jax.random.key(7), S0, T, CALL_SPEC, cfg)
        tol = 4.0 * float(jnp.sqrt(se_q ** 2 + se_m ** 2))
        assert abs(float(p_q) - float(p_m)) < max(tol, 5e-3)
        # equal total path budget: RQMC stderr should win by >3x on the
        # smooth averaged payoff
        assert float(se_q) * 3.0 < float(se_m)

    def test_asian_heston_runs(self):
        p, se, n = price_asian_qmc(1, S0, T, PUT_SPEC, model="heston",
                                   heston=HESTON, n_paths=1 << 11,
                                   n_steps=32, replicates=4)
        assert np.isfinite(float(p)) and float(p) > 0.0
        assert n == 4 * (1 << 11)

    def test_bad_args(self):
        with pytest.raises(ValueError):
            price_european_qmc(0, "localvol", S0, CALL_SPEC, T)
        with pytest.raises(ValueError):
            price_asian_qmc(0, S0, T, CALL_SPEC, average="harmonic")
        with pytest.raises(ValueError):
            price_european_qmc(0, "heston", S0, CALL_SPEC, T)
        with pytest.raises(ValueError):
            price_european_qmc(0, "rbergomi", S0, CALL_SPEC, T)

    def test_rbergomi_matches_mc_same_grid(self):
        """The RQMC rBergomi estimates the SAME hybrid-scheme discretized
        law as models/rbergomi.rbergomi_european_mc — prices must agree
        within combined replicate/MC error (they share n_steps, so the
        discretization bias cancels in the comparison)."""
        from options_model_tpu.core.config import MCConfig, RBergomiParams
        from options_model_tpu.models.rbergomi import rbergomi_european_mc

        rb = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
        pq, seq, _ = price_european_qmc(3, "rbergomi", S0, PUT_SPEC, T,
                                        rbergomi=rb, n_paths=1 << 11,
                                        n_steps=32, replicates=8)
        pm, sem = rbergomi_european_mc(
            jax.random.key(5), S0, PUT_SPEC.strike, PUT_SPEC.rate, T, rb,
            MCConfig(n_paths=1 << 15, n_steps=32, path_block=4096),
            cp=-1.0)
        z = abs(float(pq) - float(pm)) / np.sqrt(
            float(seq) ** 2 + float(sem) ** 2)
        assert z < 4.0, (float(pq), float(pm), z)

    @pytest.mark.slow
    def test_rbergomi_sobol_cli_route(self):
        """price_exotic european --model rbergomi --sampler sobol dispatches
        to the RQMC pricer (apps/price_exotic.py branch) and prices near
        the MC estimate."""
        from options_model_tpu.apps.price_exotic import parse_args, run
        out = run(parse_args(["european", "--model", "rbergomi",
                              "--sampler", "sobol", "--paths", "8192",
                              "--steps", "16", "--option-type", "put"]))
        assert out["n_paths"] == 16 * max(8192 // 16, 1 << 10)
        assert 3.0 < out["price"] < 5.5 and 0 < out["stderr"] < 0.1

    def test_rbergomi_qmc_beats_mc_raw(self):
        """At equal path budget the bridged Sobol net must cut the RAW
        payoff stderr vs pseudo-random MC (the bench measures the exact
        ratio on the GPU; here just the ordering, loose)."""
        from options_model_tpu.core.config import MCConfig, RBergomiParams
        from options_model_tpu.models.rbergomi import rbergomi_european_mc

        rb = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
        n_total = 1 << 14
        _, seq, _ = price_european_qmc(4, "rbergomi", S0, PUT_SPEC, T,
                                       rbergomi=rb, n_paths=n_total // 8,
                                       n_steps=32, replicates=8,
                                       rbergomi_cv=False)
        _, sem = rbergomi_european_mc(
            jax.random.key(6), S0, PUT_SPEC.strike, PUT_SPEC.rate, T, rb,
            MCConfig(n_paths=n_total, n_steps=32, path_block=4096),
            cp=-1.0, control_variate=False)
        assert float(seq) < float(sem), (float(seq), float(sem))


class TestJumpFamilyQMC:
    """RQMC for the jump families: the Merton terminal is EXACT in 3 Sobol
    dims (diffusion normal, Poisson-inverse-CDF count, aggregated size
    normal); Bates appends the same (count, size) pair to the bridged
    Heston dims."""

    def test_poisson_icdf_matches_cdf(self):
        from options_model_tpu.pricers.qmc import _poisson_icdf
        import scipy.stats as st
        lam = 0.7
        u = jnp.linspace(0.001, 0.999, 1001)
        got = np.asarray(_poisson_icdf(u, jnp.float32(lam)))
        want = st.poisson.ppf(np.asarray(u, np.float64), lam)
        np.testing.assert_array_equal(got, want)

    def test_merton_exact_vs_series(self):
        from options_model_tpu.core.config import MertonParams, OptionSpec
        from options_model_tpu.models.merton import merton_price
        from options_model_tpu.pricers.qmc import price_european_qmc
        mp = MertonParams(sigma=0.2, lam=0.5, mu_j=-0.1, sigma_j=0.15)
        spec = OptionSpec(strike=100.0, rate=0.05, cp=-1.0, sigma=None)
        p, se, _ = price_european_qmc(7, "merton", 100.0, spec, 0.5,
                                      merton=mp, n_paths=1 << 12,
                                      replicates=8)
        ref = float(merton_price(100.0, 100.0, 0.5, 0.05, mp, cp=-1.0))
        # exact terminal law: only RQMC noise separates them
        assert abs(float(p) - ref) < 4 * float(se) + 1e-3
        assert float(se) < 0.01  # way below plain-MC stderr at equal budget

    def test_bates_matches_cos_within_euler_bias(self):
        from options_model_tpu.calibration import bates_cos_price
        from options_model_tpu.core.config import (BatesParams, HestonParams,
                                                   OptionSpec)
        from options_model_tpu.pricers.qmc import price_european_qmc
        bp = BatesParams(heston=HestonParams(kappa=2.0, theta=0.04, xi=0.3,
                                             rho=-0.7, v0=0.04),
                         lam=0.3, mu_j=-0.1, sigma_j=0.15)
        spec = OptionSpec(strike=100.0, rate=0.05, cp=-1.0, sigma=None)
        p, se, _ = price_european_qmc(7, "bates", 100.0, spec, 0.5,
                                      bates=bp, n_paths=1 << 12, n_steps=64,
                                      replicates=8)
        cos = float(bates_cos_price(100.0, 100.0, 0.5, 0.05, bp, cp=-1.0))
        # 64-step Euler bias ~5e-3 dominates the tiny RQMC noise
        assert abs(float(p) - cos) < 4 * float(se) + 0.02

    def test_exotic_cli_sobol_european_merton(self):
        from options_model_tpu.apps.price_exotic import parse_args, run
        from options_model_tpu.models.merton import merton_price
        from options_model_tpu.core.config import MertonParams
        out = run(parse_args(["european", "--model", "merton", "--sampler",
                              "sobol", "--paths", "16384", "--steps", "16"]))
        mp = MertonParams(sigma=0.2, lam=1.0, mu_j=-0.1, sigma_j=0.15)
        ref = float(merton_price(100.0, 100.0, 0.5, 0.05, mp, cp=1.0))
        assert abs(out["price"] - ref) < 4 * out["stderr"] + 1e-3

    def test_merton_large_lam_not_saturated(self):
        """lam*T = 12 needs a ~50-term count sweep; the fixed n_max=24 of an
        earlier draft silently clamped ~the whole upper tail and biased the
        price by percents while the replicate stderr stayed tiny
        (_poisson_nmax sizes the sweep from the concrete lam*T)."""
        from options_model_tpu.core.config import MertonParams, OptionSpec
        from options_model_tpu.models.merton import merton_price
        from options_model_tpu.pricers.qmc import price_european_qmc
        mp = MertonParams(sigma=0.2, lam=12.0, mu_j=-0.05, sigma_j=0.1)
        spec = OptionSpec(strike=100.0, rate=0.05, cp=-1.0, sigma=None)
        p, se, _ = price_european_qmc(3, "merton", 100.0, spec, 1.0,
                                      merton=mp, n_paths=1 << 12,
                                      replicates=8)
        ref = float(merton_price(100.0, 100.0, 1.0, 0.05, mp, cp=-1.0,
                                 n_terms=96))
        assert abs(float(p) - ref) < 4 * float(se) + 5e-3, (float(p), ref)

    def test_poisson_nmax_guards(self):
        from options_model_tpu.pricers.qmc import _poisson_nmax
        assert _poisson_nmax(0.0) == 12
        assert _poisson_nmax(100.0) >= 200
        with pytest.raises(ValueError, match="practical range"):
            _poisson_nmax(1e6)
