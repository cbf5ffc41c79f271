"""Core layer: configs, RNG discipline, Welford statistics, time grids."""

import datetime

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.core import (
    HestonParams,
    MCConfig,
    OptionSpec,
    WelfordState,
    adaptive_num_steps,
    compute_trading_hours_remaining,
    curve_day_grid,
    path_block_keys,
    welford_from_batch,
    welford_mean_stderr,
    welford_merge,
    welford_empty,
)
from options_model_tpu.core.config import CALL, PUT, cp_from_str


class TestConfigs:
    def test_heston_validation_rejects_bad_params(self):
        with pytest.raises(ValueError):
            HestonParams(kappa=-1.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04).validate()
        with pytest.raises(ValueError):
            HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-1.5, v0=0.04).validate()
        with pytest.raises(ValueError):
            HestonParams(kappa=2.0, theta=3.0, xi=0.3, rho=-0.7, v0=0.04).validate()

    def test_feller_condition(self):
        ok = HestonParams(kappa=2.5, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
        assert ok.feller_condition()  # 2*2.5*0.04 = 0.2 >= 0.09
        bad = HestonParams(kappa=0.5, theta=0.02, xi=0.9, rho=-0.7, v0=0.04)
        assert not bad.feller_condition()

    def test_option_spec_payoff(self):
        call = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=0.2)
        put = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
        S = jnp.array([90.0, 100.0, 110.0])
        np.testing.assert_allclose(call.payoff(S), [0.0, 0.0, 10.0])
        np.testing.assert_allclose(put.payoff(S), [10.0, 0.0, 0.0])

    def test_cp_from_str(self):
        assert cp_from_str("call") == CALL
        assert cp_from_str("PUT") == PUT
        with pytest.raises(ValueError):
            cp_from_str("straddle")

    def test_mc_config_validation(self):
        with pytest.raises(ValueError):
            MCConfig(n_paths=0).validate()
        with pytest.raises(ValueError):
            MCConfig(path_block=100).validate()
        assert MCConfig().validate() is not None


class TestRNG:
    def test_path_block_keys_are_offset_invariant(self, key):
        # Block b's key must not depend on how the range is chunked.
        all_keys = path_block_keys(key, 0, 8)
        tail = path_block_keys(key, 4, 4)
        np.testing.assert_array_equal(
            jax.random.key_data(all_keys[4:]), jax.random.key_data(tail))

    def test_distinct_blocks_distinct_streams(self, key):
        keys = path_block_keys(key, 0, 4)
        draws = jax.vmap(lambda k: jax.random.normal(k, (16,)))(keys)
        for i in range(4):
            for j in range(i + 1, 4):
                assert not np.allclose(draws[i], draws[j])


class TestWelford:
    def test_from_batch_matches_numpy(self, key):
        x = jax.random.normal(key, (1000,))
        st = welford_from_batch(x)
        np.testing.assert_allclose(st.mean, np.mean(np.asarray(x)), rtol=1e-6)
        np.testing.assert_allclose(st.variance, np.var(np.asarray(x), ddof=1), rtol=1e-5)

    def test_merge_equals_direct(self, key):
        k1, k2 = jax.random.split(key)
        a = jax.random.normal(k1, (700,))
        b = jax.random.normal(k2, (300,)) + 2.0
        merged = welford_merge(welford_from_batch(a), welford_from_batch(b))
        full = np.concatenate([np.asarray(a), np.asarray(b)])
        np.testing.assert_allclose(merged.mean, full.mean(), rtol=1e-5)
        np.testing.assert_allclose(merged.variance, full.var(ddof=1), rtol=1e-4)
        mean, stderr, n = welford_mean_stderr(merged)
        assert n == 1000

    def test_merge_associative(self, key):
        ks = jax.random.split(key, 3)
        sts = [welford_from_batch(jax.random.normal(k, (100,)) * (i + 1))
               for i, k in enumerate(ks)]
        left = welford_merge(welford_merge(sts[0], sts[1]), sts[2])
        right = welford_merge(sts[0], welford_merge(sts[1], sts[2]))
        np.testing.assert_allclose(left.mean, right.mean, rtol=1e-5)
        np.testing.assert_allclose(left.m2, right.m2, rtol=1e-4)

    def test_empty_identity(self, key):
        x = jax.random.normal(key, (100,))
        st = welford_from_batch(x)
        merged = welford_merge(welford_empty(), st)
        np.testing.assert_allclose(merged.mean, st.mean, rtol=1e-6)
        np.testing.assert_allclose(merged.m2, st.m2, rtol=1e-6)

    def test_psum_across_mesh_equals_global(self, key, devices8):
        from jax import shard_map
        from jax.sharding import Mesh, PartitionSpec as P

        from options_model_tpu.core.stats import welford_psum

        x = jax.random.normal(key, (8 * 256,))
        mesh = Mesh(np.array(devices8), ("paths",))

        def shard_stats(xs):
            local = welford_from_batch(xs)
            return welford_psum(local, "paths")

        st = jax.jit(shard_map(shard_stats, mesh=mesh, in_specs=P("paths"),
                               out_specs=P()))(x)
        np.testing.assert_allclose(st.mean, np.asarray(x).mean(), rtol=1e-5)
        np.testing.assert_allclose(st.variance, np.asarray(x).var(ddof=1), rtol=1e-4)


class TestTimeGrid:
    def test_adaptive_steps_clamp(self):
        assert adaptive_num_steps(0.5) == 10
        assert adaptive_num_steps(50.0) == 50
        assert adaptive_num_steps(500.0) == 130
        assert adaptive_num_steps(3.0, lo=2, hi=500) == 3

    def test_curve_day_grid(self):
        grid = curve_day_grid(total_points=8, intervals_per_day=4)
        assert len(grid) == 8
        np.testing.assert_allclose(grid[0], 2.0)   # farthest point: 8/4 days
        np.testing.assert_allclose(grid[-1], 0.25)  # nearest: 1/4 day
        assert np.all(np.diff(grid) < 0)

    def test_trading_hours_full_week(self):
        # Monday 08:00 -> Friday: 5 full sessions of 6.5h.
        now = datetime.datetime(2026, 8, 10, 8, 0)   # Monday pre-open
        expiry = datetime.date(2026, 8, 14)           # Friday
        hours = compute_trading_hours_remaining(expiry, now=now)
        np.testing.assert_allclose(hours, 5 * 6.5)

    def test_trading_hours_partial_today(self):
        now = datetime.datetime(2026, 8, 10, 13, 0)  # Monday 13:00
        expiry = datetime.date(2026, 8, 10)
        hours = compute_trading_hours_remaining(expiry, now=now)
        np.testing.assert_allclose(hours, 3.0)       # 13:00 -> 16:00

    def test_trading_hours_past_expiry(self):
        now = datetime.datetime(2026, 8, 10, 8, 0)
        assert compute_trading_hours_remaining(datetime.date(2026, 8, 7), now=now) == 0.0


class TestDataLayerGating:
    def test_yfinance_gate(self):
        from options_model_tpu.data import market

        if not market.yfinance_available():
            # offline container: live adapters must fail loudly and legibly
            import pytest as _pytest
            with _pytest.raises(market.MarketDataError):
                market.fetch_live_quote("AAPL")
            with _pytest.raises(market.MarketDataError):
                market.fetch_option_chain("AAPL")
        else:  # networked environment: just confirm the flag is consistent
            assert callable(market.fetch_live_quote)

    def test_synthetic_oracles_never_need_network(self):
        from options_model_tpu.data.synthetic import synthetic_smile_surface

        K, T, iv, S0 = synthetic_smile_surface()
        assert len(K) == len(T) == len(iv) == 120
        assert S0 == 100.0


class TestCompilationCache:
    def test_enable_writes_cache_entries(self, tmp_path, key, monkeypatch):
        """enable_compilation_cache persists compiled programs to disk so
        first compiles amortize across processes."""
        import jax
        import jax.numpy as jnp
        from options_model_tpu.ops.engine import enable_compilation_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)

        cache = str(tmp_path / "jit_cache")
        # conftest globally disables the persistent cache for hermeticity;
        # this test is ABOUT the cache, so re-enable it for its scope.
        try:
            jax.config.update("jax_enable_compilation_cache", True)
        except Exception:
            pass
        enable_compilation_cache(cache, min_compile_time_secs=0.0)
        # jax memoizes the cache object at the first compile of the process;
        # tests running earlier in the suite may have pinned a no-cache state.
        try:
            from jax._src import compilation_cache as _cc
            _cc.reset_cache()
        except Exception:
            pass
        try:
            @jax.jit
            def f(x):
                return jnp.sin(x) * jnp.cos(x) + jnp.tanh(x) ** 3

            float(f(jnp.float32(0.3)))
            import os
            entries = []
            for root, _, files in os.walk(cache):
                entries.extend(files)
            assert entries, "no cache entries written"
        finally:
            jax.config.update("jax_compilation_cache_dir", None)
            try:
                jax.config.update("jax_enable_compilation_cache", False)
            except Exception:
                pass

    def test_enable_is_idempotent(self, tmp_path, monkeypatch):
        from options_model_tpu.ops.engine import enable_compilation_cache
        import jax
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        enable_compilation_cache(str(tmp_path / "a"))
        enable_compilation_cache(str(tmp_path / "a"))
        jax.config.update("jax_compilation_cache_dir", None)

    def test_env_dir_takes_precedence(self, tmp_path, monkeypatch):
        """JAX_COMPILATION_CACHE_DIR, when set, is the cache directory; no
        other directory is set in code."""
        import jax
        from options_model_tpu.ops.engine import enable_compilation_cache
        env_dir = str(tmp_path / "from_env")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        try:
            assert enable_compilation_cache(str(tmp_path / "arg")) == env_dir
            assert enable_compilation_cache() == env_dir
            assert jax.config.jax_compilation_cache_dir == env_dir
        finally:
            jax.config.update("jax_compilation_cache_dir", None)

    def test_default_dir_is_fixed_inside_checkout(self, monkeypatch):
        import pathlib
        import jax
        from options_model_tpu.ops.engine import (DEFAULT_CACHE_DIR,
                                                  enable_compilation_cache)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = pathlib.Path(__file__).resolve().parents[1]
        try:
            assert enable_compilation_cache() == str(DEFAULT_CACHE_DIR)
            assert DEFAULT_CACHE_DIR == root / ".jax_cache"
            ignored = (root / ".gitignore").read_text().splitlines()
            assert ".jax_cache/" in ignored
        finally:
            jax.config.update("jax_compilation_cache_dir", None)
