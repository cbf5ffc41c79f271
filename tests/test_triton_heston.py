"""The fused Heston Euler terminal kernel (ops/triton_heston.py).

Off the card the kernel runs through the Pallas interpreter, which executes
the same arithmetic: its stream must reproduce the XLA engine's normals and
S_T. The ``gpu`` tests compile it for the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from options_model_tpu.core.config import (
    CALL, BatesParams, HestonParams, MCConfig, OptionSpec)
from options_model_tpu.models.heston import simulate_heston
from options_model_tpu.ops import triton_heston as th
from options_model_tpu.ops.engine import resolve_engine
from options_model_tpu.pricers.european import (make_terminal_sampler,
                                                price_european_mc)

HP = HestonParams(kappa=2.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04)
S0, R, T = 100.0, 0.05, 1.0


def _key_words(key):
    kd = jax.random.key_data(key)
    return kd[0], kd[1]


class TestRandomStream:
    @pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
    def test_threefry_bits_match_jax(self, seed):
        key = jax.random.key(seed)
        idx = jnp.arange(300, dtype=jnp.uint32)
        y0, y1 = th.threefry2x32(*_key_words(key), jnp.zeros_like(idx), idx)
        want = jax.random.bits(key, (300,), jnp.uint32)
        np.testing.assert_array_equal(np.asarray(y0 ^ y1), np.asarray(want))

    def test_fold_in_matches_jax(self):
        key = jax.random.key(3)
        for d in (0, 1, 17, 2**32 - 1):
            got = th.fold_in(*_key_words(key), jnp.uint32(d))
            want = jax.random.key_data(jax.random.fold_in(key, d))
            np.testing.assert_array_equal(np.asarray(jnp.stack(got)),
                                          np.asarray(want))

    def test_normals_match_jax(self):
        key = jax.random.key(11)
        idx = jnp.arange(4096, dtype=jnp.uint32)
        y0, y1 = th.threefry2x32(*_key_words(key), jnp.zeros_like(idx), idx)
        want = jax.random.normal(key, (4096,), jnp.float32)
        np.testing.assert_array_equal(np.asarray(th.normal_from_bits(y0 ^ y1)),
                                      np.asarray(want))


class TestInterpretedKernel:
    @pytest.mark.parametrize("antithetic", [True, False])
    @pytest.mark.parametrize("first_block", [0, 5])
    def test_matches_simulate_heston(self, key, antithetic, first_block):
        cfg = MCConfig(n_paths=2 * 512, n_steps=5, path_block=512,
                       antithetic=antithetic)
        got = th.heston_terminal_triton(key, S0, R, T, HP, cfg,
                                        first_block=first_block,
                                        interpret=True)
        want = simulate_heston(key, S0, R, T, HP, cfg, return_paths=False,
                               first_block=first_block)
        assert got.shape == want.shape == (1024,)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-6)

    @pytest.mark.parametrize("n_paths,path_block", [(1000, 256), (3 * 768, 768)])
    def test_odd_path_counts_round_like_xla(self, key, n_paths, path_block):
        cfg = MCConfig(n_paths=n_paths, n_steps=3, path_block=path_block)
        got = th.heston_terminal_triton(key, S0, R, T, HP, cfg, interpret=True)
        want = simulate_heston(key, S0, R, T, HP, cfg, return_paths=False)
        assert got.shape == want.shape
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-6)

    def test_chunked_european_equals_xla(self, key):
        # two chunks: the kernel receives each chunk's global first block
        cfg = MCConfig(n_paths=4 * 256, n_steps=4, path_block=256)
        spec = OptionSpec(strike=100.0, rate=R, cp=CALL)
        out = {}
        for eng in ("triton", "xla"):
            sampler = make_terminal_sampler("heston", S0, R, T, heston=HP,
                                            engine=eng, interpret=True)
            out[eng] = price_european_mc(key, sampler, spec, T, cfg,
                                         max_paths_per_chunk=512)
        np.testing.assert_allclose(float(out["triton"][0]),
                                   float(out["xla"][0]), rtol=1e-5)
        assert float(out["triton"][2]) == float(out["xla"][2])

    def test_bates_composes_with_kernel(self, key):
        bp = BatesParams(heston=HP, lam=0.5, mu_j=-0.1, sigma_j=0.2)
        cfg = MCConfig(n_paths=512, n_steps=4, path_block=256)
        got = make_terminal_sampler("bates", S0, R, T, bates=bp,
                                    engine="triton", interpret=True)(key, 2, cfg)
        want = make_terminal_sampler("bates", S0, R, T, bates=bp,
                                     engine="xla")(key, 2, cfg)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-6)


class TestGuards:
    def test_refuses_cpu_without_interpret(self, key):
        cfg = MCConfig(n_paths=512, n_steps=2, path_block=256)
        with pytest.raises(ValueError, match="interpret"):
            th.heston_terminal_triton(key, S0, R, T, HP, cfg)

    def test_explicit_triton_sampler_refuses_cpu(self, key):
        cfg = MCConfig(n_paths=512, n_steps=2, path_block=256)
        sampler = make_terminal_sampler("heston", S0, R, T, heston=HP,
                                        engine="triton")
        with pytest.raises(ValueError, match="interpret"):
            sampler(key, 0, cfg)

    def test_unsupported_streams(self, key):
        cfg = MCConfig(n_paths=512, n_steps=2, path_block=256)
        assert th.heston_terminal_supported(key, cfg)
        assert not th.heston_terminal_supported(jax.random.PRNGKey(0), cfg)
        assert not th.heston_terminal_supported(key,
                                                cfg.replace(dtype=jnp.float64))

    @pytest.mark.parametrize("n,block", [(128, 128), (384, 128), (2048, 512),
                                         (1536, 512), (640, 128)])
    def test_block_size(self, n, block):
        assert th._block_size(n) == block


class TestEngineResolution:
    @pytest.mark.parametrize("engine,want", [("xla", "xla"),
                                             ("triton", "triton"),
                                             ("auto", "xla")])
    def test_resolve_on_cpu(self, engine, want):
        assert resolve_engine(engine) == want

    @pytest.mark.parametrize("engine", ["pallas", "pallas-interpret", "gpu"])
    def test_rejects_unknown(self, engine):
        with pytest.raises(ValueError):
            resolve_engine(engine)

    def test_auto_sampler_is_xla_on_cpu(self, key):
        cfg = MCConfig(n_paths=512, n_steps=3, path_block=256)
        got = make_terminal_sampler("heston", S0, R, T, heston=HP)(key, 0, cfg)
        want = simulate_heston(key, S0, R, T, HP, cfg, return_paths=False)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.gpu
class TestOnGpu:
    def test_auto_resolves_to_triton(self):
        assert resolve_engine("auto") == "triton"

    @pytest.mark.parametrize("antithetic", [True, False])
    def test_compiled_kernel_matches_xla(self, key, antithetic):
        cfg = MCConfig(n_paths=1 << 20, n_steps=50, path_block=4096,
                       antithetic=antithetic)
        got = th.heston_terminal_triton(key, S0, R, T, HP, cfg, first_block=3)
        want = simulate_heston(key, S0, R, T, HP, cfg, return_paths=False,
                               first_block=3)
        rel = np.max(np.abs(np.asarray(got) / np.asarray(want) - 1.0))
        assert rel <= 1e-4, rel

    def test_bates_sampler_on_gpu(self, key):
        bp = BatesParams(heston=HP, lam=0.5, mu_j=-0.1, sigma_j=0.2)
        cfg = MCConfig(n_paths=1 << 18, n_steps=20, path_block=4096)
        got = make_terminal_sampler("bates", S0, R, T, bates=bp)(key, 0, cfg)
        want = make_terminal_sampler("bates", S0, R, T, bates=bp,
                                     engine="xla")(key, 0, cfg)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4)
