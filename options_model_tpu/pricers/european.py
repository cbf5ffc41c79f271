"""European Monte-Carlo pricing with streaming Welford statistics.

Rebuilds price_european_streaming / monte_carlo_price_streaming
(options_model_3/options_model_3.py:382-437, :51-63): terminal-only
simulation (no path matrix is ever materialized), chunked over path blocks
with a ``lax.fori_loop`` carrying a Welford state — the whole stream compiles
to one XLA program with O(chunk) memory, and the same Welford state psums
across shards (parallel/batch.py).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu.core.payoff import vanilla_payoff
from options_model_tpu.core.stats import (
    WelfordState,
    pair_mean_reduce,
    welford_empty,
    welford_from_batch,
    welford_merge,
)
from options_model_tpu.models.blocks import num_blocks
from options_model_tpu.models.gbm import gbm_terminal_exact, simulate_gbm
from options_model_tpu.models.heston import simulate_heston
from options_model_tpu.models.localvol import simulate_local_vol
from options_model_tpu.ops.triton_heston import (heston_terminal_supported,
                                                 heston_terminal_triton)

# terminal_sampler(key, first_block, chunk_cfg) -> S_T (chunk_paths,)
TerminalSampler = Callable[[jax.Array, jnp.ndarray, MCConfig], jnp.ndarray]


def make_terminal_sampler(model: str, S0, r, T, *, sigma=None,
                          heston: Optional[HestonParams] = None,
                          merton=None, bates=None, vg=None, sabr=None,
                          rbergomi=None,
                          sigma_fn=None, engine: str = "auto",
                          heston_scheme: str = "euler",
                          localvol_table=None, div_yield=0.0,
                          interpret: bool = False) -> TerminalSampler:
    """Terminal-price sampler for one dynamics family.

    Every sampler keys its stream by GLOBAL block index (first_block + local
    block), so chunked and path-sharded runs reproduce the unchunked stream.
    localvol runs the exact surface network inside the XLA scan, or the
    compiled Chebyshev ``localvol_table`` (surface/cheb.compile_localvol_table)
    through the same scan when one is supplied.

    ``engine``: 'triton' (or 'auto' on a GPU) samples the Heston/Bates Euler
    terminal state with the fused GPU kernel (ops/triton_heston.py), which
    draws the XLA sampler's own normals; every other case samples through
    XLA. ``interpret=True`` runs that kernel through the Pallas interpreter,
    the only way to run it off the GPU.

    ``div_yield``: continuous dividend yield q — the sampler's drift is
    (r - q); the pricer still discounts payoffs at ``r``.
    """
    from options_model_tpu.ops.engine import resolve_engine
    r = r - div_yield  # simulators are q-agnostic: their r IS the drift
    eng = resolve_engine(engine)
    if model == "bates":
        # Heston terminal sampler x the independent terminal jump factor
        # (models/bates.py), both keyed by global block.
        if bates is None:
            raise ValueError("bates params required for model='bates'")
        from options_model_tpu.models.bates import jump_overlay, split_bates_keys
        base = make_terminal_sampler("heston", S0, r, T, heston=bates.heston,
                                     engine=engine, heston_scheme=heston_scheme,
                                     interpret=interpret)

        def fn(key, fb, c):
            kh, kj = split_bates_keys(key)
            return base(kh, fb, c) * jump_overlay(
                kj, T, bates.lam, bates.mu_j, bates.sigma_j, c,
                return_paths=False, first_block=fb)
        return fn
    if model == "localvol" and localvol_table is not None and sigma_fn is None:
        from options_model_tpu.surface.cheb import table_sigma_fn
        sigma_fn = table_sigma_fn(localvol_table, T)
    if model == "gbm":
        if sigma is None:
            raise ValueError("sigma is required for model='gbm'")
        fn = lambda key, fb, c: simulate_gbm(key, S0, r, sigma, T, c,
                                             return_paths=False, first_block=fb)
    elif model == "heston":
        if heston is None:
            raise ValueError("heston params required for model='heston'")
        use_kernel = eng == "triton" and heston_scheme == "euler"

        def fn(key, fb, c):
            if use_kernel and (engine == "triton"
                               or heston_terminal_supported(key, c)):
                return heston_terminal_triton(key, S0, r, T, heston, c,
                                              first_block=fb,
                                              interpret=interpret)
            return simulate_heston(key, S0, r, T, heston, c,
                                   return_paths=False, first_block=fb,
                                   scheme=heston_scheme)
    elif model == "localvol":
        if sigma_fn is None:
            raise ValueError("sigma_fn required for model='localvol'")
        fn = lambda key, fb, c: simulate_local_vol(key, S0, r, T, sigma_fn, c,
                                                   return_paths=False, first_block=fb)
    elif model == "merton":
        if merton is None:
            raise ValueError("merton params required for model='merton'")
        from options_model_tpu.models.merton import simulate_merton
        fn = lambda key, fb, c: simulate_merton(key, S0, r, T, merton, c,
                                                return_paths=False,
                                                first_block=fb)
    elif model == "vg":
        if vg is None:
            raise ValueError("vg params required for model='vg'")
        # One-step EXACT terminal law (models/vg.py): n_steps is irrelevant
        # for European payoffs under VG — the gamma clock composes.
        from options_model_tpu.models.vg import vg_terminal_exact
        fn = lambda key, fb, c: vg_terminal_exact(key, S0, r, T, vg, c,
                                                  first_block=fb)
    elif model == "sabr":
        if sabr is None:
            raise ValueError("sabr params required for model='sabr'")
        # SABR models the T-forward (martingale); at expiry S_T = F_T, so
        # the terminal sampler is the forward simulator started at
        # F_0 = S0 e^{drift T} (models/sabr.py; drift = r here, net of q).
        from options_model_tpu.models.sabr import simulate_sabr

        def fn(key, fb, c):
            F0 = jnp.asarray(S0, c.dtype) * jnp.exp(
                jnp.asarray(r, c.dtype) * jnp.asarray(T, c.dtype))
            return simulate_sabr(key, F0, T, sabr, c, first_block=fb)
    elif model == "rbergomi":
        if rbergomi is None:
            raise ValueError("rbergomi params required for model='rbergomi'")
        # Rough Bergomi spot dynamics (models/rbergomi.py) — the Volterra
        # convolution runs per chunk with the same global-block RNG contract
        # as every XLA sampler.
        from options_model_tpu.models.rbergomi import simulate_rbergomi
        fn = lambda key, fb, c: simulate_rbergomi(key, S0, T, rbergomi, c,
                                                  rate=r, first_block=fb)
    else:
        raise ValueError(f"unknown model {model!r}")
    return fn


def price_european_mc(
    key: jax.Array,
    sampler: TerminalSampler,
    spec: OptionSpec,
    T,
    cfg: MCConfig,
    max_paths_per_chunk: int = 1 << 21,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Price a European option by streaming chunks of terminal samples.

    Returns (price, stderr, n_paths) — the contract of the reference's
    monte_carlo_price_streaming. Chunking only bounds memory: the price is
    independent of the chunk size (every sampler keys its RNG by global block
    id). The stderr accounts for antithetic pairing (pair means are the
    i.i.d. unit, core/stats.pair_mean_reduce).
    """
    nb_total = num_blocks(cfg)
    blocks_per_chunk = max(1, min(nb_total, max_paths_per_chunk // cfg.path_block))
    n_chunks = math.ceil(nb_total / blocks_per_chunk)
    # Round the workload up to whole chunks (static shapes; a few extra paths
    # only tighten the estimate).
    chunk_cfg = cfg.replace(n_paths=blocks_per_chunk * cfg.path_block)

    discount = jnp.exp(-jnp.asarray(spec.rate, cfg.dtype) * jnp.asarray(T, cfg.dtype))

    pair_block = cfg.path_block if cfg.antithetic else None

    def body(c, state: WelfordState) -> WelfordState:
        first = c * blocks_per_chunk
        S_T = sampler(key, first, chunk_cfg)
        payoffs = vanilla_payoff(S_T, spec.strike, spec.cp) * discount
        if pair_block is not None:
            payoffs = pair_mean_reduce(payoffs, pair_block)
        return welford_merge(state, welford_from_batch(payoffs))

    state = jax.lax.fori_loop(0, n_chunks, body, welford_empty(cfg.dtype))
    # count reports simulated paths (pairs count double under the reduction)
    n = state.count * (2.0 if pair_block is not None else 1.0)
    return state.mean, state.stderr, n


def price_european_gbm_exact(key: jax.Array, S0, spec: OptionSpec, T,
                             n_paths: int = 1 << 20, antithetic: bool = True,
                             dtype=jnp.float32):
    """One-draw exact-terminal GBM European price (models/gbm.gbm_terminal_exact):
    the statistically optimal European MC under constant vol."""
    S_T = gbm_terminal_exact(key, S0, spec.rate - spec.div_yield, spec.sigma,
                             T, n_paths, antithetic, dtype)
    payoffs = vanilla_payoff(S_T, spec.strike, spec.cp) * jnp.exp(-spec.rate * jnp.asarray(T, dtype))
    if antithetic:
        # mirror layout of gbm_terminal_exact: (i, i + n/2)
        payoffs = pair_mean_reduce(payoffs, n_paths)
    st = welford_from_batch(payoffs)
    n = st.count * (2.0 if antithetic else 1.0)
    return st.mean, st.stderr, n
