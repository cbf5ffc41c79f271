"""Resumable Monte-Carlo pricing jobs.

The checkpoint/resume subsystem the reference lacked (SURVEY.md §5: "No
load/resume path exists anywhere... orbax checkpoints with actual restore,
plus resumable MC via saved RNG counters").

Because all randomness is keyed by GLOBAL path-block index (core/rng.py), an
interrupted streaming estimate is fully described by (seed, blocks_done,
WelfordState): resuming continues the exact stream the uninterrupted run would
have produced — the final price is bitwise identical for any interruption
pattern (tested in tests/test_resumable.py): every sampler keys its stream by
global block, so the result is independent of ``blocks_per_flush``.

Checkpoints are a small JSON file (three floats + counters), written
atomically after every flush interval.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import MCConfig, OptionSpec
from options_model_tpu.core.payoff import vanilla_payoff
from options_model_tpu.core.stats import (
    WelfordState,
    welford_from_batch,
    welford_merge,
)
from options_model_tpu.models.blocks import num_blocks


@dataclass
class MCJobState:
    seed: int
    blocks_done: int
    count: float
    mean: float
    m2: float
    # Unit of the Welford statistics: 'pair_mean' (antithetic pair means,
    # the i.i.d. unit) or 'path' (raw samples). Checkpoints written before
    # this field existed counted raw paths; merging them into a pair-mean
    # stream would silently mix incompatible units — load() refuses instead.
    stat_unit: str = "pair_mean"

    def welford(self) -> WelfordState:
        return WelfordState(count=jnp.float32(self.count),
                            mean=jnp.float32(self.mean),
                            m2=jnp.float32(self.m2))

    def save(self, path: str) -> None:
        payload = json.dumps(self.__dict__)
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            f.write(payload)
        os.replace(tmp, path)  # atomic

    @classmethod
    def load(cls, path: str, expect_unit: str = None) -> "MCJobState":
        with open(path) as f:
            d = json.load(f)
        unit = d.get("stat_unit")
        if unit is None:
            raise ValueError(
                f"checkpoint {path} predates the stat_unit field (its "
                f"Welford state counts raw paths, not antithetic pair "
                f"means) — resuming would merge incompatible statistics; "
                f"delete it and restart the job")
        if expect_unit is not None and unit != expect_unit:
            raise ValueError(
                f"checkpoint {path} accumulates '{unit}' statistics but "
                f"this run uses '{expect_unit}' (antithetic setting "
                f"changed?) — delete it or match the configuration")
        return cls(seed=int(d["seed"]), blocks_done=int(d["blocks_done"]),
                   count=float(d["count"]), mean=float(d["mean"]),
                   m2=float(d["m2"]), stat_unit=unit)


def run_resumable_european(sampler, spec: OptionSpec, T, cfg: MCConfig,
                           seed: int, checkpoint_path: str,
                           blocks_per_flush: int = 16,
                           max_blocks: Optional[int] = None
                           ) -> Tuple[float, float, int]:
    """Streaming European MC that checkpoints after every flush.

    sampler: a TerminalSampler (pricers/european.make_terminal_sampler).
    Restarting the call with the same checkpoint_path resumes from the last
    flushed block. Returns (price, stderr, n_paths).
    """
    nb_total = max_blocks if max_blocks is not None else num_blocks(cfg)
    key = jax.random.key(seed)
    stat_unit = "pair_mean" if cfg.antithetic else "path"

    if os.path.exists(checkpoint_path):
        state = MCJobState.load(checkpoint_path, expect_unit=stat_unit)
        if state.seed != seed:
            raise ValueError(
                f"checkpoint seed {state.seed} != requested seed {seed}")
    else:
        state = MCJobState(seed=seed, blocks_done=0, count=0.0, mean=0.0,
                           m2=0.0, stat_unit=stat_unit)

    chunk_cfg = cfg.replace(n_paths=blocks_per_flush * cfg.path_block)
    discount = jnp.exp(-jnp.asarray(spec.rate, cfg.dtype)
                       * jnp.asarray(T, cfg.dtype))
    # Antithetic mirror pairs are not i.i.d. — the Welford state accumulates
    # PAIR MEANS (the sampler's own mirror granularity), matching
    # price_european_mc's discipline; the reported n still counts simulated
    # paths. The checkpoint's `count` therefore counts pairs.
    pair_block = (getattr(sampler, "pair_block",
                          lambda c: c.path_block)(chunk_cfg)
                  if cfg.antithetic else None)

    @jax.jit
    def flush(first_block, st: WelfordState) -> WelfordState:
        S_T = sampler(key, first_block, chunk_cfg)
        payoffs = vanilla_payoff(S_T, spec.strike, spec.cp) * discount
        if pair_block is not None:
            from options_model_tpu.core.stats import pair_mean_reduce
            payoffs = pair_mean_reduce(payoffs, pair_block)
        return welford_merge(st, welford_from_batch(payoffs))

    st = state.welford()
    while state.blocks_done < nb_total:
        st = flush(state.blocks_done, st)
        state.blocks_done += blocks_per_flush
        state.count = float(st.count)
        state.mean = float(st.mean)
        state.m2 = float(st.m2)
        state.save(checkpoint_path)

    n_paths = int(st.count) * (2 if pair_block is not None else 1)
    return float(st.mean), float(st.stderr), n_paths
