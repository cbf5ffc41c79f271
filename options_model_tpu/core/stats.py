"""Streaming statistics: Welford/Chan mean-variance as an associative pytree monoid.

Device-side rebuild of the reference's host-loop ``welford_batch_update``
(options_model_3/options_model_3.py:33-49). The merge is Chan's parallel update,
which is associative — so the same state type works for:

- sequential chunk streaming (``lax.scan`` over path blocks),
- tree reduction within a device,
- cross-device reduction (``welford_psum`` inside ``shard_map``) — the collective
  form of the reference's as_completed result-aggregation loop
  (options_model_3/options_model_3.py:1055-1056).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from options_model_tpu.core.pytree import pytree_dataclass


@pytree_dataclass
class WelfordState:
    count: jnp.ndarray  # float for exact psum merging
    mean: jnp.ndarray
    m2: jnp.ndarray

    @property
    def variance(self):
        return jnp.where(self.count > 1, self.m2 / jnp.maximum(self.count - 1, 1), 0.0)

    @property
    def stderr(self):
        return jnp.sqrt(self.variance / jnp.maximum(self.count, 1))


def welford_empty(dtype=jnp.float32) -> WelfordState:
    z = jnp.zeros((), dtype)
    return WelfordState(count=z, mean=z, m2=z)


def welford_from_batch(x: jnp.ndarray) -> WelfordState:
    """State summarizing one batch (vectorized, no per-element loop)."""
    x = x.reshape(-1)
    n = jnp.asarray(x.size, x.dtype)
    mean = jnp.mean(x)
    m2 = jnp.sum((x - mean) ** 2)
    return WelfordState(count=n, mean=mean, m2=m2)


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Chan's parallel combine; exact and associative."""
    n = a.count + b.count
    safe_n = jnp.maximum(n, 1.0)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe_n)
    m2 = a.m2 + b.m2 + delta**2 * (a.count * b.count / safe_n)
    return WelfordState(count=n, mean=mean, m2=m2)


def welford_psum(local: WelfordState, axis_name: str) -> WelfordState:
    """Merge per-shard partial states across a mesh axis with psum collectives.

    Algebraically identical to folding ``welford_merge`` over all shards:
      N     = sum n_i
      mean  = sum(n_i mean_i) / N
      M2    = sum(m2_i) + sum(n_i mean_i^2) - N mean^2
    """
    n = jax.lax.psum(local.count, axis_name)
    s1 = jax.lax.psum(local.count * local.mean, axis_name)
    s2 = jax.lax.psum(local.count * local.mean**2, axis_name)
    m2p = jax.lax.psum(local.m2, axis_name)
    safe_n = jnp.maximum(n, 1.0)
    mean = s1 / safe_n
    m2 = m2p + s2 - safe_n * mean**2
    return WelfordState(count=n, mean=mean, m2=m2)


def welford_mean_stderr(state: WelfordState):
    """(mean, stderr, n) triple matching monte_carlo_price_streaming's return
    (options_model_3/options_model_3.py:61-63)."""
    return state.mean, state.stderr, state.count


def pair_mean_reduce(x: jnp.ndarray, pair_block: int) -> jnp.ndarray:
    """Average antithetic mirror pairs.

    x: (n,) laid out in consecutive chunks of ``pair_block`` whose second half
    mirrors the first (+Z / -Z — the simulators' and kernels' layout). Returns
    (n/2,) pair means. Antithetic samples are NOT i.i.d.: treating the n
    correlated samples as independent misstates the stderr (overstates it for
    monotone payoffs, can understate it for non-monotone ones); pair means ARE
    i.i.d., so statistics over them are correct.
    """
    n = x.shape[0]
    xb = x.reshape(n // pair_block, 2, pair_block // 2)
    return jnp.mean(xb, axis=1).reshape(-1)


def masked_mean_stderr(x: jnp.ndarray, mask: jnp.ndarray = None,
                       axis_name: str = None, pair_block: int = None):
    """(mean, stderr, n_effective) of masked samples, optionally pair-reduced.

    ``pair_block`` (the antithetic mirror granularity) triggers the pair-mean
    correction above; masks must be constant across each pair (true for the
    whole-block OOS masks). ``axis_name`` makes all reductions psum-exact
    across a mesh axis.
    """
    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    if mask is None:
        mask = jnp.ones_like(x)
    if pair_block is not None:
        x = pair_mean_reduce(x, pair_block)
        mask = pair_mean_reduce(mask, pair_block)  # pair-constant: stays 0/1
    n = jnp.maximum(allsum(mask.sum()), 1.0)
    mean = allsum((x * mask).sum()) / n
    var = allsum(((x - mean) ** 2 * mask).sum()) / n
    return mean, jnp.sqrt(var / n), n


def optimal_cv_beta(cash: jnp.ndarray, adj: jnp.ndarray,
                    mask: jnp.ndarray = None, axis_name: str = None,
                    pair_block: int = None) -> jnp.ndarray:
    """Variance-minimizing control-variate coefficient for cash + beta*adj:
    beta* = -Cov(cash, adj) / Var(adj).

    Computed at the SAME granularity the reported stderr uses — antithetic
    PAIR MEANS: under antithetic sampling the monotone component of both the
    stopped cashflow and the European leg cancels within pairs, so the
    raw-sample covariance systematically overstates the useful correlation.
    That is exactly why the reference's beta=1 (options_model_3/
    options_model_3.py:653-677) is a wash on ATM puts against the pair-mean
    plain estimator (measured: CV stderr 0.0165 vs plain 0.0130 at 2^16
    paths) — the pair-mean beta* is ~0.3-0.5 there, not 1.

    The estimator stays unbiased for any FIXED beta since E[adj] = 0;
    estimating beta from the same samples adds O(1/n) bias, negligible at MC
    scale (Glasserman, Monte Carlo Methods in Financial Engineering, §4.1.3).
    ``axis_name`` makes the moments psum-exact across a mesh axis (the beta
    every shard applies is then the GLOBAL one — sharding-invariant)."""
    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    if mask is None:
        mask = jnp.ones_like(cash)
    if pair_block is not None:
        cash = pair_mean_reduce(cash, pair_block)
        adj = pair_mean_reduce(adj, pair_block)
        mask = pair_mean_reduce(mask, pair_block)
    n = jnp.maximum(allsum(mask.sum()), 1.0)
    mc = allsum((cash * mask).sum()) / n
    ma = allsum((adj * mask).sum()) / n
    cov = allsum(((cash - mc) * (adj - ma) * mask).sum()) / n
    var = allsum(((adj - ma) ** 2 * mask).sum()) / n
    return -cov / jnp.maximum(var, jnp.asarray(1e-12, var.dtype))


def cashflow_statistics(cash: jnp.ndarray, mask: jnp.ndarray = None) -> dict:
    """Distribution statistics of the per-path discounted cashflows — the
    reference's verbose pricing report (options_model_2.py:316-333): mean,
    std dev, min, max, and P(option expires worthless). ``mask``: 0/1 path
    weights (e.g. the out-of-sample eval mask); statistics are over the
    masked paths. jit-friendly (returns scalar jnp arrays)."""
    if mask is None:
        mask = jnp.ones_like(cash)
    n = jnp.maximum(mask.sum(), 1.0)
    mean = (cash * mask).sum() / n
    var = (((cash - mean) ** 2) * mask).sum() / jnp.maximum(n - 1.0, 1.0)
    big = jnp.asarray(jnp.finfo(cash.dtype).max, cash.dtype)
    return {
        "mean": mean,
        "std": jnp.sqrt(var),
        "min": jnp.min(jnp.where(mask > 0, cash, big)),
        "max": jnp.max(jnp.where(mask > 0, cash, -big)),
        "p_worthless": ((cash == 0.0) * mask).sum() / n,
        "n": n,
    }
