"""Bermudan/American multi-asset options via LSM on correlated GBM paths.

Beyond-reference capability (the reference's American pricer is single-asset,
options_model_3/options_model_3.py:482-560): Longstaff-Schwartz backward
induction over the joint state of n correlated assets. The regression basis
works on the ORDER STATISTICS of the moneyness vector (sorted prices are the
natural symmetric coordinates for max-/min-payoffs) plus the payoff's own
intrinsic hinge, each smooth column masked-centered before powers —
the same Gram-conditioning rule the single-asset LSM depends on
(pricers/american.build_centered_basis's numerics note).

Validated against the Andersen & Broadie (2004) 2-asset symmetric Bermudan
max-call benchmark (S0 90/100/110, K=100, r=5%, q=10%, sigma=20%, rho=0,
T=3y, 9 exercise dates -> 8.075 / 13.902 / 21.345): in-sample LSM lands
within a few tenths of a percent (low-biased), tests/test_basket_american.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from options_model_tpu.core.config import MCConfig
from options_model_tpu.core.stats import masked_mean_stderr
from options_model_tpu.models.multiasset import simulate_gbm_basket
from options_model_tpu.pricers.american import oos_masks
from options_model_tpu.pricers.regressors import masked_wls_predict_centered

_HI = jax.lax.Precision.HIGHEST  # basket weightings: no TF32 on a GPU

_KINDS = ("max", "min", "basket")


def _payoff_t(S_t: jnp.ndarray, K, cp, kind: str, w) -> jnp.ndarray:
    """(P,) intrinsic value from the joint state S_t (n_assets, P)."""
    if kind == "max":
        underlying = jnp.max(S_t, axis=0)
    elif kind == "min":
        underlying = jnp.min(S_t, axis=0)
    else:
        underlying = jnp.tensordot(w, S_t, axes=1, precision=_HI)
    return jnp.maximum(cp * (underlying - K), 0.0)


def build_basket_basis(S_t: jnp.ndarray, K, itm: jnp.ndarray, allsum,
                       kind: str, w, cp=1.0) -> jnp.ndarray:
    """(P, d) regression design for the multi-asset continuation value.

    Columns: intercept; masked-centered sorted moneyness u_(1) >= ... >= u_(n)
    (order statistics make the basis permutation-symmetric — the value
    function of max/min payoffs is symmetric in the assets); the full
    quadratic in the u's (squares + ALL pairwise cross terms — the max-call
    boundary depends on the gap between the leaders); and the uncentered
    intrinsic hinge (payoff/K), the kink feature the single-asset basis
    carries as (x-1)^+ (pricers/american.build_centered_basis), oriented
    by cp so it is non-degenerate on the ITM region.

    Deliberately NO separate basket-value column: the basket is a weighted
    SUM of the assets, and the sum of the sorted values equals the plain sum,
    so such a column is exactly collinear with span{u_(i)} — it made the Gram
    singular and the fitted policy garbage (observed: an American basket put
    priced ~10% BELOW its European counterpart before this was removed).
    """
    x = jnp.sort(S_t / K, axis=0)[::-1]  # (n_assets, P), descending

    def centered(col):
        wsum = jnp.maximum(allsum(itm.sum()), 1.0)
        m = allsum((col * itm).sum()) / wsum
        var = allsum(((col - m) ** 2 * itm).sum()) / wsum
        return (col - m) * jax.lax.rsqrt(jnp.maximum(var, 1e-12))

    us = [centered(x[i]) for i in range(x.shape[0])]
    cols = [jnp.ones_like(us[0])]
    cols += us
    cols += [u * u for u in us]
    n = len(us)
    cols += [us[i] * us[j] for i in range(n) for j in range(i + 1, n)]
    if kind == "max":
        underlying = jnp.max(S_t, axis=0)
    elif kind == "min":
        underlying = jnp.min(S_t, axis=0)
    else:
        underlying = jnp.tensordot(w, S_t, axes=1, precision=_HI)
    cols.append(jnp.maximum(cp * (underlying / K - 1.0), 0.0))
    return jnp.stack(cols, axis=-1)


def lsm_basket_backward(S_paths: jnp.ndarray, K, r, T, cp, *,
                        kind: str = "max", weights=None,
                        out_of_sample: bool = False,
                        pair_block: Optional[int] = None,
                        stat_pair_block: Optional[int] = None,
                        axis_name: Optional[str] = None):
    """LSM backward induction on joint paths S_paths (n_steps+1, n_assets, P).

    Every simulation date is an exercise date (a Bermudan on the grid — the
    same contract the single-asset LSM prices, pricers/american.py). Returns
    (price, stderr) with the repo's pair-mean stderr discipline.
    """
    n_steps = S_paths.shape[0] - 1
    dtype = S_paths.dtype
    dt = jnp.asarray(T, dtype) / n_steps
    disc = jnp.exp(-jnp.asarray(r, dtype) * dt)
    wvec = (None if weights is None
            else jnp.atleast_1d(jnp.asarray(weights, dtype)))
    if kind == "basket" and wvec is None:
        raise ValueError("kind='basket' requires weights")

    cash = _payoff_t(S_paths[-1], K, cp, kind, wvec)
    n_paths = cash.shape[0]
    if out_of_sample:
        if pair_block is None:
            raise ValueError("out_of_sample=True requires pair_block")
        train_mask, eval_mask = oos_masks(n_paths, pair_block, dtype)
    else:
        train_mask = eval_mask = jnp.ones((n_paths,), dtype)

    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    def step(cash, t):
        cash = cash * disc
        S_t = S_paths[t]
        immediate = _payoff_t(S_t, K, cp, kind, wvec)
        itm = (immediate > 0).astype(dtype) * train_mask
        X = build_basket_basis(S_t, K, itm, allsum, kind, wvec, cp)
        continuation = masked_wls_predict_centered(X, cash, itm,
                                                   axis_name=axis_name)
        exercise = (immediate > continuation) & (immediate > 0)
        return jnp.where(exercise, immediate, cash), None

    cash, _ = jax.lax.scan(step, cash, jnp.arange(n_steps - 1, 0, -1))
    cash = cash * disc
    price, stderr, _ = masked_mean_stderr(cash, eval_mask, axis_name,
                                          stat_pair_block)
    return price, stderr


def price_american_basket(key: jax.Array, S0s, K, T, r, sigmas, corr,
                          cp=1.0, mc: Optional[MCConfig] = None, *,
                          kind: str = "max", weights=None, div_yields=None,
                          out_of_sample: bool = False
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bermudan multi-asset option on the simulation grid. Returns
    (price, stderr).

    kind: 'max' / 'min' (rainbow on the extreme asset) or 'basket' (weighted
    average, requires ``weights``). ``mc.n_steps`` IS the number of exercise
    dates (GBM transitions are exact over any step, so a 9-date Bermudan is
    priced with n_steps=9). ``out_of_sample`` gives the classic low-biased
    estimator (policy fitted on alternating antithetic-safe path blocks,
    priced on the rest).
    """
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    mc = mc if mc is not None else MCConfig(n_paths=1 << 17, n_steps=9,
                                            path_block=4096)
    S = simulate_gbm_basket(key, S0s, r, sigmas, corr, T, mc,
                            div_yields=div_yields, return_paths=True)
    pb = mc.path_block if mc.antithetic else None
    return lsm_basket_backward(
        S, K, r, T, cp, kind=kind, weights=weights,
        out_of_sample=out_of_sample, pair_block=mc.path_block,
        stat_pair_block=pb)
