"""Multi-asset European options: basket, best-of/worst-of rainbow, spread.

Beyond-reference capability (the reference is single-asset throughout;
models/multiasset.py supplies the correlated-GBM sampler). The arithmetic
basket ships with the classic geometric-basket control variate: the geometric
average of lognormals is itself lognormal, so its price is CLOSED FORM and the
highly-correlated arithmetic payoff regresses against it with the repo's
pair-mean optimal beta (core/stats.optimal_cv_beta) — measured ~30x stderr
reduction on equal-weight baskets (tests/test_basket.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from options_model_tpu.core.stats import (
    masked_mean_stderr,
    optimal_cv_beta,
    pair_mean_reduce,
)
from options_model_tpu.models.multiasset import gbm_basket_terminal_exact

# Basket weightings contract f32 prices: pinned, so a GPU does not run them
# in TF32 (10 mantissa bits bias the weighted sum).
_HI = jax.lax.Precision.HIGHEST

_KINDS = ("basket", "best_of", "worst_of", "spread")


def geometric_basket_bs_price(S0s, weights, K, T, r, sigmas, corr, cp=1.0,
                              div_yields=None):
    """Closed-form price of a European option on the GEOMETRIC basket
    G_T = prod_i S_i^{w_i} under correlated GBM.

    log G_T is Gaussian with
      mu = sum_i w_i (log S0_i + (r - q_i - sigma_i^2/2) T)
      s2 = w' (sigma_i sigma_j rho_ij) w * T
    so the price is the Black formula at forward F = exp(mu + s2/2).
    """
    S0s = np.atleast_1d(np.asarray(S0s, np.float64))
    w = np.atleast_1d(np.asarray(weights, np.float64))
    sig = np.atleast_1d(np.asarray(sigmas, np.float64))
    q = (np.zeros_like(S0s) if div_yields is None
         else np.atleast_1d(np.asarray(div_yields, np.float64)))
    c = np.asarray(corr, np.float64)
    cov = np.outer(sig, sig) * c
    mu = float(w @ (np.log(S0s) + (r - q - 0.5 * sig**2) * T))
    s2 = float(w @ cov @ w) * T
    s = np.sqrt(max(s2, 1e-16))
    F = np.exp(mu + 0.5 * s2)
    from scipy.stats import norm
    d1 = (np.log(F / K) + 0.5 * s2) / s
    d2 = d1 - s
    disc = np.exp(-r * T)
    price = cp * disc * (F * norm.cdf(cp * d1) - K * norm.cdf(cp * d2))
    return float(price)


def _basket_payoff(S_T, weights, K, cp, kind):
    """(n_paths,) undiscounted payoff from terminal prices (n_assets, P)."""
    w = jnp.asarray(weights, S_T.dtype)
    if kind == "basket":
        underlying = jnp.tensordot(w, S_T, axes=1, precision=_HI)
    elif kind == "best_of":
        underlying = jnp.max(S_T, axis=0)
    elif kind == "worst_of":
        underlying = jnp.min(S_T, axis=0)
    elif kind == "spread":
        if S_T.shape[0] != 2:
            raise ValueError("spread requires exactly 2 assets")
        underlying = S_T[0] - S_T[1]
    else:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    return jnp.maximum(cp * (underlying - K), 0.0)


def price_basket_mc(key: jax.Array, S0s, weights, K, T, r, sigmas, corr,
                    cp=1.0, *, kind: str = "basket", n_paths: int = 1 << 18,
                    div_yields=None, antithetic: bool = True,
                    control_variate: bool = True, dtype=jnp.float32
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """European multi-asset option price. Returns (price, stderr).

    kind: 'basket' (weighted average), 'best_of' / 'worst_of' (rainbow on the
    extreme asset), 'spread' (S1 - S2, 2 assets). Terminal sampling is exact
    (GBM law, models/multiasset.gbm_basket_terminal_exact). For 'basket' with
    ``control_variate`` the geometric basket is priced on the SAME paths and
    recentered at its closed form with the pair-mean-optimal beta; the
    estimator stays unbiased for the arithmetic payoff (E[adj] = 0).
    Stderrs follow the antithetic pair-mean discipline (core/stats).
    """
    if kind not in _KINDS:
        raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
    n_paths = (n_paths + 1) // 2 * 2
    S_T = gbm_basket_terminal_exact(key, S0s, r, sigmas, corr, T, n_paths,
                                    div_yields=div_yields,
                                    antithetic=antithetic, dtype=dtype)
    disc = jnp.exp(-jnp.asarray(r, dtype) * jnp.asarray(T, dtype))
    cash = _basket_payoff(S_T, weights, K, cp, kind) * disc
    pb = n_paths if antithetic else None

    w = np.atleast_1d(np.asarray(weights, np.float64))
    use_cv = (control_variate and kind == "basket" and np.all(w > 0))
    if use_cv:
        # geometric leg on the same paths, centered at its closed form
        wj = jnp.asarray(w, dtype)
        geo = jnp.exp(jnp.tensordot(wj, jnp.log(S_T), axes=1,
                                    precision=_HI))
        geo_cash = jnp.maximum(cp * (geo - K), 0.0) * disc
        geo_cf = geometric_basket_bs_price(S0s, w, K, T, r, sigmas, corr,
                                           cp, div_yields)
        adj = geo_cf - geo_cash  # E[adj] = 0 under the exact terminal law
        beta = optimal_cv_beta(cash, adj, pair_block=pb)
        cash = cash + beta * adj
    mean, stderr, _ = masked_mean_stderr(cash, pair_block=pb)
    return mean, stderr
