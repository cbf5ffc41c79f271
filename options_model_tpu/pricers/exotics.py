"""Path-dependent exotics beyond barriers: Asian and lookback options.

Completes the exotic family the reference only gestured at
(ExoticOptionPricer, options_model_2.py:61-66). Both payoffs are running
statistics over the path — they stream through the simulation scan via
terminal-plus-statistic reductions on the full path matrix.

Discretely monitored at the simulation grid (as with barriers).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import HestonParams, MCConfig, OptionSpec
from options_model_tpu.pricers.american import simulate_paths


def _mc_estimate(payoffs, rate, T, pair_block=None):
    from options_model_tpu.core.stats import masked_mean_stderr

    disc = jnp.exp(-jnp.asarray(rate, payoffs.dtype) * jnp.asarray(T, payoffs.dtype))
    mean, stderr, _ = masked_mean_stderr(payoffs * disc, pair_block=pair_block)
    return mean, stderr


def geometric_asian_bs_price(S0, K, T, r, sigma, n_dates: int, cp=1.0,
                             div_yield=0.0):
    """Closed form for the DISCRETELY monitored geometric-average Asian
    option under GBM — monitoring dates t_i = i*T/n, i = 1..n (the exact
    grid ``price_asian_mc`` averages over, exotics.py:49).

    The geometric mean G = exp(mean_i log S_{t_i}) of correlated lognormals
    is itself lognormal:
        E[log G]   = log S0 + (r - q - sigma^2/2) * T (n+1)/(2n)
        Var[log G] = sigma^2 T/n^2 * sum_{i,j} min(i,j)/n
                   = sigma^2 T (n+1)(2n+1)/(6 n^2)
    (sum_{i,j<=n} min(i,j) = n(n+1)(2n+1)/6), so the price is the Black
    formula on the forward F = exp(E + Var/2). Serves as the control-variate
    anchor for the arithmetic Asian MC leg (Kemna & Vorst 1990) and as the
    terminal closed form of the American-Asian CV (pricers/american_asian).
    """
    S0 = jnp.asarray(S0)
    dtype = S0.dtype
    K = jnp.asarray(K, dtype)
    T = jnp.asarray(T, dtype)
    r = jnp.asarray(r, dtype)
    sigma = jnp.asarray(sigma, dtype)
    q = jnp.asarray(div_yield, dtype)
    n = float(n_dates)
    mu = jnp.log(S0) + (r - q - 0.5 * sigma**2) * T * (n + 1.0) / (2.0 * n)
    var = sigma**2 * T * (n + 1.0) * (2.0 * n + 1.0) / (6.0 * n * n)
    sd = jnp.sqrt(jnp.maximum(var, 1e-30))
    F = jnp.exp(mu + 0.5 * var)
    d1 = (mu - jnp.log(K) + var) / sd
    d2 = d1 - sd
    cp = jnp.asarray(cp, dtype)
    ndtr = jax.scipy.stats.norm.cdf
    return jnp.exp(-r * T) * cp * (F * ndtr(cp * d1) - K * ndtr(cp * d2))


def price_asian_mc(key: jax.Array, S0, T, spec: OptionSpec, mc: MCConfig,
                   model: str = "gbm", *, average: str = "arithmetic",
                   strike_type: str = "fixed",
                   heston: Optional[HestonParams] = None, merton=None,
                   bates=None, vg=None, sigma_fn=None,
                   control_variate: str = "auto"
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Asian option on the average of the monitored prices.

    average: 'arithmetic' | 'geometric'; strike_type: 'fixed' (payoff on
    avg vs K) | 'floating' (payoff on S_T vs avg). Returns (price, stderr).

    control_variate: 'auto' | 'on' | 'off' — the Kemna-Vorst (1990) variate:
    the GEOMETRIC-average payoff on the SAME monitored prices, centered at
    its exact closed form (geometric_asian_bs_price) with the pair-mean
    optimal beta. Eligible only where the closed form is exact — GBM,
    arithmetic average, fixed strike; 'on' raises elsewhere, 'auto' skips.
    """
    if average not in ("arithmetic", "geometric"):
        raise ValueError("average must be 'arithmetic' or 'geometric'")
    if strike_type not in ("fixed", "floating"):
        raise ValueError("strike_type must be 'fixed' or 'floating'")
    if control_variate not in ("auto", "on", "off"):
        raise ValueError("control_variate must be 'auto', 'on' or 'off'")
    cv_ok = (model == "gbm" and average == "arithmetic"
             and strike_type == "fixed")
    if control_variate == "on" and not cv_ok:
        raise ValueError("control_variate='on' requires model='gbm', "
                         "average='arithmetic', strike_type='fixed' (the "
                         "geometric closed form is exact only there)")
    use_cv = cv_ok and control_variate != "off"

    S = simulate_paths(key, S0, T, mc, model, sigma=spec.sigma, rate=spec.rate,
                       heston=heston, merton=merton, bates=bates, vg=vg,
                       sigma_fn=sigma_fn, div_yield=spec.div_yield)
    monitored = S[1:]  # average over the monitoring dates, not the spot
    if average == "arithmetic":
        avg = jnp.mean(monitored, axis=0)
    else:
        avg = jnp.exp(jnp.mean(jnp.log(monitored), axis=0))

    if strike_type == "fixed":
        payoffs = jnp.maximum(spec.cp * (avg - spec.strike), 0.0)
    else:
        payoffs = jnp.maximum(spec.cp * (S[-1] - avg), 0.0)
    pb = mc.path_block if mc.antithetic else None
    if not use_cv:
        return _mc_estimate(payoffs, spec.rate, T, pb)

    from options_model_tpu.core.stats import masked_mean_stderr, optimal_cv_beta

    dtype = payoffs.dtype
    disc = jnp.exp(-jnp.asarray(spec.rate, dtype) * jnp.asarray(T, dtype))
    geo = jnp.exp(jnp.mean(jnp.log(monitored), axis=0))
    geo_pay = jnp.maximum(spec.cp * (geo - spec.strike), 0.0)
    geo_cf = geometric_asian_bs_price(S0, spec.strike, T, spec.rate,
                                      spec.sigma, mc.n_steps, spec.cp,
                                      spec.div_yield)
    adj = geo_cf - disc * geo_pay  # E[adj] = 0 exactly
    beta = optimal_cv_beta(disc * payoffs, adj, pair_block=pb)
    mean, stderr, _ = masked_mean_stderr(disc * payoffs + beta * adj,
                                         pair_block=pb)
    return mean, stderr


def price_lookback_mc(key: jax.Array, S0, T, spec: OptionSpec, mc: MCConfig,
                      model: str = "gbm", *, strike_type: str = "floating",
                      heston: Optional[HestonParams] = None, merton=None,
                      bates=None, vg=None, sigma_fn=None
                      ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lookback option on the running extreme.

    floating: call pays S_T - min(S), put pays max(S) - S_T (always ITM).
    fixed:    call pays (max(S) - K)^+, put pays (K - min(S))^+.
    """
    if strike_type not in ("fixed", "floating"):
        raise ValueError("strike_type must be 'fixed' or 'floating'")

    S = simulate_paths(key, S0, T, mc, model, sigma=spec.sigma, rate=spec.rate,
                       heston=heston, merton=merton, bates=bates, vg=vg,
                       sigma_fn=sigma_fn, div_yield=spec.div_yield)
    S_min = jnp.min(S, axis=0)
    S_max = jnp.max(S, axis=0)

    if strike_type == "floating":
        payoffs = jnp.where(spec.cp > 0, S[-1] - S_min, S_max - S[-1])
    else:
        payoffs = jnp.where(spec.cp > 0,
                            jnp.maximum(S_max - spec.strike, 0.0),
                            jnp.maximum(spec.strike - S_min, 0.0))
    pb = mc.path_block if mc.antithetic else None
    return _mc_estimate(payoffs, spec.rate, T, pb)
