"""Rough Bergomi (rBergomi) — rough-volatility dynamics.

    v_t = xi0 exp(eta Y_t - eta^2/2 t^{2H}),
    Y_t = sqrt(2H) int_0^t (t-s)^{H-1/2} dW_s        (Riemann-Liouville fBM,
                                                      Var Y_t = t^{2H})
    dS/S = r dt + sqrt(v_t) (rho dW + rho_bar dW_perp)

Bayer, Friz, Gatheral (2016). The model is NON-Markovian for H < 1/2: the
variance at t depends on the whole W path. Two simulation legs, one oracle
chain:

  * ``simulate_rbergomi`` — the Bennedsen-Lunde-Pakkanen (2017) HYBRID
    scheme (kappa=1): the Volterra sum over past Brownian increments is
    ONE strictly-lower-triangular (n_steps x n_steps) matmul against the
    (n_steps, block) increment matrix — matrix-unit work, unlike the
    elementwise scans every Markovian family runs. The
    singular most-recent interval uses the scheme's EXACT correlated
    Gaussian (variance dt^{2H}/(2H), covariance with the step increment
    dt^{H+1/2}/(H+1/2)). Same global-block counter RNG, antithetic
    mirroring, and ``first_block`` sharding contract as every simulator in
    models/ (models/blocks.py).
  * ``rbergomi_exact_chol`` — host-side float64 EXACT-covariance oracle:
    the joint Gaussian of (Y at all grid times, all Brownian increments)
    sampled through one Cholesky factor. The Y-Y covariances integrate the
    singular kernel product with the substitution u = (t_i - s)^{H+1/2}
    (smooth integrand, Gauss-Legendre); Y-W covariances are closed-form.
    Agreement hybrid-vs-Cholesky at SAME grid isolates the hybrid scheme's
    Volterra approximation from time-discretization error (both legs share
    the left-point Riemann price construction).
  * H = 1/2 limit: Y_t = W_t, so v_t = xi0 exp(eta W_t - eta^2 t/2) is a
    driftless lognormal VARIANCE (dv = eta v dW) — Markovian. The vol
    a_t = sqrt(v_t) then follows da = a (eta/2 dW - eta^2/8 dt): SABR
    (beta=1, nu=eta/2, alpha0=sqrt(xi0)) with a deterministic alpha drift,
    priced by the drift-extended ADI oracle (pricers/fd_sabr.py
    ``alpha_drift``). That anchors the full price construction against a
    PDE with no Monte Carlo on the oracle side.

Exact-by-construction checks carried in tests/test_rbergomi.py: the
exponential-martingale normalization E[v_t] = xi0 for ALL t — exact UNDER
THE DISCRETIZATION, because the compensator uses the scheme's own discrete
Var(Y_t) rather than the analytic t^{2H} (the two differ by up to ~2% at 50
steps for H = 0.1) — the spot martingale
E[e^{-rT} S_T] = S0, and the celebrated ATM-skew power law |skew| ~
T^{H-1/2}.

No reference counterpart (the reference's dynamics stop at Heston /
options_model_3.py:214-260); this family exists because rough vol is the
post-2016 production standard for equity smile term structures.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from options_model_tpu.core.config import MCConfig, RBergomiParams
from options_model_tpu.models.blocks import block_normals, num_blocks


# ---------------------------------------------------------------------------
# Hybrid-scheme (kappa=1) ingredients
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _hybrid_weights(n_steps: int, H: float, dt: float):
    """(W_mat, c1, c2, var) for the BLP kappa=1 scheme at this grid, float64.

    ``var[k]`` (k = 0..n_steps) is the DISCRETE scheme variance
    Var(Y_{t_k}) = 2H (dt (c1^2 + sum_{j=2..k} w_j^2) + c2^2) — it feeds the
    exponential-martingale compensator so E[v_t] = xi0 holds EXACTLY under
    the discretization (the analytic t^{2H} differs from the scheme variance
    by up to ~2% at 50 steps for H = 0.1, a grid-dependent E[v] bias of
    ~eta^2/2 x that gap; ADVICE r4). At H = 1/2 the scheme is exact and
    var[k] == t_k.

    gamma = H - 1/2. Y_{t_k} = sqrt(2H) [ Wtil_k + sum_{j>=2} w_j dW_{k-j+1} ]
    where the far terms use the optimal abscissas
        b_j = ((j^{g+1} - (j-1)^{g+1})/(g+1))^{1/g},  w_j = (b_j dt)^g,
    and the singular most-recent interval Wtil_k = int_{t_{k-1}}^{t_k}
    (t_k-s)^g dW is exact-Gaussian:
        Wtil = c1 dW_k + c2 Z2,   c1 = dt^g/(g+1),
        c2 = dt^{g+1/2} sqrt(1/(2g+1) - 1/(g+1)^2).

    W_mat is strictly lower triangular, W_mat[k-1, i-1] = w_{k-i+1} for
    k-i >= 1 — the convolution runs as W_mat @ dW (one matmul).
    """
    g = H - 0.5
    j = np.arange(2, n_steps + 1, dtype=np.float64)
    if abs(g) < 1e-12:                      # H = 1/2: kernel == 1
        w = np.ones_like(j)
        c1 = np.float64(dt) ** g / (g + 1.0)          # = 1
        c2 = 0.0
    else:
        b = ((j ** (g + 1.0) - (j - 1.0) ** (g + 1.0)) / (g + 1.0)) ** (1.0 / g)
        w = (b * dt) ** g
        c1 = dt ** g / (g + 1.0)
        c2 = dt ** (g + 0.5) * np.sqrt(
            max(1.0 / (2.0 * g + 1.0) - 1.0 / (g + 1.0) ** 2, 0.0))
    W_mat = np.zeros((n_steps, n_steps), np.float64)
    for lag in range(1, n_steps):           # W_mat[k, k-lag] = w_{lag+1}
        idx = np.arange(lag, n_steps)
        W_mat[idx, idx - lag] = w[lag - 1]
    # discrete Var(Y_{t_k}): the singular-interval exact Gaussian plus the
    # far-term weights accumulated through j = 2..k (w[0] is j=2)
    far = np.concatenate([[0.0], np.cumsum(w**2)])        # k = 1..n_steps
    var = 2.0 * H * (dt * (c1**2 + far) + c2**2)
    var = np.concatenate([[0.0], var])                    # k = 0..n_steps
    return W_mat, float(c1), float(c2), var


def _variance_grid(params: RBergomiParams, Y, var_grid, dtype):
    """v on the grid from the Volterra process: the exponential martingale
    xi0 exp(eta Y - eta^2/2 Var(Y)) with Var(Y) the DISCRETE scheme variance
    (_hybrid_weights ``var``) — E[v_t] = xi0 exactly under the
    discretization, not merely in the continuous limit (ADVICE r4). The
    exact-covariance Cholesky oracle keeps the analytic t^{2H} (its Y HAS
    that variance)."""
    eta = jnp.asarray(params.eta, dtype)
    xi0 = jnp.asarray(params.xi0, dtype)
    comp = 0.5 * eta**2 * jnp.asarray(var_grid, dtype)
    return xi0 * jnp.exp(eta * Y - comp[:, None])


def simulate_rbergomi(key: jax.Array, S0, T, params: RBergomiParams,
                      cfg: MCConfig, rate=0.0, *, return_paths: bool = False,
                      return_variance: bool = False, first_block: int = 0,
                      return_dual_state: bool = False):
    """Simulate rBergomi to T on cfg.n_steps left-point intervals.

    Returns terminal spots (paths_rounded,), or the (n_steps+1, paths) path
    matrix with return_paths=True; return_variance additionally returns the
    instantaneous variance on the same grid ((n_steps+1, paths), or v_T for
    terminal-only) — the regression state the (S, v)-basis LSM uses
    (pricers/american.py model='rbergomi', a Markovian-projection LOWER
    bound under rough vol: the pair (S_t, v_t) is not a sufficient
    statistic for H < 1/2, so the regressed policy is suboptimal-feasible;
    the Rogers dual brackets it from above). The price increments always
    use the LEFT-point variance (no look-ahead).

    RNG: three draws per step per block (dW driver, the singular-term
    orthogonal component, the price's orthogonal Brownian), keyed by
    (key, first_block + block, step, draw) — the global-block contract of
    every simulator (sharding/chunking invariance, models/blocks.py).

    ``return_dual_state`` (requires return_paths and return_variance): also
    return the (n_steps, n_paths) matrix of FROZEN Volterra histories
    ``hist[t] = sqrt(2H) G_{t+1}`` — the F_t-measurable part of Y_{t+1}
    (G uses only dW_1..dW_t), so that Y_{t+1} = hist[t] + sqrt(2H)
    (c1 dW_{t+1} + c2 Z2_{t+1}). With it, one fresh draw of
    (dW', Z2', Zp') replicates the hybrid scheme's one-step conditional law
    of (S_{t+1}, v_{t+1}) given F_t EXACTLY — the Rogers dual's inner
    sampler under rough vol (pricers/dual.py model='rbergomi'), which is
    what makes the dual a VALID upper bound on the discretized price even
    though (S, v) alone is not a Markov state.
    """
    if return_dual_state and not return_paths:
        raise ValueError("return_dual_state requires return_paths=True")
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    nb = num_blocks(cfg)
    half = cfg.path_block // 2
    dt = float(T) / n_steps
    W_np, c1, c2, var_np = _hybrid_weights(n_steps, float(params.H), dt)
    W_mat = jnp.asarray(W_np, dtype)
    sqrt2H = jnp.asarray(np.sqrt(2.0 * params.H), dtype)
    sqrt_dt = jnp.asarray(np.sqrt(dt), dtype)
    rho = jnp.asarray(params.rho, dtype)
    rho_bar = jnp.sqrt(1.0 - rho**2)
    r = jnp.asarray(rate, dtype)
    dt_a = jnp.asarray(dt, dtype)
    # discrete Var(Y) at t_0..t_n (Y_0 = 0 so v_0 == xi0 deterministically)
    var_grid = var_np

    def sim_block(block_key):
        # (n_steps, path_block) normals; antithetic mirrors ALL THREE draws
        # (the Volterra process, hence v, is mirrored too — pair means are
        # the i.i.d. unit at path_block granularity, like every simulator).
        def draw(t):
            return block_normals(block_key, t, half, 3, cfg.antithetic,
                                 dtype)
        z = jax.vmap(draw)(jnp.arange(n_steps))
        z1, z2, zp = z                      # each (n_steps, path_block)
        dW = sqrt_dt * z1
        # Volterra values at t_1..t_n: Y_{t_k} = sqrt(2H)(G_k + c1 dW_k +
        # c2 Z2_k) where G_k = sum_{i<k} w_{k-i+1} dW_i (row k-1 of the
        # strictly-lower-triangular convolution — one matmul) and the
        # c1/c2 pair is the interval-k singular term's exact Gaussian.
        G = jnp.matmul(W_mat, dW, precision=jax.lax.Precision.HIGHEST)
        Y = jnp.concatenate(
            [jnp.zeros((1, cfg.path_block), dtype),
             sqrt2H * (G + c1 * dW + c2 * z2)], axis=0)   # (n_steps+1, blk)
        v = _variance_grid(params, Y, var_grid, dtype)
        v_left = v[:-1]
        # left-point log-Euler: exact drift correction per interval
        dlogS = ((r - 0.5 * v_left) * dt_a
                 + jnp.sqrt(v_left) * (rho * dW + rho_bar * sqrt_dt * zp))
        logS0 = jnp.log(jnp.asarray(S0, dtype))
        if return_paths:
            logS = logS0 + jnp.concatenate(
                [jnp.zeros((1, cfg.path_block), dtype),
                 jnp.cumsum(dlogS, axis=0)], axis=0)
            S = jnp.exp(logS)
            if return_dual_state:
                # hist[t] = sqrt(2H) G_{t+1}: G's row t uses dW_1..dW_t only
                # (W_mat is strictly lower triangular; row 0 is all zeros).
                return S, v, sqrt2H * G
            if return_variance:
                return S, v
            return S
        S_T = jnp.exp(logS0 + jnp.sum(dlogS, axis=0))
        if return_variance:
            return S_T, v[-1]
        return S_T

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(
        first_block + jnp.arange(nb))
    out = jax.vmap(sim_block)(block_keys)

    def merge(x):
        if x.ndim == 3:                     # (nb, n_steps[+1], block)
            return jnp.transpose(x, (1, 0, 2)).reshape(
                x.shape[1], nb * cfg.path_block)
        return x.reshape(nb * cfg.path_block)

    if isinstance(out, tuple):
        return tuple(merge(x) for x in out)
    return merge(out)


def terminal_cv_core(key: jax.Array, S0, r, T, H, eta, rho, xi0,
                     W_mat, c1, c2, var_left, *, n_steps: int,
                     path_block: int, nb: int, antithetic: bool,
                     dtype=jnp.float32) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fully-traceable core of rbergomi_terminal_cv: every parameter —
    including H, eta, rho, xi0 and the host-precomputed hybrid weights
    (W_mat, c1, c2, var_left = _hybrid_weights(...)[...][:-1]) — is a
    DYNAMIC argument, so a jit of this function compiles once per
    (n_steps, paths) shape and serves every candidate parameter vector of
    a calibration loop (calibration/rbergomi.py jits it per expiry; the
    eager path paid ~100 dispatches per evaluation)."""
    half = path_block // 2
    dt = jnp.asarray(T, dtype) / n_steps
    sqrt_dt = jnp.sqrt(dt)
    W_mat = jnp.asarray(W_mat, dtype)
    c1 = jnp.asarray(c1, dtype)
    c2 = jnp.asarray(c2, dtype)
    sqrt2H = jnp.sqrt(2.0 * jnp.asarray(H, dtype))
    eta = jnp.asarray(eta, dtype)
    rho = jnp.asarray(rho, dtype)
    xi0 = jnp.asarray(xi0, dtype)
    rho_bar = jnp.sqrt(1.0 - rho**2)
    rr = jnp.asarray(r, dtype)
    comp = 0.5 * eta**2 * jnp.asarray(var_left, dtype)
    sig_cv = jnp.sqrt(xi0)

    def sim_block(block_key):
        def draw(t):
            return block_normals(block_key, t, half, 3, antithetic, dtype)
        z1, z2, zp = jax.vmap(draw)(jnp.arange(n_steps))
        dW = sqrt_dt * z1
        G = jnp.matmul(W_mat, dW, precision=jax.lax.Precision.HIGHEST)
        Y_tail = sqrt2H * (G[:-1] + c1 * dW[:-1] + c2 * z2[:-1])
        Y_left = jnp.concatenate(
            [jnp.zeros((1, path_block), dtype), Y_tail], axis=0)
        v_left = xi0 * jnp.exp(eta * Y_left - comp[:, None])
        dB = rho * dW + rho_bar * sqrt_dt * zp   # the price Brownian
        dlogS = (rr - 0.5 * v_left) * dt + jnp.sqrt(v_left) * dB
        dlogG = (rr - 0.5 * sig_cv**2) * dt + sig_cv * dB
        logS0 = jnp.log(jnp.asarray(S0, dtype))
        return (jnp.exp(logS0 + jnp.sum(dlogS, axis=0)),
                jnp.exp(logS0 + jnp.sum(dlogG, axis=0)))

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(
        jnp.arange(nb))
    S_T, G_T = jax.vmap(sim_block)(block_keys)
    return S_T.reshape(-1), G_T.reshape(-1)


def rbergomi_terminal_cv(key: jax.Array, S0, r, T, params: RBergomiParams,
                         cfg: MCConfig) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(S_T, G_T): terminal rBergomi spots plus the conditional-Black
    control-variate leg's terminal spots — the frozen-variance (v = xi0)
    lognormal driven by the IDENTICAL price Brownian, whose European price
    is Black-Scholes(sqrt(xi0)) exactly. One simulation serves every strike
    of an expiry (the surface calibrator's pricing engine,
    calibration/rbergomi.py) and rbergomi_european_mc composes the CV at
    the pair-mean optimal beta."""
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    dt = float(T) / n_steps
    W_np, c1, c2, var_np = _hybrid_weights(n_steps, float(params.H), dt)
    return terminal_cv_core(key, S0, r, T, params.H, params.eta, params.rho,
                            params.xi0, W_np, c1, c2, var_np[:-1],
                            n_steps=n_steps, path_block=cfg.path_block,
                            nb=num_blocks(cfg), antithetic=cfg.antithetic,
                            dtype=dtype)


def rbergomi_european_mc(key: jax.Array, S0, K, r, T,
                         params: RBergomiParams, cfg: MCConfig, cp=1.0,
                         control_variate: bool = True
                         ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """European price under rBergomi with the conditional-Black control
    variate: on the SAME paths, the deterministic-variance spot S^cv driven
    by the identical Brownians but with v frozen at xi0 prices by
    Black-Scholes(sqrt(xi0)) EXACTLY (constant-vol log-Euler has zero
    discretization error), and correlates strongly with the rough payoff.
    Pair-mean optimal beta, the repo-wide CV discipline."""
    from options_model_tpu.core.stats import masked_mean_stderr, optimal_cv_beta
    from options_model_tpu.pricers.blackscholes import bs_price

    dtype = cfg.dtype
    S_T, G_T = rbergomi_terminal_cv(key, S0, r, T, params, cfg)
    sig_cv = jnp.sqrt(jnp.asarray(params.xi0, dtype))
    rr = jnp.asarray(r, dtype)

    disc = jnp.exp(-rr * jnp.asarray(T, dtype))
    pay = disc * jnp.maximum(cp * (S_T - K), 0.0)
    if not control_variate:
        mean, se, _ = masked_mean_stderr(pay, pair_block=cfg.path_block)
        return mean, se
    cv_pay = disc * jnp.maximum(cp * (G_T - K), 0.0)
    cv_mean = bs_price(S0, K, T, r, sig_cv, cp)
    adj = cv_pay - cv_mean
    b = optimal_cv_beta(pay, adj, pair_block=cfg.path_block)
    mean, se, _ = masked_mean_stderr(pay + b * adj, pair_block=cfg.path_block)
    return mean, se


# ---------------------------------------------------------------------------
# Exact-covariance Cholesky oracle (host, float64)
# ---------------------------------------------------------------------------

def _yy_cov(ti: float, tj: float, H: float, n_quad: int = 64) -> float:
    """Cov(Y_ti, Y_tj) = 2H int_0^{min} (ti-s)^g (tj-s)^g ds, g = H-1/2.

    For ti == tj the closed form is t^{2H}. For ti < tj substitute
    u = (ti - s)^{g+1}: the integral becomes
    1/(g+1) int_0^{ti^{g+1}} (tj - ti + u^{1/(g+1)})^g du — a SMOOTH
    integrand (tj > ti), Gauss-Legendre converges spectrally."""
    if ti > tj:
        ti, tj = tj, ti
    g = H - 0.5
    if ti <= 0.0:
        return 0.0
    if abs(ti - tj) < 1e-15:
        return ti ** (2.0 * H)
    x, w = np.polynomial.legendre.leggauss(n_quad)
    umax = ti ** (g + 1.0)
    u = 0.5 * umax * (x + 1.0)
    val = np.sum(w * (tj - ti + u ** (1.0 / (g + 1.0))) ** g) * 0.5 * umax
    return 2.0 * H * val / (g + 1.0)


def _yw_cov(ti: float, tj: float, H: float) -> float:
    """Cov(Y_ti, W_tj) = sqrt(2H)/(H+1/2) [ti^{H+1/2} - (ti - min)^{H+1/2}]."""
    m = min(ti, tj)
    if m <= 0.0:
        return 0.0
    e = H + 0.5
    return np.sqrt(2.0 * H) / e * (ti ** e - (ti - m) ** e)


def rbergomi_exact_chol(seed: int, S0, K, r, T, params: RBergomiParams,
                        n_steps: int, n_paths: int, cp=1.0,
                        antithetic: bool = True
                        ) -> Tuple[float, float, np.ndarray]:
    """European price through EXACT joint sampling of (Y grid, W increments).

    float64 numpy on host: builds the (2n x 2n) covariance of
    (Y_{t_1..t_n}, dW_1..dW_n), Cholesky-factors it, and prices with the
    SAME left-point construction as the hybrid scheme — so hybrid-vs-this
    at one grid measures ONLY the hybrid Volterra approximation error.
    Returns (price, stderr, terminal spots). Small n_steps only (the
    Cholesky is O(n^3) in steps, not paths).
    """
    H = float(params.H)
    dt = float(T) / n_steps
    t = (np.arange(1, n_steps + 1, dtype=np.float64)) * dt

    n = n_steps
    C = np.zeros((2 * n, 2 * n))
    for i in range(n):
        for j in range(i, n):
            C[i, j] = C[j, i] = _yy_cov(t[i], t[j], H)
    # W-increment block: Cov(dW_i, dW_j) = dt delta_ij
    C[n:, n:] = np.eye(n) * dt
    # Cross: Cov(Y_ti, dW_j) = Cov(Y_ti, W_tj) - Cov(Y_ti, W_{t_{j-1}})
    for i in range(n):
        for j in range(n):
            hi = _yw_cov(t[i], t[j], H)
            lo = _yw_cov(t[i], t[j] - dt, H) if j > 0 else 0.0
            C[i, n + j] = C[n + j, i] = hi - lo
    # tiny jitter: the Y block is numerically near-singular for small dt
    L = np.linalg.cholesky(C + 1e-14 * np.eye(2 * n) * max(C.max(), 1.0))

    rng = np.random.default_rng(seed)
    m = n_paths // 2 if antithetic else n_paths
    Z = rng.standard_normal((2 * n, m))
    if antithetic:
        Z = np.concatenate([Z, -Z], axis=1)
    X = L @ Z
    Y_grid = X[:n]                           # Y at t_1..t_n
    dW = X[n:]
    Zp = rng.standard_normal((n, m))
    if antithetic:
        Zp = np.concatenate([Zp, -Zp], axis=1)

    # left-point construction identical to the hybrid leg
    Y_left = np.vstack([np.zeros((1, dW.shape[1])), Y_grid[:-1]])
    t_left = np.arange(n, dtype=np.float64) * dt
    v = float(params.xi0) * np.exp(
        float(params.eta) * Y_left
        - 0.5 * float(params.eta) ** 2 * t_left[:, None] ** (2.0 * H))
    rho = float(params.rho)
    rho_bar = np.sqrt(1.0 - rho**2)
    dB = rho * dW + rho_bar * np.sqrt(dt) * Zp
    logS = np.log(float(S0)) + np.sum(
        (float(r) - 0.5 * v) * dt + np.sqrt(v) * dB, axis=0)
    S_T = np.exp(logS)
    pay = np.exp(-float(r) * float(T)) * np.maximum(
        float(cp) * (S_T - float(K)), 0.0)
    if antithetic:
        pm = 0.5 * (pay[:m] + pay[m:])
        return (float(pm.mean()),
                float(pm.std(ddof=1) / np.sqrt(m)), S_T)
    return float(pay.mean()), float(pay.std(ddof=1) / np.sqrt(n_paths)), S_T
