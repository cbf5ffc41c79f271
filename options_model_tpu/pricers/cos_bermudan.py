"""Bermudan/American COS pricer — the early-exercise oracle for Levy models.

The framework's American prices under the jump families (Merton, VG) were
anchored only by internal consistency (CV z-scores, dominance, bracket
width); under GBM the anchor is the CRR tree (pricers/binomial.py) and under
Heston the ADI PDE solver (pricers/fd_heston.py). This module closes the gap
with the Fang-Oosterlee (2009, "Pricing early-exercise and discrete barrier
options by Fourier-cosine series expansions") Bermudan recursion, which is
exact-in-distribution for ANY model with i.i.d. log-increments (a Levy
process): GBM, Merton jump-diffusion, and Variance Gamma. It prices the SAME
discretized-exercise contract the LSM backward induction prices (exercise
opportunities at t_m = m*T/M, m = 1..M, payoff-only at t_M), so LSM-vs-COS
comparisons carry no Bermudan-vs-American gap — and an American limit is
provided by Richardson extrapolation in M.

Like the other oracles this is host-shaped float64 NumPy work (Newton/
bisection root-finds per date are data-dependent control flow), not a
device program; it exists to pin the Monte-Carlo pricers in tests and drives.

Recursion (put; calls mirror with the exercise region on the right):
  x = ln(S/K).  V_k(t_M) = G_k(a, 0)  (payoff cosine coefficients).
  For m = M-1 .. 1:
    c(x, t_m) = e^{-r dt} sum_j' Re{ phi(w_j; dt) V_j(t_{m+1}) e^{i w_j (x-a)} }
    x*_m solves c(x*, t_m) = g(x*)   (continuation = intrinsic)
    V_k(t_m) = G_k(a, x*_m) + C_k(x*_m, b, t_m)
  v(x0, t_0) = e^{-r dt} sum_k' Re{ phi(w_k; dt) V_k(t_1) e^{i w_k (x0-a)} }
with C_k the cosine coefficients of c over the continuation region, computed
through the closed-form transfer matrix M_{k,j} (O(N^2) per date — direct,
no FFT: N=512, M<=512 dates is millisecond-scale host work and far easier
to audit than the Hankel+Toeplitz split).

Validated in tests/test_cos_bermudan.py: the M=1 limit must match each
family's European closed form (BS / Merton series / VG-COS), the GBM
American limit must match CRR, and the LSM pricers must agree within MC
error for every Levy family.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["cos_bermudan_price", "cos_american_price"]


def _charfn_increment(model: str, dt: float, r: float, q: float, *,
                      sigma=None, merton=None, vg=None):
    """phi(u) = E[exp(i u x_dt)], x_dt one risk-neutral log-increment.

    Returns a callable u (real ndarray) -> complex128 ndarray. Drifts carry
    the martingale compensators, so E[e^{x_dt}] = e^{(r-q) dt} exactly.
    """
    if model == "gbm":
        if sigma is None:
            raise ValueError("model='gbm' needs sigma")
        mu = (r - q - 0.5 * sigma**2) * dt
        var = sigma**2 * dt

        def phi(u):
            return np.exp(1j * u * mu - 0.5 * var * u**2)
        return phi

    if model == "merton":
        if merton is None:
            raise ValueError("model='merton' needs MertonParams")
        sig, lam = merton.sigma, merton.lam
        mu_j, sig_j = merton.mu_j, merton.sigma_j
        kbar = math.exp(mu_j + 0.5 * sig_j**2) - 1.0
        mu = (r - q - 0.5 * sig**2 - lam * kbar) * dt
        var = sig**2 * dt

        def phi(u):
            phi_j = np.exp(1j * u * mu_j - 0.5 * sig_j**2 * u**2)
            return np.exp(1j * u * mu - 0.5 * var * u**2
                          + lam * dt * (phi_j - 1.0))
        return phi

    if model == "vg":
        if vg is None:
            raise ValueError("model='vg' needs VGParams")
        sig, th, nu = vg.sigma, vg.theta, vg.nu
        arg = 1.0 - th * nu - 0.5 * sig**2 * nu
        if arg <= 0.0:
            raise ValueError(
                "VG martingale condition violated: 1 - theta*nu - "
                f"0.5*sigma^2*nu = {arg:.6g} <= 0 (theta={th}, nu={nu}, "
                f"sigma={sig}); E[e^{{X_t}}] does not exist for these params")
        w = math.log(arg) / nu

        def phi(u):
            base = 1.0 - 1j * u * th * nu + 0.5 * sig**2 * nu * u**2
            return (np.exp(1j * u * (r - q + w) * dt)
                    * np.power(base, -dt / nu))
        return phi

    raise ValueError(f"cos_bermudan: unsupported model {model!r} "
                     "(needs i.i.d. log-increments — Heston/Bates go through "
                     "the ADI oracle instead)")


def _cumulants_T(model: str, T: float, r: float, q: float, *,
                 sigma=None, merton=None, vg=None):
    """(c1, c2_eff) of ln(S_T/S0) for the truncation range; c2_eff folds in
    sqrt(c4) for the fat-tailed families (Fang-Oosterlee Table 11)."""
    if model == "gbm":
        return (r - q - 0.5 * sigma**2) * T, sigma**2 * T
    if model == "merton":
        sig, lam = merton.sigma, merton.lam
        mu_j, sig_j = merton.mu_j, merton.sigma_j
        kbar = math.exp(mu_j + 0.5 * sig_j**2) - 1.0
        c1 = (r - q - 0.5 * sig**2 - lam * kbar + lam * mu_j) * T
        c2 = (sig**2 + lam * (mu_j**2 + sig_j**2)) * T
        c4 = lam * (mu_j**4 + 6.0 * mu_j**2 * sig_j**2 + 3.0 * sig_j**4) * T
        return c1, c2 + math.sqrt(max(c4, 0.0))
    if model == "vg":
        sig, th, nu = vg.sigma, vg.theta, vg.nu
        w = math.log(1.0 - th * nu - 0.5 * sig**2 * nu) / nu
        c1 = (r - q + w + th) * T
        c2 = (sig**2 + nu * th**2) * T
        c4 = 3.0 * (sig**4 * nu + 2.0 * th**4 * nu**3
                    + 4.0 * sig**2 * th**2 * nu**2) * T
        return c1, c2 + math.sqrt(max(c4, 0.0))
    raise ValueError(model)


def _chi_psi(k, a, b, x1, x2):
    """chi_k = int_{x1}^{x2} e^x cos(w_k (x-a)) dx and
    psi_k = int_{x1}^{x2} cos(w_k (x-a)) dx (Fang-Oosterlee eq. 22-23).
    k: (N,) ints; x1, x2 scalars. Returns (chi, psi), each (N,)."""
    w = k * np.pi / (b - a)
    chi = (1.0 / (1.0 + w**2)) * (
        np.cos(w * (x2 - a)) * np.exp(x2) - np.cos(w * (x1 - a)) * np.exp(x1)
        + w * np.sin(w * (x2 - a)) * np.exp(x2)
        - w * np.sin(w * (x1 - a)) * np.exp(x1))
    with np.errstate(invalid="ignore", divide="ignore"):
        psi = (np.sin(w * (x2 - a)) - np.sin(w * (x1 - a))) / w
    psi = np.where(k == 0, x2 - x1, psi)
    return chi, psi


def _payoff_coeffs(k, a, b, x1, x2, K, cp):
    """G_k over [x1, x2]: cosine coefficients of the intrinsic K(1-e^x)^+
    (put) or K(e^x-1)^+ (call) — the caller passes a region where the
    intrinsic is one-signed, so no hinge inside the integral."""
    if x2 <= x1:
        return np.zeros_like(k, dtype=np.float64)
    chi, psi = _chi_psi(k, a, b, x1, x2)
    sgn = 1.0 if cp > 0 else -1.0
    return (2.0 / (b - a)) * K * sgn * (chi - psi)


def _transfer_matrix(N, a, b, x1, x2):
    """M_{k,j} = (2/(b-a)) int_{x1}^{x2} e^{i w_j (x-a)} cos(w_k (x-a)) dx,
    via e^{i w_j u} cos(w_k u) = (e^{i(w_j+w_k)u} + e^{i(w_j-w_k)u})/2.
    Returns (N, N) complex128."""
    w = np.arange(N) * np.pi / (b - a)

    def _I(c):
        # int_{x1}^{x2} e^{i c (x-a)} dx, elementwise with the c=0 limit.
        c_safe = np.where(c == 0.0, 1.0, c)
        val = (np.exp(1j * c_safe * (x2 - a))
               - np.exp(1j * c_safe * (x1 - a))) / (1j * c_safe)
        return np.where(c == 0.0, (x2 - x1) + 0j, val)

    cplus = w[None, :] + w[:, None]       # w_j + w_k
    cminus = w[None, :] - w[:, None]      # w_j - w_k
    return (1.0 / (b - a)) * (_I(cplus) + _I(cminus))


def cos_bermudan_price(S0: float, K: float, T: float, r: float,
                       model: str = "gbm", *, sigma: Optional[float] = None,
                       merton=None, vg=None, cp: float = -1.0, q: float = 0.0,
                       n_dates: int = 50, n_terms: int = 512,
                       L: float = 10.0) -> float:
    """Bermudan price with n_dates equally spaced exercise dates (payoff-only
    at the last — the same contract pricers/american.py's LSM discretizes).

    Deterministic float64; the only error sources are the COS truncation
    (L sigmas, n_terms modes) — both resolution knobs, no statistical noise.
    """
    dt = T / n_dates
    disc = math.exp(-r * dt)
    phi_fn = _charfn_increment(model, dt, r, q, sigma=sigma, merton=merton,
                               vg=vg)
    c1, c2 = _cumulants_T(model, T, r, q, sigma=sigma, merton=merton, vg=vg)
    x0 = math.log(S0 / K)
    a = x0 + c1 - L * math.sqrt(c2)
    b = x0 + c1 + L * math.sqrt(c2)

    N = n_terms
    k = np.arange(N)
    w = k * np.pi / (b - a)
    phi = phi_fn(w)                       # (N,) complex128
    half = np.ones(N)
    half[0] = 0.5

    # Terminal value = intrinsic: put pays on [a, 0], call on [0, b].
    if cp > 0:
        V = _payoff_coeffs(k, a, b, min(max(0.0, a), b), b, K, cp)
    else:
        V = _payoff_coeffs(k, a, b, a, max(min(0.0, b), a), K, cp)

    def cont_val(x, u):
        """c(x, t_m) from u = half * phi * V(t_{m+1}); scalar or (G,) x."""
        x_arr = np.atleast_1d(np.asarray(x, dtype=np.float64))
        e = np.exp(1j * np.outer(x_arr - a, w))        # (G, N)
        out = disc * np.real(e @ u)
        return out if np.ndim(x) else float(out[0])

    def intrinsic(x):
        ex = np.exp(np.asarray(x, dtype=np.float64))
        return K * (ex - 1.0) if cp > 0 else K * (1.0 - ex)

    # Root scan grid: f(x) = c(x) - g(x) changes sign once at the exercise
    # boundary; a coarse scan brackets it, bisection polishes to f64. The
    # scan is restricted to the intrinsic-positive half so the (meaningless)
    # root in the OTM region can't capture the bracket.
    if cp > 0:
        lo, hi = max(0.0, a), b
    else:
        lo, hi = a, min(0.0, b)
    # Degenerate domain (deep-OTM put with a > 0 / deep-ITM-shifted call with
    # b < 0): the intrinsic-positive region lies entirely outside [a, b], so
    # there is no exercise region to scan for — pin the boundary at the
    # exercise-side endpoint instead of bracketing on a reversed grid.
    degenerate = hi <= lo
    grid = np.linspace(lo, hi, 257)

    for _ in range(n_dates - 1):
        u = half * phi * V
        if degenerate:
            xs = a if cp < 0 else b
        else:
            f = cont_val(grid, u) - intrinsic(grid)
            sign = f > 0.0
            if sign.all():
                # Continuation dominates everywhere ITM: no exercise region.
                xs = lo if cp < 0 else hi
            elif not sign.any():
                xs = hi if cp < 0 else lo
            else:
                # Put: exercise region is the LOW side (f<0 near a); take the
                # first sign change from the exercise side. Call: mirrored.
                # max(idx, 1): COS truncation oscillation can in principle put
                # the flip at grid point 0, where grid[idx-1] would wrap to
                # grid[-1] and hand bisection a reversed bracket.
                idx = (int(np.argmax(sign)) if cp < 0
                       else int(np.argmax(~sign)))
                idx = max(idx, 1)
                xl, xh = grid[idx - 1], grid[idx]
                for _ in range(60):
                    xm = 0.5 * (xl + xh)
                    fm = cont_val(xm, u) - intrinsic(xm)
                    if (fm > 0.0) == (cp < 0):
                        xh = xm
                    else:
                        xl = xm
                xs = 0.5 * (xl + xh)

        if cp > 0:
            Mt = _transfer_matrix(N, a, b, a, xs)
            C = disc * np.real(Mt @ u)
            G = _payoff_coeffs(k, a, b, xs, b, K, cp)
        else:
            Mt = _transfer_matrix(N, a, b, xs, b)
            C = disc * np.real(Mt @ u)
            G = _payoff_coeffs(k, a, b, a, xs, K, cp)
        V = C + G

    u = half * phi * V
    return max(cont_val(x0, u), 0.0)


def cos_american_price(S0: float, K: float, T: float, r: float,
                       model: str = "gbm", *, sigma: Optional[float] = None,
                       merton=None, vg=None, cp: float = -1.0, q: float = 0.0,
                       n_dates: int = 64, n_terms: int = 512,
                       L: float = 10.0) -> float:
    """Continuous-exercise American limit by repeated Richardson in the date
    count: V(M) = V_inf + e1/M + e2/M^2 + o(M^-2) across M, 2M, 4M (Fang-
    Oosterlee 2009 §4.3 use the same 4-point ladder; three points suffice at
    the oracle tolerances used here)."""
    vs = [cos_bermudan_price(S0, K, T, r, model, sigma=sigma, merton=merton,
                             vg=vg, cp=cp, q=q, n_dates=m, n_terms=n_terms,
                             L=L)
          for m in (n_dates, 2 * n_dates, 4 * n_dates)]
    r1 = 2.0 * vs[1] - vs[0]          # kills the 1/M term
    r2 = 2.0 * vs[2] - vs[1]
    return (4.0 * r2 - r1) / 3.0      # kills the 1/M^2 term
