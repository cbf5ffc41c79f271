"""Randomized quasi-Monte Carlo: scrambled Sobol digital nets + Brownian bridge.

Beyond-reference capability (the reference is pseudo-random only). Classic
variance-reduction recipe (Glasserman, Monte Carlo Methods in Financial
Engineering, ch. 5):

  1. Sobol low-discrepancy points in [0,1)^d — here generated ON DEVICE with
     pure XLA bit ops (gray-code XOR of direction vectors), so the sampler
     runs on the device like every other kernel. The direction vectors (d x 30
     uint32, Joe-Kuo order via scipy.stats.qmc) are tiny host-side constants;
     Matousek linear-matrix scrambling + a digital shift are folded into them
     per replicate, giving *randomized* QMC: replicate means are i.i.d. and
     unbiased, so the stderr over replicates is a valid error estimate (the
     repo's stats discipline carries over — the i.i.d. unit here is the
     REPLICATE, not the path).
  2. Brownian-bridge construction — Sobol coordinates are only "super-uniform"
     in their leading dimensions, so the bridge routes the first coordinates
     to the largest-variance features of the path (terminal value, then
     midpoints, recursively), concentrating the integrand's effective
     dimension where the net is strongest.

Index discipline mirrors core/rng.py: points are keyed by GLOBAL point index
(``i0`` offset), so chunked/sharded evaluation reproduces the one-shot stream
bit for bit.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import ndtri

_BITS = 30  # scipy's Sobol tables carry 30-bit direction numbers


def sobol_directions(dim: int, scramble_seed=None) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side direction vectors for a (scrambled) Sobol net.

    Returns (sv, shift): sv (dim, 30) uint32 direction vectors, shift (dim,)
    uint32 digital shift. With ``scramble_seed=None`` the net is the plain
    Joe-Kuo Sobol sequence (shift = 0); with a seed, scipy applies Matousek
    linear-matrix scrambling to the direction vectors and draws a random
    digital shift — point i of the scrambled net is
    ``shift XOR (XOR_k sv[:,k] over set bits k of gray(i))``.
    """
    from scipy.stats import qmc

    eng = qmc.Sobol(d=dim, scramble=scramble_seed is not None,
                    seed=scramble_seed)
    sv = np.ascontiguousarray(eng._sv, dtype=np.uint32)
    if sv.shape[1] != _BITS:  # pragma: no cover - scipy layout guard
        raise RuntimeError(f"unexpected scipy Sobol bit width {sv.shape[1]}")
    if scramble_seed is not None:
        shift = np.ascontiguousarray(eng._shift, dtype=np.uint32)
    else:
        shift = np.zeros(dim, dtype=np.uint32)
    return sv, shift


def sobol_uniforms(sv, shift, i0, n: int, dtype=jnp.float32) -> jnp.ndarray:
    """(n, dim) uniforms for global Sobol indices i0 .. i0+n-1, on device.

    Pure XLA: gray-code the indices, XOR-accumulate direction vectors over the
    30 bits (a fori_loop of (n, dim) uint32 XORs), apply the digital shift, and
    map to the CENTER of each 2^-30 cell (the +0.5 offset keeps u strictly
    inside (0,1) so ndtri never sees 0 — and is the measure-preserving choice
    for a digital net). Chunking invariance: point i depends only on i.
    """
    sv = jnp.asarray(sv, jnp.uint32)
    shift = jnp.asarray(shift, jnp.uint32)
    idx = jnp.asarray(i0, jnp.uint32) + jnp.arange(n, dtype=jnp.uint32)
    gray = idx ^ (idx >> 1)

    def bit_step(k, acc):
        bit = ((gray >> k) & jnp.uint32(1)).astype(jnp.uint32)
        return acc ^ (bit[:, None] * sv[:, k][None, :])

    x = jax.lax.fori_loop(0, _BITS, bit_step,
                          jnp.zeros((n, sv.shape[0]), jnp.uint32))
    x = x ^ shift[None, :]
    u = (x.astype(dtype) + jnp.asarray(0.5, dtype)) * jnp.asarray(
        2.0 ** -_BITS, dtype)
    # f32 has a 24-bit mantissa, so cell centers in the top 2^-25 sliver
    # ROUND TO EXACTLY 1.0 (x >= 2^30 (1 - 2^-25) -> u == 1.0f) and ndtri
    # returns inf — clamp to the largest float below 1. Measure distortion
    # is confined to that sliver (|z| > 5.4); the low side needs no clamp
    # (2^-31 is exactly representable).
    return jnp.minimum(u, jnp.asarray(1.0, dtype)
                       - jnp.asarray(jnp.finfo(dtype).epsneg, dtype))


def sobol_normals(sv, shift, i0, n: int, dtype=jnp.float32) -> jnp.ndarray:
    """(n, dim) standard normals via the inverse CDF (preserves the net's
    one-dimensional stratification exactly, unlike Box-Muller)."""
    return ndtri(sobol_uniforms(sv, shift, i0, n, dtype))


@lru_cache(maxsize=None)
def brownian_bridge_tables(n_steps: int):
    """Host-side bisection schedule for the Brownian-bridge construction.

    Returns int32/float32 numpy arrays (m, l, r, w_l, w_r, sd) of length
    n_steps, in construction order, over the index grid 0..n_steps where
    W[0] = 0 and times are t_j = j/n_steps * T:

      construction step k fills W[m_k] = w_l_k * W[l_k] + w_r_k * W[r_k]
                                         + sd_k * sqrt(T) * Z_k

    Step 0 is the terminal point (w_l = w_r = 0, sd = 1); subsequent steps
    bisect the widest known segments breadth-first, so Sobol dimension k
    carries the k-th largest conditional variance share.
    """
    m_a, l_a, r_a, wl_a, wr_a, sd_a = [], [], [], [], [], []
    # terminal first: W[n] = sqrt(t_n) Z = sqrt(T) * 1.0 * Z (times in units of T)
    m_a.append(n_steps); l_a.append(0); r_a.append(0)
    wl_a.append(0.0); wr_a.append(0.0); sd_a.append(1.0)
    queue = [(0, n_steps)]
    while queue:
        l, r = queue.pop(0)
        if r - l < 2:
            continue
        m = (l + r) // 2
        tl, tm, tr = l / n_steps, m / n_steps, r / n_steps
        m_a.append(m); l_a.append(l); r_a.append(r)
        wl_a.append((tr - tm) / (tr - tl))
        wr_a.append((tm - tl) / (tr - tl))
        sd_a.append(math.sqrt((tm - tl) * (tr - tm) / (tr - tl)))
        queue.append((l, m)); queue.append((m, r))
    return (np.asarray(m_a, np.int32), np.asarray(l_a, np.int32),
            np.asarray(r_a, np.int32), np.asarray(wl_a, np.float32),
            np.asarray(wr_a, np.float32), np.asarray(sd_a, np.float32))


def brownian_bridge(Z: jnp.ndarray, T) -> jnp.ndarray:
    """Map (n_paths, n_steps) i.i.d.-structured normals to Brownian-path
    VALUES W (n_steps, n_paths) at times T/n, 2T/n, ..., T.

    Column k of Z drives construction step k (terminal first) — pair this with
    Sobol normals so the leading net dimensions own the path's coarse shape.
    The map is linear in Z and exactly measure-preserving: for i.i.d. N(0,1)
    input the output has Cov(W_s, W_t) = min(s, t) (tested in
    tests/test_qmc.py against the closed-form covariance).
    """
    n_paths, n_steps = Z.shape
    dtype = Z.dtype
    m, l, r, wl, wr, sd = brownian_bridge_tables(n_steps)
    sqrtT = jnp.sqrt(jnp.asarray(T, dtype))

    # scan needs the construction index to pick Z's column: carry it in xs.
    ks = jnp.arange(n_steps, dtype=jnp.int32)

    def fill(W, xs):
        mk, lk, rk, wlk, wrk, sdk, k = xs
        val = wlk * W[:, lk] + wrk * W[:, rk] + sdk * sqrtT * Z[:, k]
        return W.at[:, mk].set(val), None

    W0 = jnp.zeros((n_paths, n_steps + 1), dtype)
    xs = (jnp.asarray(m), jnp.asarray(l), jnp.asarray(r),
          jnp.asarray(wl, dtype), jnp.asarray(wr, dtype),
          jnp.asarray(sd, dtype), ks)
    W, _ = jax.lax.scan(fill, W0, xs)
    return W[:, 1:].T  # (n_steps, n_paths), t = dt .. T


def bb_increments(Z: jnp.ndarray, T) -> jnp.ndarray:
    """Brownian INCREMENTS dW (n_steps, n_paths) from bridge-ordered normals —
    the drop-in replacement for sqrt(dt) * Z_t in an Euler scheme."""
    W = brownian_bridge(Z, T)
    return jnp.diff(W, axis=0, prepend=jnp.zeros((1, W.shape[1]), W.dtype))


def replicate_stats(rep_means: jnp.ndarray):
    """(price, stderr) from K i.i.d. randomized-QMC replicate means.

    Replicates (independent scrambles) are the i.i.d. unit of RQMC — the
    analogue of the repo's antithetic pair-mean discipline (core/stats)."""
    k = rep_means.shape[0]
    price = jnp.mean(rep_means)
    var = jnp.sum((rep_means - price) ** 2) / jnp.maximum(k - 1, 1)
    return price, jnp.sqrt(var / k)
