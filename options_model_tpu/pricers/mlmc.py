"""Multilevel Monte Carlo (Giles 2008) — beyond-reference cost reduction.

The reference prices at ONE discretization level and eats the bias
(options_model_3/options_model_3.py:471-480 simulates a single fixed grid).
MLMC instead telescopes the fine-grid expectation over a geometric hierarchy

    E[P_L] = E[P_0] + sum_{l=1..L} E[P_l - P_{l-1}]

where level l uses n0 * M^l steps and each correction term is sampled with a
COUPLED fine/coarse pair driven by the same Brownian increments (the coarse
step consumes the SUM of the M fine normals).  Var[P_l - P_{l-1}] decays like
O(2^{-beta l}) (beta ~ 1 for Euler under Lipschitz payoffs), so nearly all
samples land on the cheap coarse levels: RMS accuracy eps costs
O(eps^-2 log^2 eps) instead of plain MC's O(eps^-3).

Shape discipline: the number of levels and per-level sample counts
are data-dependent, so the Giles loop runs ON HOST — but every sample batch
it requests is a fixed-shape jitted kernel (static (level, n_blocks)),
compiled once per level and reused across the loop's refinement rounds.
Welford accumulation happens host-side in float64 over antithetic PAIR MEANS
(the i.i.d. unit — the repo-wide stderr discipline, core/stats.py).

Couplings implemented:
  * GBM, exact log scheme — the terminal coupling is EXACT (fine and coarse
    terminals are the same sum of increments), so European-GBM corrections
    vanish identically; the Asian average still differs by grid (the real
    use case: the continuously-monitored contract).
  * Heston, full-truncation Euler (the reference's scheme) — the genuine
    weak-error O(dt) case; the MLMC limit is the continuous-time price
    (oracle: the COS closed form, calibration/charfn.heston_cos_price).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from options_model_tpu.core.config import HestonParams
from options_model_tpu.core.stats import pair_mean_reduce
from options_model_tpu.models.blocks import block_normals
from options_model_tpu.models.heston import _safe_sqrt


# ---------------------------------------------------------------------------
# Coupled level samplers
# ---------------------------------------------------------------------------

def _coupled_gbm_block(block_key, S0, r, sigma, T, nc: int, M: int,
                       block: int, antithetic: bool, dtype):
    """One path block of the level-l GBM coupling.

    Fine grid: nc*M exact log-Euler steps; coarse grid: nc steps consuming the
    summed fine normals (sum of M N(0,1) ~ sqrt(M) N(0,1) — the coarse
    increment's law is exact, and it is the conditional expectation of the
    fine path given the coarse filtration: the canonical MLMC coupling).

    Returns (S_fine_T, S_coarse_T, avg_fine, avg_coarse) each (block,); the
    averages are over the step-end monitoring dates of each grid (the
    convention of pricers/exotics.price_asian_mc).
    """
    nf = nc * M
    dt_f = jnp.asarray(T, dtype) / nf
    dt_c = jnp.asarray(T, dtype) / nc
    drift_f = (jnp.asarray(r, dtype) - 0.5 * jnp.asarray(sigma, dtype) ** 2) * dt_f
    drift_c = (jnp.asarray(r, dtype) - 0.5 * jnp.asarray(sigma, dtype) ** 2) * dt_c
    dif_f = jnp.asarray(sigma, dtype) * jnp.sqrt(dt_f)
    half = block // 2
    logS0 = jnp.log(jnp.asarray(S0, dtype))

    def step_draw(t):
        (z,) = block_normals(block_key, t, half, 1, antithetic, dtype)
        return z

    Z = jax.vmap(step_draw)(jnp.arange(nf))                    # (nf, block)
    inc_f = drift_f + dif_f * Z                                # fine log increments
    log_f = logS0 + jnp.cumsum(inc_f, axis=0)                  # (nf, block)
    S_f = jnp.exp(log_f)
    # coarse: sum each group of M fine normals
    Zc = Z.reshape(nc, M, block).sum(axis=1)                   # (nc, block)
    inc_c = drift_c + dif_f * Zc                               # dif_f*sum == sigma*sqrt(dt_c)*(Zc/sqrt(M))
    log_c = logS0 + jnp.cumsum(inc_c, axis=0)
    S_c = jnp.exp(log_c)
    return S_f[-1], S_c[-1], jnp.mean(S_f, axis=0), jnp.mean(S_c, axis=0)


def _coupled_heston_block(block_key, S0, r, T, p: HestonParams, nc: int,
                          M: int, block: int, antithetic: bool, dtype):
    """One path block of the level-l Heston full-truncation Euler coupling.

    The scan runs over the nc coarse steps; each iteration unrolls the M fine
    substeps (M is a small static int) and advances BOTH the fine state
    (logS_f, v_f) and the coarse state (logS_c, v_c), the latter consuming
    the substeps' summed correlated normals. Same drift/truncation as
    models/heston.simulate_heston (scheme='euler') so level-0 fine samples
    reproduce the production simulator's law exactly.
    """
    nf = nc * M
    dt_f = jnp.asarray(T, dtype) / nf
    dt_c = jnp.asarray(T, dtype) / nc
    sqdt_f = jnp.sqrt(dt_f)
    half = block // 2
    kappa = jnp.asarray(p.kappa, dtype)
    theta = jnp.asarray(p.theta, dtype)
    xi = jnp.asarray(p.xi, dtype)
    rho = jnp.asarray(p.rho, dtype)
    rho_bar = jnp.sqrt(1.0 - rho ** 2)
    r_ = jnp.asarray(r, dtype)

    vary0 = (jax.random.key_data(block_key).astype(dtype) * 0).sum()
    logS0 = jnp.full((block,), jnp.log(jnp.asarray(S0, dtype)), dtype) + vary0
    v0 = jnp.full((block,), jnp.asarray(p.v0, dtype), dtype) + vary0

    def euler(logS, v, dt, sq_v_dt_w1, dv_noise):
        v_plus = jnp.maximum(v, 0.0)
        v_new = jnp.maximum(v_plus + kappa * (theta - v_plus) * dt + dv_noise, 0.0)
        logS_new = logS + (r_ - 0.5 * v_plus) * dt + sq_v_dt_w1
        return logS_new, v_new

    def coarse_step(carry, tc):
        logS_f, v_f, sum_f, logS_c, v_c, sum_c = carry
        w1_sum = jnp.zeros((block,), dtype)
        w2_sum = jnp.zeros((block,), dtype)
        for j in range(M):
            z1, z2 = block_normals(block_key, tc * M + j, half, 2, antithetic, dtype)
            w1 = z1
            w2 = rho * z1 + rho_bar * z2
            sq = _safe_sqrt(jnp.maximum(v_f, 0.0)) * sqdt_f
            logS_f, v_f = euler(logS_f, v_f, dt_f, sq * w1, xi * sq * w2)
            sum_f = sum_f + jnp.exp(logS_f)
            w1_sum = w1_sum + w1
            w2_sum = w2_sum + w2
        sqc = _safe_sqrt(jnp.maximum(v_c, 0.0)) * sqdt_f     # sqrt(v) sqrt(dt_c) = sqrt(v) sqrt(dt_f) * sqrt(M); the
        logS_c, v_c = euler(logS_c, v_c, dt_c,               # summed normals already carry the sqrt(M) scale.
                            sqc * w1_sum, xi * sqc * w2_sum)
        sum_c = sum_c + jnp.exp(logS_c)
        return (logS_f, v_f, sum_f, logS_c, v_c, sum_c), None

    # vary0 ties the zero-initialized running sums to the key's data so their
    # sharding "varying" annotation matches the per-step randomness under
    # shard_map (same trick as models/heston.simulate_heston).
    z = jnp.zeros((block,), dtype) + vary0
    carry0 = (logS0, v0, z, logS0, v0, z)
    (logS_f, _, sum_f, logS_c, _, sum_c), _ = jax.lax.scan(
        coarse_step, carry0, jnp.arange(nc))
    return (jnp.exp(logS_f), jnp.exp(logS_c),
            sum_f / nf, sum_c / nc)


def _level_sampler(model: str, payoff: Callable, S0, r, T, level: int,
                   n0: int, M: int, block: int, antithetic: bool, dtype,
                   sigma=None, heston: Optional[HestonParams] = None,
                   n_blocks: int = 1, mesh=None):
    """Build the jitted level-l correction sampler.

    Returns sample(key, first_block) -> Y (n_blocks*block,) where
    Y = P_fine - P_coarse for level > 0 and Y = P_fine for level 0.
    payoff(S_T, avg) -> per-path UNdiscounted payoff.

    ``mesh``: optional 1-axis jax.sharding.Mesh — the blocks are split across
    its devices (levels are embarrassingly parallel over path blocks). The
    RNG is keyed by GLOBAL block index either way, so the meshed result is
    the single-device stream bit-for-bit (tested: test_mlmc.py).
    """
    nc = n0 * (M ** (level - 1)) if level > 0 else n0
    Mi = M if level > 0 else 1

    def block_sample(block_key):
        if model == "gbm":
            sf, sc, af, ac = _coupled_gbm_block(
                block_key, S0, r, sigma, T, nc, Mi, block, antithetic, dtype)
        elif model == "heston":
            sf, sc, af, ac = _coupled_heston_block(
                block_key, S0, r, T, heston, nc, Mi, block, antithetic, dtype)
        else:
            raise ValueError(f"mlmc supports 'gbm' and 'heston', got {model!r}")
        pf = payoff(sf, af)
        if level == 0:
            return pf
        return pf - payoff(sc, ac)

    def run_blocks(key, blocks):
        bks = jax.vmap(lambda b: jax.random.fold_in(key, b))(blocks)
        return jax.vmap(block_sample)(bks).reshape(-1)

    if mesh is None:
        @jax.jit
        def sample(key, first_block):
            return run_blocks(key, first_block + jnp.arange(n_blocks))
        return sample

    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    (axis,) = mesh.axis_names
    ndev = mesh.devices.size
    if n_blocks % ndev:
        raise ValueError(f"n_blocks={n_blocks} not divisible by the "
                         f"{ndev}-device mesh")
    local = n_blocks // ndev

    @jax.jit
    def sample(key, first_block):
        def shard_fn(key, first_block):
            start = first_block + jax.lax.axis_index(axis) * local
            return run_blocks(key, start + jnp.arange(local))
        return shard_map(shard_fn, mesh=mesh, in_specs=(P(), P()),
                         out_specs=P(axis))(key, jnp.asarray(first_block))

    return sample


# ---------------------------------------------------------------------------
# Giles adaptive driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MLMCResult:
    price: float
    stderr: float               # sqrt(sum_l V_l / N_l) over pair means
    bias_bound: float           # extrapolated remaining weak error
    levels: int                 # L + 1 grids used
    n_per_level: list           # samples actually taken
    mean_per_level: list
    var_per_level: list         # pair-mean variance
    alpha: float                # measured weak rate  |E[Y_l]| ~ M^(-alpha l)
    beta: float                 # measured variance rate V_l ~ M^(-beta l)
    cost: float                 # sum_l N_l * steps_l (fine+coarse path-steps)
    mc_cost_equiv: float        # plain-MC path-steps for the same (eps, L)
    details: dict = dataclasses.field(default_factory=dict)


class _LevelStats:
    """Host-side float64 moment accumulator over antithetic pair means."""

    def __init__(self):
        self.n = 0
        self.s1 = 0.0
        self.s2 = 0.0

    def add(self, y: np.ndarray):
        self.n += y.size
        self.s1 += float(y.sum(dtype=np.float64))
        self.s2 += float((y.astype(np.float64) ** 2).sum())

    @property
    def mean(self):
        return self.s1 / max(self.n, 1)

    @property
    def var(self):
        if self.n < 2:
            return float("inf")
        m = self.mean
        return max(self.s2 / self.n - m * m, 0.0) * self.n / (self.n - 1)


def mlmc_estimate(key, make_sampler: Callable[[int, int], Callable], *,
                  eps: float, n0: int, M: int = 2, L_min: int = 2,
                  L_max: int = 8, n_pilot: int = 4096, block: int = 4096,
                  antithetic: bool = True, max_samples: int = 1 << 24,
                  discount: float = 1.0, devices: int = 1) -> MLMCResult:
    """Run the Giles MLMC loop.

    make_sampler(level, n_blocks) -> jitted sample(key, first_block) -> (n,)
    per-path level-l correction samples.  eps is the target RMS error split
    evenly between variance (stderr <= eps/sqrt(2)) and bias.  discount
    multiplies the final estimate (payoffs are sampled undiscounted so the
    level statistics stay payoff-scaled).
    """
    if block % 2:
        raise ValueError("block must be even (antithetic pairs)")
    pair_block = block if antithetic else None
    samplers: Dict[tuple, Callable] = {}
    stats: Dict[int, _LevelStats] = {}
    next_block: Dict[int, int] = {}     # per-level global block cursor
    cost_unit = {}                      # fine+coarse path-steps per path

    def level_cost(l):
        if l not in cost_unit:
            steps_f = n0 * (M ** l)
            cost_unit[l] = steps_f + (steps_f // M if l > 0 else 0)
        return cost_unit[l]

    def draw(l, n_samples):
        """Take n_samples more paths at level l (rounded up to whole blocks,
        and to whole per-device block sets under a mesh)."""
        st = stats.setdefault(l, _LevelStats())
        nb_total = (n_samples + block - 1) // block
        nb_total = ((nb_total + devices - 1) // devices) * devices
        # chunk so one device call stays ~2^20 paths per device
        chunk = max(1, (1 << 20) // (block * max(1, n0 * M ** l // 64)))
        chunk = ((chunk + devices - 1) // devices) * devices
        lkey = jax.random.fold_in(key, l)
        while nb_total > 0:
            nb = min(nb_total, chunk)  # both multiples of devices
            sk = samplers.get((l, nb))
            if sk is None:
                sk = samplers[(l, nb)] = make_sampler(l, nb)
            fb = next_block.get(l, 0)
            y = sk(lkey, fb)
            next_block[l] = fb + nb
            if antithetic:
                y = pair_mean_reduce(y, pair_block)
            st.add(np.asarray(jax.device_get(y)))
            nb_total -= nb

    L = L_min
    for l in range(L + 1):
        draw(l, n_pilot)

    var_target = eps * eps / 2.0
    alpha = beta = float("nan")
    for _ in range(64):  # refinement rounds (converges in a handful)
        Ls = list(range(L + 1))
        V = np.array([stats[l].var for l in Ls])
        m = np.array([stats[l].mean for l in Ls])
        C = np.array([level_cost(l) for l in Ls], dtype=np.float64)
        # pair means halve the sample count: a "sample" below is one pair mean
        lam = float(np.sum(np.sqrt(V * C)))
        N_opt = np.ceil(np.sqrt(V / C) * lam / var_target).astype(np.int64)
        N_opt = np.minimum(N_opt, max_samples)
        need = False
        for l in Ls:
            have = stats[l].n
            if N_opt[l] > have:
                need = True
                draw(l, int(min(N_opt[l] - have, max_samples)) *
                     (2 if antithetic else 1))
        if need:
            continue
        # measured rates from the correction levels (l >= 1)
        if L >= 2:
            ls = np.arange(1, L + 1)
            ml = np.abs(m[1:])
            A = np.vstack([ls, np.ones_like(ls)]).T.astype(np.float64)
            alpha = float(-np.linalg.lstsq(A, np.log(np.maximum(ml, 1e-30)) /
                                           np.log(M), rcond=None)[0][0])
            beta = float(-np.linalg.lstsq(A, np.log(np.maximum(V[1:], 1e-30)) /
                                          np.log(M), rcond=None)[0][0])
        a_eff = max(alpha, 0.5) if np.isfinite(alpha) else 0.5
        # Giles convergence test: remaining bias from the last two corrections
        rem = max(abs(m[l]) / (M ** (a_eff * (L - l)))
                  for l in range(max(1, L - 1), L + 1)) / (M ** a_eff - 1.0)
        if rem < eps / math.sqrt(2.0) or L >= L_max:
            break
        L += 1
        draw(L, n_pilot)

    Ls = list(range(L + 1))
    V = np.array([stats[l].var for l in Ls])
    m = np.array([stats[l].mean for l in Ls])
    N = np.array([stats[l].n for l in Ls])
    C = np.array([level_cost(l) for l in Ls], dtype=np.float64)
    price = float(m.sum()) * discount
    stderr = float(np.sqrt(np.sum(V / np.maximum(N, 1)))) * discount
    a_eff = max(alpha, 0.5) if np.isfinite(alpha) else 0.5
    rem = (max(abs(m[l]) / (M ** (a_eff * (L - l)))
               for l in range(max(1, L - 1), L + 1)) / (M ** a_eff - 1.0)
           if L >= 1 else 0.0)
    paths = 2 if antithetic else 1     # device paths per pair-mean sample
    cost = float(np.sum(N * paths * C))
    # plain MC at the finest grid hitting the same variance target:
    var_single = float(V[0]) if L == 0 else float(max(V[0], V.sum()))
    mc_cost = var_single / var_target * paths * level_cost(L)
    return MLMCResult(
        price=price, stderr=stderr, bias_bound=float(rem) * discount,
        levels=L + 1, n_per_level=N.tolist(),
        mean_per_level=(m * discount).tolist(), var_per_level=V.tolist(),
        alpha=float(alpha), beta=float(beta), cost=cost,
        mc_cost_equiv=mc_cost,
        details={"M": M, "n0": n0, "eps": eps})


# ---------------------------------------------------------------------------
# Public pricers
# ---------------------------------------------------------------------------

def _payoff_fn(kind: str, K, cp, dtype):
    K = jnp.asarray(K, dtype)
    cp = jnp.asarray(cp, dtype)

    def european(s_T, avg):
        return jnp.maximum(cp * (s_T - K), 0.0)

    def asian(s_T, avg):
        return jnp.maximum(cp * (avg - K), 0.0)

    return {"european": european, "asian": asian}[kind]


def price_mlmc(key, S0, K, r, T, *, cp=1.0, payoff: str = "european",
               model: str = "gbm", sigma=None,
               heston: Optional[HestonParams] = None, eps: float = 5e-3,
               q: float = 0.0, n0: int = 4, M: int = 2, L_min: int = 2,
               L_max: int = 8, n_pilot: int = 4096, block: int = 4096,
               antithetic: bool = True, dtype=jnp.float32,
               mesh=None) -> MLMCResult:
    """Multilevel European/Asian pricer under GBM or Heston Euler dynamics.

    eps: target RMS error in PRICE units (bias and stderr each <= eps/sqrt(2)).
    The Asian contract here is the continuously-monitored average — the MLMC
    hierarchy refines the monitoring grid, unlike price_asian_mc which prices
    the fixed n_steps-date contract. ``q``: continuous dividend yield (risk-
    neutral drift r - q; discounting stays at r).

    ``mesh``: optional 1-axis jax.sharding.Mesh — every level's path blocks
    are sharded across its devices. The sample STREAM equals the
    single-device one (global-block-keyed RNG); per-level counts round up to
    whole per-device block sets, so the estimate agrees statistically
    (tested in tests/test_mlmc.py).
    """
    if model == "gbm" and sigma is None:
        raise ValueError("model='gbm' needs sigma")
    if model == "heston" and heston is None:
        raise ValueError("model='heston' needs heston params")
    pay = _payoff_fn(payoff, K, cp, dtype)
    mu = float(r) - float(q)

    def make_sampler(level, n_blocks):
        return _level_sampler(model, pay, S0, mu, T, level, n0, M, block,
                              antithetic, dtype, sigma=sigma, heston=heston,
                              n_blocks=n_blocks, mesh=mesh)

    disc = math.exp(-float(r) * float(T))
    return mlmc_estimate(key, make_sampler, eps=eps, n0=n0, M=M, L_min=L_min,
                         L_max=L_max, n_pilot=n_pilot, block=block,
                         antithetic=antithetic, discount=disc,
                         devices=1 if mesh is None else mesh.devices.size)
