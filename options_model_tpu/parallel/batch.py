"""Sharded batch pricers: task-parallel grids and path-parallel single pricings.

Replaces the reference's ProcessPoolExecutor fan-out (SURVEY.md §2.2): the
strike x maturity x S0 grid becomes a sharded task axis; a single huge pricing
shards the independent paths axis with exact psum reductions.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from options_model_tpu.core.config import (
    HestonParams, LSMConfig, MCConfig, OptionSpec)
from options_model_tpu.core.payoff import vanilla_payoff
from options_model_tpu.core.stats import welford_from_batch, welford_psum
from options_model_tpu.models.blocks import num_blocks
from options_model_tpu.pricers.american import (
    lsm_poly_backward,
    simulate_paths,
)
from options_model_tpu.pricers.european import make_terminal_sampler
from options_model_tpu.surface.cheb import LocalVolTable


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _path_shard_geometry(mc: MCConfig, n_dev: int):
    """(total blocks, blocks per device) for a path-sharded run: whole path
    blocks per device, so global-block streams reproduce the unsharded run."""
    nb_total = _pad_to(num_blocks(mc), n_dev)
    return nb_total, nb_total // n_dev


def pad_to_multiple(x: jnp.ndarray, m: int) -> jnp.ndarray:
    """Pad axis 0 of ``x`` up to a multiple of ``m`` by repeating the last
    row — padded tasks recompute a real cell (cheap, shape-static) and the
    caller slices the results back to the true length. Single owner of the
    device-count padding used by every sharded grid/surface/curve engine."""
    n = x.shape[0]
    n_pad = _pad_to(n, m)
    if n_pad == n:
        return x
    return jnp.concatenate(
        [x, jnp.broadcast_to(x[-1:], (n_pad - n,) + x.shape[1:])])


def price_american_grid(key: jax.Array, S0s, strikes, taus, rate, mc: MCConfig,
                        mesh: Mesh, *, cp: float = -1.0, sigma=None,
                        heston: Optional[HestonParams] = None,
                        merton=None, bates=None, vg=None,
                        model: str = "gbm", engine: str = "auto",
                        use_control_variate: bool = False,
                        european_approximation: bool = False,
                        heston_scheme: str = "euler",
                        lsm_out_of_sample: bool = False,
                        lsm: Optional[LSMConfig] = None,
                        localvol_table=None, div_yield: float = 0.0,
                        task_ids=None, return_stderr: bool = False,
                        axis: str = "tasks") -> jnp.ndarray:
    """Price a batch of American options, task-sharded across the mesh.

    S0s/strikes/taus: equal-length 1-D arrays — one task per row (a flattened
    strike x maturity x spot grid; BASELINE.json configs[4]). All tasks share
    (mc.n_steps, mc.n_paths) so shapes are static; group tasks by step count at
    the orchestration layer (apps/curves.py) when steps vary.

    Each task's RNG is fold_in(key, global_task_index) — the collective-free
    rebuild of the reference's pre-derived worker seeds, invariant to the
    device count. Returns prices (n_tasks,).

    ``lsm`` selects the regressor: the default (None) is the masked-WLS poly
    backward; LSMConfig(regressor='nn') routes every task through the shared
    continuation-value MLP (lsm_nn_backward — the reference's flagship
    scheme, options_model_3/options_model_3.py:679-695), trained per task
    inside the sharded body.

    ``localvol_table`` (model='localvol'): a compiled Chebyshev surface
    (surface/cheb.compile_localvol_table) that tasks simulate through the XLA
    table evaluator. The table's step count must equal mc.n_steps and its m-range should cover the
    task grid's spots (compile with S0_range=(min(S0s), max(S0s))).
    """
    S0s = jnp.asarray(S0s, jnp.float32)
    strikes = jnp.asarray(strikes, jnp.float32)
    taus = jnp.asarray(taus, jnp.float32)
    n_tasks = S0s.shape[0]
    n_dev = mesh.devices.size

    def pad(x):
        return pad_to_multiple(x, n_dev)

    S0p, Kp, Tp = pad(S0s), pad(strikes), pad(taus)
    # Global task ids drive per-task RNG; callers slicing a larger task list
    # (e.g. the curve orchestrator's step buckets) pass their own so results
    # don't depend on the bucketing.
    if task_ids is None:
        task_ids = jnp.arange(n_tasks)
    task_ids = pad(jnp.asarray(task_ids, jnp.int32))

    # Memoized jitted executable: a fresh jax.jit(shard_map(...)) per call
    # would retrace every sweep bucket (see _shared_impl in
    # pricers/surface_american.py for the measured cost). Traced leaves
    # (key, rate, sigma, heston, div_yield, the localvol table) enter as
    # replicated arguments; statics key the cache.
    fn = _grid_impl(mc, mesh, model, engine, use_control_variate,
                    european_approximation, heston_scheme,
                    lsm_out_of_sample, lsm, axis,
                    sigma is not None, heston is not None,
                    localvol_table is not None,
                    merton is not None, bates is not None,
                    vg is not None)
    sigma_a = jnp.float32(0.0) if sigma is None else jnp.asarray(
        sigma, jnp.float32)
    heston_a = (HestonParams(kappa=1.0, theta=0.04, xi=0.1, rho=0.0, v0=0.04)
                if heston is None else heston)
    table_a = (LocalVolTable(coeffs=jnp.zeros((1, 1), jnp.float32),
                             m_center=0.0, m_half=1.0, K=1.0)
               if localvol_table is None else localvol_table)
    jump_a = _jump_args(merton, bates, vg)
    prices, stderrs = fn(S0p, Kp, Tp, task_ids, key, jnp.float32(rate),
                         sigma_a, heston_a, table_a, jump_a, jnp.float32(cp),
                         jnp.float32(div_yield))
    if return_stderr:
        return prices[:n_tasks], stderrs[:n_tasks]
    return prices[:n_tasks]


def _jump_args(merton, bates, vg=None):
    """Fixed-structure (MertonParams, BatesParams, VGParams) pytree for the
    jitted grid bodies — dummies stand in when a family is unused so the
    lru-cached executable's argument structure never changes (the has_*
    statics decide whether price_one reads them)."""
    from options_model_tpu.core.config import (BatesParams, MertonParams,
                                               VGParams)
    m = (MertonParams(sigma=0.2, lam=0.0, mu_j=0.0, sigma_j=0.1)
         if merton is None else merton)
    b = (BatesParams(heston=HestonParams(kappa=1.0, theta=0.04, xi=0.1,
                                         rho=0.0, v0=0.04),
                     lam=0.0, mu_j=0.0, sigma_j=0.1)
         if bates is None else bates)
    v = VGParams(sigma=0.2, theta=0.0, nu=0.1) if vg is None else vg
    return (m, b, v)


@functools.lru_cache(maxsize=256)
def _grid_impl(mc: MCConfig, mesh: Mesh, model: str, engine: str,
               use_control_variate: bool, european_approximation: bool,
               heston_scheme: str, lsm_out_of_sample: bool,
               lsm: Optional[LSMConfig], axis: str,
               has_sigma: bool, has_heston: bool, has_table: bool,
               has_merton: bool = False, has_bates: bool = False,
               has_vg: bool = False):
    """Compile-cached body of price_american_grid (statics in the cache key;
    array shapes re-specialize through jit's own cache)."""

    def price_one(task, key, rate, sigma, heston, table, jump, cp, div_yield):
        from options_model_tpu.core.stats import masked_mean_stderr
        from options_model_tpu.pricers.american import (
            _apply_cv, _cv_adjustment, _vol_params)

        sigma = sigma if has_sigma else None
        heston = heston if has_heston else None
        table = table if has_table else None
        merton = jump[0] if has_merton else None
        bates = jump[1] if has_bates else None
        vg = jump[2] if has_vg else None
        S0, K, T, tid = task
        task_key = jax.random.fold_in(key, tid.astype(jnp.int32))
        spec = OptionSpec(strike=K, rate=rate, cp=cp, sigma=sigma,
                          div_yield=div_yield)
        want_v = (((model == "heston" and has_heston)
                   or (model == "bates" and has_bates))
                  and not european_approximation
                  and (lsm is None or lsm.variance_basis))
        out = simulate_paths(task_key, S0, T, mc, model, sigma=sigma,
                             rate=rate, heston=heston, merton=merton,
                             bates=bates, vg=vg, engine=engine,
                             heston_scheme=heston_scheme,
                             localvol_table=table,
                             div_yield=div_yield, return_variance=want_v)
        S_paths, v_paths = out if want_v else (out, None)
        pb = mc.path_block
        stat_pb = pb if mc.antithetic else None
        if european_approximation:
            # Discounted terminal payoff mean (the reference's streaming-mode
            # shortcut, options_model_3/options_model_3.py:687-690) —
            # checked BEFORE the regressor choice: the explicit European
            # request overrides how a (never-run) American backward would
            # regress. The stderr is over antithetic PAIR MEANS — raw
            # antithetic samples are not i.i.d. (core/stats.pair_mean_reduce).
            disc_T = jnp.exp(-jnp.asarray(rate, S_paths.dtype) * T)
            pay = vanilla_payoff(S_paths[-1], K, cp) * disc_T
            price, stderr, _ = masked_mean_stderr(pay, None, None, stat_pb)
            return price, stderr
        cv_leg = ((has_sigma and model == "gbm")
                  or (model == "heston" and has_heston)
                  or (model == "merton" and has_merton)
                  or (model == "bates" and has_bates)
                  or (model == "vg" and has_vg))
        # The grid-level flag and the LSMConfig knob both request the
        # low-biased estimator; every branch below (poly/nn, plain/richardson)
        # must honor their OR — pricing in-sample while the caller asked for
        # out-of-sample would silently return the foresight-biased estimate.
        oos = lsm_out_of_sample or (lsm is not None and lsm.out_of_sample)
        if lsm is not None and lsm.regressor == "nn":
            # Distinct fit stream per task (sim used task_key itself). The nn
            # estimator composes with the same CV / Richardson / OOS layers
            # as the poly one (the reference's flagship estimator is CV
            # around the shared net, options_model_3.py:653-677).
            from options_model_tpu.pricers.american import (
                lsm_nn_backward, richardson_nn_stat)
            fit_key = jax.random.fold_in(task_key, jnp.int32(1))
            if lsm.richardson:
                eff_lsm = lsm.replace(
                    use_control_variate=use_control_variate and cv_leg,
                    out_of_sample=oos)
                stat, mask_r = richardson_nn_stat(
                    fit_key, S_paths, v_paths, spec, T, eff_lsm,
                    heston=heston, bates=bates, vg=vg, model=model,
                    pair_block=pb)
                price, stderr, _ = masked_mean_stderr(stat, mask_r, None,
                                                      stat_pb)
                return price, stderr
            price, stderr, (cash, eval_mask) = lsm_nn_backward(
                fit_key, S_paths, spec, T, lsm, stat_pair_block=stat_pb,
                v_paths=v_paths, out_of_sample=oos,
                pair_block=pb, return_cash=True,
                heston=_vol_params(heston, bates))
            if use_control_variate and cv_leg:
                cv = _apply_cv(cash, _cv_adjustment(S_paths, spec, T,
                                                    heston=heston,
                                                    model=model,
                                                    merton=merton,
                                                    bates=bates, vg=vg),
                               lsm.cv_beta, eval_mask, None, stat_pb)
                price, stderr, _ = masked_mean_stderr(cv, eval_mask, None,
                                                      stat_pb)
            return price, stderr
        degree = lsm.poly_degree if lsm is not None else 3
        if lsm is not None and lsm.richardson:
            # Common-path Richardson to the continuous-exercise limit — the
            # statistic construction is owned by american.richardson_cv_stat
            # (shared with price_american_richardson).
            from options_model_tpu.pricers.american import richardson_cv_stat
            eff_lsm = lsm.replace(
                use_control_variate=use_control_variate and cv_leg,
                out_of_sample=oos)
            stat, mask_r = richardson_cv_stat(S_paths, v_paths, spec, T,
                                              eff_lsm, heston=heston,
                                              merton=merton, bates=bates,
                                              vg=vg, model=model,
                                              pair_block=pb)
            price, stderr, _ = masked_mean_stderr(stat, mask_r, None, stat_pb)
            return price, stderr
        if use_control_variate and cv_leg:
            # Same-path European leg + closed form (BS for GBM, COS for
            # Heston/Bates, the Merton series). The stderr is of the per-path
            # CV statistic cash + beta*(EU - pay_T) — the raw LSM stderr
            # would overstate the returned estimator's error by the variance
            # the variate removes
            # (pricers/american.price_american_with_control_variate).
            _, _, (cash, eval_mask) = lsm_poly_backward(
                S_paths, spec, T, poly_degree=degree, out_of_sample=oos,
                pair_block=pb if oos else None,
                return_cash=True, v_paths=v_paths)
            cv = _apply_cv(cash, _cv_adjustment(S_paths, spec, T,
                                                heston=heston, model=model,
                                                merton=merton, bates=bates,
                                                vg=vg),
                           lsm.cv_beta if lsm is not None else "opt",
                           eval_mask, None, stat_pb)
            price, stderr, _ = masked_mean_stderr(cv, eval_mask, None, stat_pb)
            return price, stderr
        return lsm_poly_backward(
            S_paths, spec, T, poly_degree=degree, out_of_sample=oos,
            pair_block=pb if oos else None,
            stat_pair_block=stat_pb, v_paths=v_paths)

    def shard_body(S0_l, K_l, T_l, tid_l, key, rate, sigma, heston, table,
                   jump, cp, div_yield):
        return jax.lax.map(
            lambda task: price_one(task, key, rate, sigma, heston, table,
                                   jump, cp, div_yield),
            (S0_l, K_l, T_l, tid_l))

    # check_vma=False: tasks are fully independent (no collectives), and the
    # GPU kernel's output avals carry no varying-mesh-axes annotation.
    rep = P()
    return jax.jit(shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis),
                  rep, rep, rep, rep, rep, rep, rep, rep),
        out_specs=(P(axis), P(axis)), check_vma=False,
    ))


def price_american_grid_2d(key: jax.Array, S0s, strikes, taus, rate,
                           mc: MCConfig, mesh: Mesh, *, cp: float = -1.0,
                           sigma=None, heston: Optional[HestonParams] = None,
                           merton=None, bates=None, vg=None,
                           model: str = "gbm", heston_scheme: str = "euler",
                           use_control_variate: bool = False,
                           european_approximation: bool = False,
                           lsm: Optional[LSMConfig] = None,
                           div_yield: float = 0.0,
                           task_ids=None, return_stderr: bool = False,
                           task_axis: str = "tasks",
                           path_axis: str = "paths",
                           engine: str = "xla"):
    """American grid pricing on a 2-D (tasks x paths) mesh (SURVEY.md §2.2):
    the option grid shards over ``task_axis``
    while every task's Monte-Carlo paths shard over ``path_axis`` with
    psum-exact per-date regression Grams (regressors.masked_wls).

    RNG discipline: each task folds the base key by its GLOBAL task id, and
    each path shard simulates its global block range (first_block = rank *
    blocks_per_dev) — so prices are invariant to the mesh factorization
    ((1,8), (2,4), (4,2), ...) and equal the 1-D task-sharded and unsharded
    results with the same totals (tested in tests/test_parallel.py).

    Returns prices (n_tasks,) [and stderrs with return_stderr]; stderrs are
    over antithetic pair means of the evaluated statistic.

    ``european_approximation``: discounted terminal-payoff mean instead of
    the American backward (the reference's streaming-mode shortcut) — the
    per-shard partial means psum over ``path_axis``.
    """
    if model not in ("gbm", "heston", "merton", "bates", "vg"):
        raise ValueError(
            "price_american_grid_2d supports gbm/heston/merton/bates/vg "
            "(localvol tables have no global-block-index XLA stream), "
            f"got {model!r}")
    S0s = jnp.asarray(S0s, jnp.float32)
    strikes = jnp.asarray(strikes, jnp.float32)
    taus = jnp.asarray(taus, jnp.float32)
    n_tasks = S0s.shape[0]
    n_task_dev = mesh.shape[task_axis]
    # (the path-sharding geometry — blocks per device, local config — lives
    # in _grid_2d_impl, the single owner of that derivation)

    def pad(x):
        return pad_to_multiple(x, n_task_dev)

    S0p, Kp, Tp = pad(S0s), pad(strikes), pad(taus)
    if task_ids is None:
        task_ids = jnp.arange(n_tasks)
    task_ids = pad(jnp.asarray(task_ids, jnp.int32))

    degree = lsm.poly_degree if lsm is not None else 3
    if lsm is not None and lsm.regressor != "poly":
        raise ValueError("price_american_grid_2d supports the poly regressor "
                         "(path-sharded Grams psum exactly; the nn two-pass "
                         "scheme has no sharded-fit variant)")
    if lsm is not None and lsm.out_of_sample:
        raise ValueError("out_of_sample is not supported on the 2-D mesh "
                         "(the alternating-block split is defined on the "
                         "global path stream; use price_american_grid)")
    from options_model_tpu.ops.engine import resolve_engine
    resolve_engine(engine)
    fn = _grid_2d_impl(mc, mesh, model, heston_scheme, use_control_variate,
                       degree, task_axis, path_axis,
                       sigma is not None, heston is not None,
                       lsm.variance_basis if lsm is not None else True,
                       lsm.richardson if lsm is not None else False,
                       european_approximation,
                       merton is not None, bates is not None,
                       vg is not None)
    sigma_a = jnp.float32(0.0) if sigma is None else jnp.asarray(
        sigma, jnp.float32)
    heston_a = (HestonParams(kappa=1.0, theta=0.04, xi=0.1, rho=0.0, v0=0.04)
                if heston is None else heston)
    jump_a = _jump_args(merton, bates, vg)
    prices, stderrs = fn(S0p, Kp, Tp, task_ids, key, jnp.float32(rate),
                         sigma_a, heston_a, jump_a, jnp.float32(cp),
                         jnp.float32(div_yield))
    if return_stderr:
        return prices[:n_tasks], stderrs[:n_tasks]
    return prices[:n_tasks]


@functools.lru_cache(maxsize=256)
def _grid_2d_impl(mc: MCConfig, mesh: Mesh, model: str, heston_scheme: str,
                  use_control_variate: bool, degree: int, task_axis: str,
                  path_axis: str, has_sigma: bool, has_heston: bool,
                  variance_basis: bool = True, richardson: bool = False,
                  european_approximation: bool = False,
                  has_merton: bool = False, has_bates: bool = False,
                  has_vg: bool = False):
    """Compile-cached body of price_american_grid_2d."""
    n_path_dev = mesh.shape[path_axis]
    nb_total, per_dev = _path_shard_geometry(mc, n_path_dev)
    local_cfg = mc.replace(n_paths=per_dev * mc.path_block)

    def price_one(task, key, rate, sigma, heston, jump, cp, div_yield):
        from options_model_tpu.core.stats import masked_mean_stderr
        from options_model_tpu.pricers.american import (_apply_cv,
                                                        _cv_adjustment)

        sigma = sigma if has_sigma else None
        heston = heston if has_heston else None
        merton = jump[0] if has_merton else None
        bates = jump[1] if has_bates else None
        vg = jump[2] if has_vg else None
        S0, K, T, tid = task
        task_key = jax.random.fold_in(key, tid.astype(jnp.int32))
        rank = jax.lax.axis_index(path_axis)
        spec = OptionSpec(strike=K, rate=rate, cp=cp, sigma=sigma,
                          div_yield=div_yield)
        want_v = (((model == "heston" and has_heston)
                   or (model == "bates" and has_bates))
                  and variance_basis and not european_approximation)
        # Mesh-shape invariance comes from GLOBAL stream indexing: every
        # simulator keys threefry by global block index, the compound-jump
        # draws included (models/{merton,bates}.py, chunk invariance tested).
        out = simulate_paths(task_key, S0, T, local_cfg, model,
                             sigma=sigma, rate=rate, heston=heston,
                             merton=merton, bates=bates, vg=vg,
                             first_block=rank * per_dev,
                             heston_scheme=heston_scheme,
                             div_yield=div_yield, return_variance=want_v)
        S_paths, v_paths = out if want_v else (out, None)
        stat_pb = mc.path_block if mc.antithetic else None
        if european_approximation:
            # Discounted terminal payoff, partial means psum'ed across the
            # path axis (same semantics as _grid_impl's branch, here with
            # the cross-shard reduction).
            disc_T = jnp.exp(-jnp.asarray(rate, S_paths.dtype) * T)
            pay = vanilla_payoff(S_paths[-1], K, cp) * disc_T
            price, stderr, _ = masked_mean_stderr(pay, None, path_axis,
                                                  stat_pb)
            return price, stderr
        cv_leg = ((has_sigma and model == "gbm")
                  or (model == "heston" and has_heston)
                  or (model == "merton" and has_merton)
                  or (model == "bates" and has_bates)
                  or (model == "vg" and has_vg))
        if richardson:
            from options_model_tpu.pricers.american import richardson_cv_stat
            from options_model_tpu.core.config import LSMConfig as _L
            eff_lsm = _L(poly_degree=degree,
                         use_control_variate=use_control_variate and cv_leg)
            stat, mask_r = richardson_cv_stat(S_paths, v_paths, spec, T,
                                              eff_lsm, heston=heston,
                                              merton=merton, bates=bates,
                                              vg=vg, model=model,
                                              axis_name=path_axis)
            price, stderr, _ = masked_mean_stderr(stat, mask_r, path_axis,
                                                  stat_pb)
            return price, stderr
        if use_control_variate and cv_leg:
            _, _, (cash, eval_mask) = lsm_poly_backward(
                S_paths, spec, T, axis_name=path_axis, poly_degree=degree,
                return_cash=True, v_paths=v_paths)
            # psum-exact beta (axis_name): every path shard applies the
            # GLOBAL variance-minimizing coefficient.
            cv = _apply_cv(cash, _cv_adjustment(S_paths, spec, T,
                                                heston=heston, model=model,
                                                merton=merton, bates=bates,
                                                vg=vg),
                           "opt", eval_mask, path_axis, stat_pb)
            price, stderr, _ = masked_mean_stderr(cv, eval_mask, path_axis,
                                                  stat_pb)
            return price, stderr
        return lsm_poly_backward(S_paths, spec, T, axis_name=path_axis,
                                 poly_degree=degree, stat_pair_block=stat_pb,
                                 v_paths=v_paths)

    def shard_body(S0_l, K_l, T_l, tid_l, key, rate, sigma, heston, jump, cp,
                   div_yield):
        return jax.lax.map(
            lambda task: price_one(task, key, rate, sigma, heston, jump, cp,
                                   div_yield),
            (S0_l, K_l, T_l, tid_l))

    rep = P()
    return jax.jit(shard_map(
        shard_body, mesh=mesh,
        in_specs=(P(task_axis), P(task_axis), P(task_axis), P(task_axis),
                  rep, rep, rep, rep, rep, rep, rep),
        out_specs=(P(task_axis), P(task_axis)), check_vma=False,
    ))


def price_european_sharded(key: jax.Array, S0, T, spec: OptionSpec,
                           mc: MCConfig, mesh: Mesh, *, model: str = "gbm",
                           heston: Optional[HestonParams] = None,
                           merton=None, bates=None, vg=None,
                           engine: str = "xla", axis: str = "paths"):
    """One European pricing with the paths axis sharded across the mesh.

    Each device simulates its own global block range (first_block = rank *
    blocks_per_dev) and the Welford partials psum — bitwise equal to the
    single-device result with the same total path count: every sampler,
    the GPU kernel included, keys its stream by global block. Returns
    (price, stderr, n).
    """
    n_dev = mesh.devices.size
    nb_total, per_dev = _path_shard_geometry(mc, n_dev)
    local_cfg = mc.replace(n_paths=per_dev * mc.path_block)
    sampler = make_terminal_sampler(model, S0, spec.rate, T, sigma=spec.sigma,
                                    heston=heston, merton=merton,
                                    bates=bates, vg=vg, engine=engine,
                                    div_yield=spec.div_yield)
    discount = jnp.exp(-jnp.asarray(spec.rate, mc.dtype) * jnp.asarray(T, mc.dtype))

    def body():
        rank = jax.lax.axis_index(axis)
        S_T = sampler(key, rank * per_dev, local_cfg)
        payoffs = vanilla_payoff(S_T, spec.strike, spec.cp) * discount
        if mc.antithetic:
            # pair means are the i.i.d. unit under antithetic sampling
            # (core/stats.pair_mean_reduce); count reports simulated paths.
            from options_model_tpu.core.stats import pair_mean_reduce
            payoffs = pair_mean_reduce(payoffs, mc.path_block)
        st = welford_psum(welford_from_batch(payoffs), axis)
        n = st.count * (2.0 if mc.antithetic else 1.0)
        return st.mean, st.stderr, n

    # check_vma=False: jax.random.poisson (the jump families' count draw)
    # carries mixed varying/replicated annotations through its internal
    # while_loop, which the static checker rejects; execution is correct
    # (same rule as _grid_impl).
    mean, stderr, n = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(), out_specs=(P(), P(), P()),
        check_vma=False))()
    return mean, stderr, n


def price_american_sharded_paths(key: jax.Array, S0, T, spec: OptionSpec,
                                 mc: MCConfig, mesh: Mesh, *,
                                 model: str = "gbm",
                                 heston: Optional[HestonParams] = None,
                                 merton=None, bates=None, vg=None,
                                 axis: str = "paths",
                                 variance_basis: bool = True,
                                 engine: str = "xla",
                                 heston_scheme: str = "euler"):
    """One American LSM pricing with paths sharded across the mesh.

    Per-date regression Gram blocks psum over the axis (regressors.masked_wls),
    so every device sees the GLOBAL regression. Agreement with the unsharded
    pricing on the same total paths is exact up to the psum's float reduction
    ORDER: the partial-Gram sums differ from the single unsharded matmul in
    the last ulps, which can flip individual boundary exercise decisions
    through the discontinuous max(h, C) rule (measured: usually bitwise,
    occasionally ~1e-3 relative at 8k paths; tests/test_parallel.py).
    Returns (price, stderr); the stderr is over raw samples (callers wanting
    pair discipline use lsm_poly_backward directly with stat_pair_block).
    """
    from options_model_tpu.ops.engine import resolve_engine

    resolve_engine(engine)
    n_dev = mesh.devices.size
    nb_total, per_dev = _path_shard_geometry(mc, n_dev)
    local_cfg = mc.replace(n_paths=per_dev * mc.path_block)

    want_v = ((model == "heston" and heston is not None)
              or (model == "bates" and bates is not None)) and variance_basis

    def body():
        rank = jax.lax.axis_index(axis)
        out = simulate_paths(key, S0, T, local_cfg, model, sigma=spec.sigma,
                             rate=spec.rate, heston=heston, merton=merton,
                             bates=bates, vg=vg,
                             first_block=rank * per_dev,
                             heston_scheme=heston_scheme,
                             div_yield=spec.div_yield, return_variance=want_v)
        S_paths, v_paths = out if want_v else (out, None)
        return lsm_poly_backward(S_paths, spec, T, axis_name=axis,
                                 v_paths=v_paths)

    price, stderr = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(), out_specs=(P(), P()),
        check_vma=False))()
    return price, stderr


def price_american_bracket_sharded(key: jax.Array, S0, T, spec: OptionSpec,
                                   mc: MCConfig, mesh: Mesh, *,
                                   model: str = "gbm",
                                   heston: Optional[HestonParams] = None,
                                   poly_degree: int = 3, n_inner: int = 64,
                                   out_of_sample: bool = True,
                                   axis: str = "paths",
                                   engine: str = "xla"):
    """Primal-dual bracket (pricers/dual.py) with paths sharded on the mesh.

    Equal to the single-device ``price_american_bracket(engine='xla')`` on
    the same total paths (tested at rtol 2e-5 on the virtual mesh): each
    device simulates its own global block range, the policy fit psums its
    Gram blocks (so every device sees the GLOBAL regressions), the
    out-of-sample split keys on the GLOBAL block parity, and the dual's
    inner draws are blocked per global path block (_inner_normals) — rank
    never enters any stream. Returns a BracketResult of scalars.
    """
    from options_model_tpu.core.stats import masked_mean_stderr
    from options_model_tpu.ops.engine import resolve_engine
    from options_model_tpu.pricers.dual import (
        BracketResult, dual_upper_from_policy, fit_lsm_policy)

    use_v = model == "heston"
    if use_v and heston is None:
        raise ValueError("model='heston' needs heston params")
    if not use_v and spec.sigma is None:
        raise ValueError("the one-step dual increments need spec.sigma "
                         "(GBM dynamics)")
    resolve_engine(engine)
    n_dev = mesh.devices.size
    nb_total, per_dev = _path_shard_geometry(mc, n_dev)
    local_cfg = mc.replace(n_paths=per_dev * mc.path_block)
    # Path block: the inner-draw granularity, and the antithetic-pair unit of
    # the outer paths that the OOS split and pair-mean stderrs respect.
    pb = mc.path_block
    stat_pb = pb if mc.antithetic else None
    if out_of_sample and nb_total < 2:
        raise ValueError("out_of_sample needs at least two antithetic-pair "
                         "units of paths")
    sim_key, inner_key = jax.random.split(key)

    def body():
        rank = jax.lax.axis_index(axis)
        first = rank * per_dev
        out = simulate_paths(sim_key, S0, T, local_cfg, model,
                             sigma=spec.sigma, rate=spec.rate, heston=heston,
                             first_block=first,
                             div_yield=spec.div_yield, return_variance=use_v)
        S_paths, v_paths = out if use_v else (out, None)
        n_local = S_paths.shape[1]
        if out_of_sample:
            # Global block parity — NOT the local index: with an odd
            # per-device block count the parity alternates across ranks,
            # and only the global rule reproduces the unsharded split.
            gunit = first + jnp.arange(n_local) // pb
            train_mask = (gunit % 2 == 0).astype(S_paths.dtype)
            eval_mask = 1.0 - train_mask
        else:
            train_mask = eval_mask = jnp.ones((n_local,), S_paths.dtype)
        policy, cash = fit_lsm_policy(S_paths, spec, T,
                                      poly_degree=poly_degree,
                                      train_mask=train_mask, v_paths=v_paths,
                                      axis_name=axis)
        low, low_se, _ = masked_mean_stderr(cash, eval_mask, axis, stat_pb)
        high, high_se = dual_upper_from_policy(
            inner_key, S_paths, spec, T, policy, n_inner=n_inner,
            model=model, heston=heston, v_paths=v_paths, eval_mask=eval_mask,
            stat_pair_block=stat_pb, inner_block=pb, first_block=first,
            axis_name=axis)
        return low, low_se, high, high_se

    low, low_se, high, high_se = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(), out_specs=(P(), P(), P(), P())))()
    return BracketResult(low=low, low_stderr=low_se,
                         high=high, high_stderr=high_se)
