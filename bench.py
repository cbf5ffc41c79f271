"""Benchmark harness for one NVIDIA GPU — prints ONE JSON line.

Headline metric: Heston Monte-Carlo path-steps per second through
``price_european_mc`` (full-truncation Euler, antithetic, 2^22 paths x 100
steps by default) on the default engine (the fused Triton terminal kernel on
a GPU), timed warm with block_until_ready. Details: accuracy legs against
their oracles (CRR, ADI, COS, COS-Bermudan), the curve sweep and the 64x64
Heston surface, all labelled with the card and its power limit.

Refuses to run without a GPU: no number here is ever a CPU number.

Run: python bench.py            (all legs)
     python bench.py --quick    (headline only)
"""

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _timed(fn, *args):
    """Seconds for fn(*args) to finish on the device."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def _card() -> str:
    """'name, power limit' as nvidia-smi reports the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0].strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="skip the accuracy and surface legs")
    ap.add_argument("--paths", type=int, default=1 << 22)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX reports {dev.platform!r}")

    from options_model_tpu.core.config import (
        HestonParams, LSMConfig, MCConfig, OptionSpec, PUT)
    from options_model_tpu.ops.engine import enable_compilation_cache
    from options_model_tpu.pricers.european import (make_terminal_sampler,
                                                    price_european_mc)
    enable_compilation_cache()

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    n_paths, n_steps = args.paths, args.steps
    details = {"card": _card(), "platform": dev.platform,
               "device_kind": dev.device_kind,
               "device_count": len(jax.devices()),
               "n_paths": n_paths, "n_steps": n_steps}

    cfg = MCConfig(n_paths=n_paths, n_steps=n_steps, path_block=4096)
    call = OptionSpec(strike=100.0, rate=0.05, cp=1.0, sigma=None)
    sampler = make_terminal_sampler("heston", 100.0, 0.05, 1.0, heston=hp)
    heston_eu = jax.jit(lambda k: price_european_mc(k, sampler, call, 1.0,
                                                    cfg)[:2])
    _timed(heston_eu, jax.random.key(0))  # compile
    dt = min(_timed(heston_eu, jax.random.key(s)) for s in range(1, 6))
    heston_rate = n_paths * n_steps / dt

    if not args.quick:
        from options_model_tpu.pricers import crr_american
        from options_model_tpu.pricers.american import price_american_richardson
        spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
        mc = MCConfig(n_paths=1 << 21, n_steps=50,
                      path_block=4096)
        lsm = LSMConfig(regressor="poly")
        # CV + common-path Richardson extrapolation to the continuous-exercise
        # limit (an n-date LSM prices a Bermudan; the date gap alone is -0.13%
        # at 50 dates — see pricers/american.price_american_richardson).
        price, _ = price_american_richardson(
            jax.random.key(2026), 100.0, 0.5, spec, mc, lsm)
        oracle = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0, n_steps=4096)
        details["american_put_rel_err_vs_crr"] = round(
            abs(float(price) - oracle) / oracle, 6)
        details["american_put_lsm_cv_richardson"] = round(float(price), 6)
        details["american_put_crr"] = round(oracle, 6)

        # Heston American vs the GRID-EXTRAPOLATED ADI oracle: the (300,150,300) grid is itself ~0.15% LOW (measured
        # convergence order p~1.7 over grids 300/450/600/900; the 300/600
        # and 600/900 Richardson extrapolations agree at 4.59247+-3e-4), and
        # r3's "0.159% error" compared a 50-date Bermudan (-0.13% date-gap
        # bias) against that unconverged grid — two partially cancelling
        # biases. Both sides converge now: common-path Richardson + CV +
        # (S,v) basis on the MC side, two-grid h^1.7 extrapolation on the
        # PDE side.
        from options_model_tpu.pricers.american import price_american_richardson
        from options_model_tpu.pricers.fd_heston import heston_fd_price
        spec_h = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
        # POOLED seeds: the single-seed leg could never
        # demonstrate the <=0.1% bar it checks (r1-r4 printed 0.16-0.21%).
        # 4 seeds x 2^20 paths -> pooled stderr ~0.04%, and the
        # pooled mean is the bias statistic. The estimator runs the
        # deg-5 x cubic-(u,w) basis: the r5 decomposition isolated the old
        # -0.165% as pure POLICY bias (LSM Bermudan@50 vs the date-matched
        # extrapolated ADI Bermudan was -0.153%; the date-Richardson is
        # exact to +0.004% on the PDE itself; Euler-vs-QE and 50-vs-100
        # steps moved nothing), and the richer basis — made safe by the
        # _BASIS_CLAMP tail guard — recovers it: pooled 6-seed measurement
        # -0.056% +- 0.035% (deg3/vdeg2 -0.168%, deg3/vdeg3 -0.131%,
        # deg5/vdeg3 -0.056%).
        n_seeds = 4
        mc_h = MCConfig(n_paths=1 << 20, n_steps=50,
                        path_block=4096)
        lsm_h = LSMConfig(regressor="poly", poly_degree=5,
                          variance_basis_degree=3)
        ps_h, ses_h = [], []
        for s in range(n_seeds):
            p_s, se_s = price_american_richardson(
                jax.random.fold_in(jax.random.key(2026), s), 100.0, 0.5,
                spec_h, mc_h, lsm_h, model="heston", heston=hp,
                engine="xla")
            ps_h.append(float(p_s))
            ses_h.append(float(se_s))
        p_h = float(np.mean(ps_h))
        pooled_se = float(np.sqrt(np.sum(np.square(ses_h)))) / n_seeds
        details["heston_american_mc_stderr_pct"] = round(
            pooled_se / p_h * 100.0, 4)
        details["heston_american_pooled_seeds"] = n_seeds
        details["heston_american_seed_spread_pct"] = round(
            float(np.std(ps_h)) / p_h * 100.0, 4)
        fd_coarse = heston_fd_price(100.0, 100.0, 0.5, 0.05, hp, cp=-1.0,
                                    american=True, n_s=300, n_v=150, n_t=300)
        fd_fine = heston_fd_price(100.0, 100.0, 0.5, 0.05, hp, cp=-1.0,
                                  american=True, n_s=600, n_v=300, n_t=600)
        p_order = 1.7
        fd = fd_fine + (fd_fine - fd_coarse) / (2.0 ** p_order - 1.0)
        # signed pooled bias; the tolerance on it composes the pooled MC
        # stderr with the oracle's own extrapolation uncertainty (the
        # 300/600 vs 600/900 Richardson disagreement, +-3e-4 absolute)
        details["heston_american_rel_err_vs_fd"] = round(
            abs(p_h - fd) / fd, 6)
        details["heston_american_rel_err_signed_pct"] = round(
            (p_h / fd - 1.0) * 100.0, 4)
        details["heston_american_fd_extrap_uncertainty_pct"] = round(
            3e-4 / fd * 100.0, 4)
        details["heston_american_fd_oracle"] = round(fd, 6)
        details["heston_american_fd_grids"] = [round(fd_coarse, 6),
                                               round(fd_fine, 6)]

        # Primal-dual bracket (Rogers martingale dual, pricers/dual.py):
        # [low, high] bounds the 50-date Bermudan value from BOTH sides on
        # one simulation — the bracket width is a measured bound on the
        # estimator BIAS, beyond any point estimate's reach.
        from options_model_tpu.pricers import price_american_bracket
        br = price_american_bracket(
            jax.random.key(11), 100.0, 0.5, spec,
            MCConfig(n_paths=1 << 18, n_steps=50,
                     path_block=4096), engine="xla")
        details["american_put_dual_upper_rel_vs_crr"] = round(
            float(br.high) / oracle - 1.0, 6)
        details["american_put_bracket_width_pct"] = round(
            (float(br.high) - float(br.low)) / oracle * 100.0, 4)

        # Heston bracket: variance-basis policy + Euler-replicating inner
        # sampler; the ADI oracle (computed above) anchors the tightness.
        br_h = price_american_bracket(
            jax.random.key(12), 100.0, 0.5,
            OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None),
            MCConfig(n_paths=1 << 17, n_steps=50,
                     path_block=4096), engine="xla",
            model="heston", heston=hp)
        details["heston_put_dual_upper_rel_vs_fd"] = round(
            float(br_h.high) / fd - 1.0, 6)
        details["heston_put_bracket_width_pct"] = round(
            (float(br_h.high) - float(br_h.low)) / fd * 100.0, 4)

        # The reference's FLAGSHIP estimator: control variate around the
        # shared continuation NETWORK (options_model_3.py:653-677).
        from options_model_tpu.pricers.american import (
            price_american_with_control_variate)
        p_nn, _ = price_american_with_control_variate(
            jax.random.key(2026), 100.0, 0.5, spec,
            MCConfig(n_paths=1 << 18, n_steps=50,
                     path_block=4096),
            LSMConfig(regressor="nn"), engine="xla")
        details["american_put_nn_rel_err_vs_crr"] = round(
            abs(float(p_nn) - oracle) / oracle, 6)
        details["american_put_nn_cv"] = round(float(p_nn), 6)

        # Randomized-QMC vs plain MC at EQUAL path budget (scrambled Sobol +
        # Brownian bridge, pricers/qmc.py — beyond reference). The Asian
        # average is the showcase: a smooth low-effective-dimension payoff
        # where RQMC's O(N^-1) discrepancy beats MC's O(N^-1/2).
        from options_model_tpu.pricers.exotics import price_asian_mc
        from options_model_tpu.pricers.qmc import price_asian_qmc
        q_paths = 1 << 14
        q_reps = 8
        p_q, se_q, _ = price_asian_qmc(17, 100.0, 0.5, spec,
                                       n_paths=q_paths, n_steps=50,
                                       replicates=q_reps)
        p_a, se_a = price_asian_mc(
            jax.random.key(17), 100.0, 0.5, spec,
            MCConfig(n_paths=q_reps * q_paths, n_steps=50, path_block=4096))
        details["qmc_asian_stderr_ratio_vs_mc"] = round(
            float(se_a) / max(float(se_q), 1e-12), 2)
        details["qmc_asian_price"] = round(float(p_q), 6)
        # BOTH pricers carry the Kemna-Vorst variate since r2+, so the ratio
        # above is RQMC's edge on the CV RESIDUAL (rough, high effective
        # dimension). The raw-integrand ratio and the combined
        # RQMC+CV-vs-raw-MC ratio tell the full story
        # (scripts/exp_qmc_ratio.py).
        p_q0, se_q0, _ = price_asian_qmc(17, 100.0, 0.5, spec,
                                         n_paths=q_paths, n_steps=50,
                                         replicates=q_reps,
                                         control_variate="off")
        p_a0, se_a0 = price_asian_mc(
            jax.random.key(17), 100.0, 0.5, spec,
            MCConfig(n_paths=q_reps * q_paths, n_steps=50, path_block=4096),
            control_variate="off")
        details["qmc_asian_stderr_ratio_raw"] = round(
            float(se_a0) / max(float(se_q0), 1e-12), 2)
        details["qmc_asian_stderr_ratio_qmccv_vs_rawmc"] = round(
            float(se_a0) / max(float(se_q), 1e-12), 2)

        # RQMC on the newest family: the rBergomi
        # hybrid scheme consumes 3*n_steps normals; the two Brownian
        # factors ride the bridge on the interleaved leading dims, the
        # singular-interval corrections take the tail raw. Both ratios per
        # the r4 lesson: raw payoff, and on the conditional-Black CV
        # residual (CV composed on BOTH sides at beta=1).
        from options_model_tpu.core.config import RBergomiParams
        from options_model_tpu.models.rbergomi import rbergomi_european_mc
        from options_model_tpu.pricers.qmc import price_european_qmc
        rb_q = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
        rq_steps = 64
        mc_rb = MCConfig(n_paths=q_reps * q_paths, n_steps=rq_steps,
                         path_block=4096)
        _, se_rq, _ = price_european_qmc(
            17, "rbergomi", 100.0, spec_h, 0.5, rbergomi=rb_q,
            n_paths=q_paths, n_steps=rq_steps, replicates=q_reps)
        _, se_rq0, _ = price_european_qmc(
            17, "rbergomi", 100.0, spec_h, 0.5, rbergomi=rb_q,
            n_paths=q_paths, n_steps=rq_steps, replicates=q_reps,
            rbergomi_cv=False)
        p_rm, se_rm = rbergomi_european_mc(
            jax.random.key(17), 100.0, 100.0, 0.05, 0.5, rb_q, mc_rb,
            cp=-1.0)
        _, se_rm0 = rbergomi_european_mc(
            jax.random.key(17), 100.0, 100.0, 0.05, 0.5, rb_q, mc_rb,
            cp=-1.0, control_variate=False)
        details["qmc_rbergomi_stderr_ratio_raw"] = round(
            float(se_rm0) / max(float(se_rq0), 1e-12), 2)
        details["qmc_rbergomi_stderr_ratio_vs_mc"] = round(
            float(se_rm) / max(float(se_rq), 1e-12), 2)

        # Synthetic Heston calibration round trip:
        # wall time + recovered-parameter RMSE. The objective runs in f64
        # (on CPU where the accelerator toolchain lacks complex128 — see
        # calibrator._make_objective's root-cause note).
        from options_model_tpu.calibration import (
            calibrate_heston_to_data, create_synthetic_heston_surface)
        cal_true = HestonParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6,
                                v0=0.045)
        # f64 data: measure the OBJECTIVE's floor, not the f32 data's
        # rounding floor (see synthetic.create_synthetic_heston_surface).
        # Record which oracle actually ran — on a JAX build without
        # explicit-x64 dtypes the generator degrades to f32 (and warns), and
        # the RMSE legs then measure the data's rounding, not the objective.
        from options_model_tpu.calibration.calibrator import (
            _try_enable_explicit_x64)
        details["calibration_oracle_dtype"] = (
            "float64" if _try_enable_explicit_x64() else "float32")
        Kc, Tc, ivc = create_synthetic_heston_surface(cal_true,
                                                      dtype=np.float64)
        t0 = time.perf_counter()
        fit, summary = calibrate_heston_to_data(Kc, Tc, ivc, 100.0, 0.05)
        dt_cal = time.perf_counter() - t0
        rel = np.array([fit.kappa / cal_true.kappa - 1.0,
                        fit.theta / cal_true.theta - 1.0,
                        fit.xi / cal_true.xi - 1.0,
                        fit.rho / cal_true.rho - 1.0,
                        fit.v0 / cal_true.v0 - 1.0])
        details["calibration_seconds"] = round(dt_cal, 2)
        details["calibration_param_rel_rmse"] = round(
            float(np.sqrt(np.mean(rel ** 2))), 6)
        details["calibration_iv_rmse"] = round(float(summary["error"]), 8)

        # Calibration under quote noise: 0.5-vol-point
        # gaussian noise on the same synthetic surface. kappa is reported
        # SEPARATELY: the mean-reversion speed is the classically weak
        # direction (it wanders at the same objective height), so averaging
        # it into the RMSE would hide the four identified parameters'
        # recovery (tests/test_calibration.py::TestNoisyCalibration measures
        # the identification structure).
        Kn, Tn, ivn = create_synthetic_heston_surface(
            cal_true, noise_std=0.005, seed=7, dtype=np.float64)
        fit_n, summary_n = calibrate_heston_to_data(Kn, Tn, ivn, 100.0, 0.05)
        rel_n = np.array([fit_n.theta / cal_true.theta - 1.0,
                          fit_n.xi / cal_true.xi - 1.0,
                          fit_n.rho / cal_true.rho - 1.0,
                          fit_n.v0 / cal_true.v0 - 1.0])
        details["calibration_noisy_param_rmse"] = round(
            float(np.sqrt(np.mean(rel_n ** 2))), 6)
        details["calibration_noisy_kappa_rel_err"] = round(
            abs(fit_n.kappa / cal_true.kappa - 1.0), 6)
        details["calibration_noisy_iv_rmse"] = round(
            float(summary_n["error"]), 8)

        # rBergomi calibration round trip: no char-fn
        # exists for H<1/2, so the objective prices by jitted hybrid-scheme
        # MC with the conditional-Black CV under CRN; (H, eta) ride the
        # TANGENT ATM-skew term structure (quadratic fit — the wide-window
        # secant reads 3x flat at short expiry and drags H to ~0.25).
        from options_model_tpu.calibration import (
            calibrate_rbergomi_to_data, create_synthetic_rbergomi_surface)
        from options_model_tpu.core.config import RBergomiParams
        rb_true = RBergomiParams(H=0.1, eta=1.5, rho=-0.7, xi0=0.04)
        K_rb, T_rb, iv_rb = create_synthetic_rbergomi_surface(rb_true)
        t_rb = time.perf_counter()
        rb_fit, rb_summ = calibrate_rbergomi_to_data(
            K_rb, T_rb, iv_rb, 100.0, 0.05, rho=-0.7)
        details["calibration_rbergomi_seconds"] = round(
            time.perf_counter() - t_rb, 2)
        details["calibration_rbergomi_H_rel_err"] = round(
            abs(rb_fit.H / rb_true.H - 1.0), 4)
        details["calibration_rbergomi_eta_rel_err"] = round(
            abs(rb_fit.eta / rb_true.eta - 1.0), 4)
        details["calibration_rbergomi_xi0_rel_err"] = round(
            abs(rb_fit.xi0 / rb_true.xi0 - 1.0), 4)
        details["calibration_rbergomi_iv_rmse"] = round(
            float(rb_summ["error"]), 6)

        # Bates SVJ (beyond reference): the independent jump overlay composes
        # with the fused QE-M Heston kernel; accuracy pinned to the
        # factorized COS closed form (models/bates.py, charfn.bates_cos_price).
        from options_model_tpu.calibration import bates_cos_price
        from options_model_tpu.core.config import BatesParams
        from options_model_tpu.pricers.american import (
            price_american_with_control_variate)
        from options_model_tpu.pricers.european import (
            make_terminal_sampler, price_european_mc)
        bp = BatesParams(heston=hp, lam=0.3, mu_j=-0.1, sigma_j=0.15)
        spec_j = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
        cos_b = float(bates_cos_price(100.0, 100.0, 0.5, 0.05, bp, cp=-1.0))
        mc_b = MCConfig(n_paths=1 << 20, n_steps=50,
                        path_block=4096)
        sampler_b = make_terminal_sampler("bates", 100.0, 0.05, 0.5,
                                          bates=bp, heston_scheme="qe")
        p_be, se_be, _ = price_european_mc(jax.random.key(31), sampler_b,
                                           spec_j, 0.5, mc_b)
        details["bates_european_z_vs_cos"] = round(
            (float(p_be) - cos_b) / max(float(se_be), 1e-12), 2)
        details["bates_european_cos"] = round(cos_b, 6)
        p_ba, se_ba = price_american_with_control_variate(
            jax.random.key(32), 100.0, 0.5, spec_j,
            MCConfig(n_paths=1 << 17, n_steps=50,
                     path_block=4096),
            LSMConfig(regressor="poly"), model="bates", bates=bp,
            engine="xla")
        details["bates_american_lsm_cv"] = round(float(p_ba), 6)
        # early-exercise premium must be non-negative (within noise)
        details["bates_american_premium_z"] = round(
            (float(p_ba) - cos_b) / max(float(se_ba), 1e-12), 2)

        # Merton American vs the Fang-Oosterlee Bermudan-COS oracle at
        # MATCHED exercise dates (pricers/cos_bermudan.py) — the Levy
        # analogue of heston_american_rel_err_vs_fd.
        from options_model_tpu.core.config import MertonParams
        from options_model_tpu.pricers.cos_bermudan import cos_bermudan_price
        mp_b = MertonParams(sigma=0.2, lam=1.0, mu_j=-0.10, sigma_j=0.15)
        # POOLED seeds. The r5 budget decomposition: the
        # COS oracle is truncation-stable to 1e-6 across (n_terms, L) in
        # {512..2048}x{10..14}; the deg-3 estimator carries the SAME
        # under-resolved-boundary policy bias as Heston's (~-0.14% pooled
        # over two 4-seed families at 2^18); the clamp-enabled deg-5 basis
        # removes it (measured 0.011% pooled, 0.036% spread — r4's
        # recorded single-seed 0.48% was that bias plus a 2-sigma draw).
        ps_mj = []
        for s in range(4):
            p_mj, _ = price_american_with_control_variate(
                jax.random.fold_in(jax.random.key(33), s), 100.0, 0.5,
                OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2),
                MCConfig(n_paths=1 << 18, n_steps=50,
                         path_block=4096),
                LSMConfig(regressor="poly", poly_degree=5), model="merton",
                merton=mp_b, engine="xla")
            ps_mj.append(float(p_mj))
        berm_mj = cos_bermudan_price(100.0, 100.0, 0.5, 0.05, "merton",
                                     merton=mp_b, cp=-1.0, n_dates=50)
        details["merton_american_rel_err_vs_cos_bermudan"] = round(
            abs(float(np.mean(ps_mj)) - berm_mj) / berm_mj, 6)
        details["merton_american_seed_spread_pct"] = round(
            float(np.std(ps_mj)) / berm_mj * 100.0, 4)
        details["merton_american_cos_bermudan_oracle"] = round(berm_mj, 6)

    if not args.quick:
        # The reference's flagship workload: an S0-grid x days-to-expiry
        # American curve sweep (ProcessPoolExecutor fan-out there;
        # spot-homogeneity shared paths here). Warm-timed second call.
        from options_model_tpu.apps.curves import CurveRequest, compute_curves
        req_kw = dict(s0_list=[float(s) for s in range(90, 112, 2)],
                      strike=100.0, rate=0.05, cp=-1.0, intervals_per_day=1,
                      total_points=8, num_simulations=262_144, sigma=0.2)
        compute_curves(CurveRequest(seed=1, **req_kw))  # compile
        t0 = time.perf_counter()
        df_sweep = compute_curves(CurveRequest(seed=2, **req_kw))
        dt_sw = time.perf_counter() - t0
        details["curve_sweep_cells_per_sec"] = round(len(df_sweep) / dt_sw)
        details["curve_sweep_cells"] = len(df_sweep)

        # 64x64 strike x maturity American grid under Heston, all strikes
        # sharing one path matrix per maturity.
        from options_model_tpu.pricers.surface_american import (
            price_american_surface)
        Ks = jnp.linspace(70.0, 130.0, 64)
        Ts = jnp.linspace(0.1, 1.0, 64)
        mcfg = MCConfig(n_paths=16384, n_steps=50, path_block=4096)
        run = lambda s: price_american_surface(
            jax.random.key(s), 100.0, Ks, Ts, 0.05, mcfg, cp=-1.0, heston=hp)
        _timed(run, 0)  # compile
        dt64 = _timed(run, 1)
        details["american_64x64_heston_grid_seconds"] = round(dt64, 2)
        details["american_options_per_sec"] = round(64 * 64 / dt64)

    print(json.dumps({
        "metric": "heston_european_path_steps_per_sec",
        "value": round(heston_rate),
        "unit": "path-steps/s",
        "details": details,
    }))


if __name__ == "__main__":
    main()
