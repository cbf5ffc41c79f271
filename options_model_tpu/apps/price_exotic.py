"""Exotic & multi-asset pricing CLI — every beyond-vanilla pricer reachable.

    python -m options_model_tpu.apps.price_exotic asian --spot 100 \
        --strike 100 --t 0.5 --sampler sobol
    python -m options_model_tpu.apps.price_exotic barrier --barrier 120 \
        --barrier-type up-out --continuity-correction
    python -m options_model_tpu.apps.price_exotic basket \
        --spots 100 95 110 --sigmas 0.2 0.3 0.25 --rho 0.5
    python -m options_model_tpu.apps.price_exotic american-basket \
        --spots 100 100 --sigmas 0.2 0.2 --rho 0.0 --q 0.10 \
        --kind max --t 3.0 --steps 9      # Andersen-Broadie benchmark cell

The reference gestured at an exotic pricer but shipped a stub
(options_model_2.py:61-79); here Asian/lookback/barrier (single-asset, any
dynamics family) and European/American baskets, rainbows and spreads
(correlated multi-asset GBM) all price from one command, with Sobol RQMC
(``--sampler sobol``) available on the Asian/European legs.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from options_model_tpu.core.config import (
    HestonParams, MCConfig, OptionSpec, cp_from_str)
from options_model_tpu.utils.logging import get_logger

log = get_logger(__name__)

_DEF_HESTON = (2.0, 0.04, 0.3, -0.7, 0.04)


def _add_common(p, multi=False):
    p.add_argument("--strike", type=float, default=100.0)
    p.add_argument("--t", type=float, default=0.5, help="Maturity in years")
    p.add_argument("--r", type=float, default=0.05)
    p.add_argument("--q", type=float, default=0.0,
                   help="Continuous dividend yield")
    p.add_argument("--option-type", type=str, default="call",
                   choices=["call", "put"])
    p.add_argument("--paths", type=int, default=1 << 16)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=2026)
    if multi:
        p.add_argument("--spots", type=float, nargs="+", required=True)
        p.add_argument("--sigmas", type=float, nargs="+", required=True)
        p.add_argument("--weights", type=float, nargs="+", default=None,
                       help="Basket weights (default: equal)")
        p.add_argument("--rho", type=float, default=0.5,
                       help="Uniform pairwise correlation (or --corr)")
        p.add_argument("--corr", type=float, nargs="+", default=None,
                       help="Full row-major correlation matrix (n*n values)")
    else:
        p.add_argument("--spot", type=float, default=100.0)
        p.add_argument("--sigma", type=float, default=0.2)
        p.add_argument("--model", type=str, default="gbm",
                       choices=["gbm", "heston", "merton", "bates", "sabr",
                                "vg", "rbergomi"],
                       help="sabr/rbergomi cover the european and american "
                            "contracts (the american legs regress on the "
                            "(S, alpha) / (S, v) state; anchored by the "
                            "ADI oracle pricers/fd_sabr.py — for rbergomi "
                            "the rough-vol policy is a documented "
                            "Markovian-projection lower bound, "
                            "models/rbergomi.py)")
        p.add_argument("--sabr", type=float, nargs=4, default=None,
                       metavar=("ALPHA", "BETA", "RHO", "NU"),
                       help="SABR parameters (default: alpha=0.2 beta=1 "
                            "rho=-0.4 nu=0.6)")
        p.add_argument("--rbergomi", type=float, nargs=4, default=None,
                       metavar=("H", "ETA", "RHO", "XI0"),
                       help="rough-Bergomi parameters (default: H=0.1 "
                            "eta=1.5 rho=-0.7 xi0=0.04)")
        p.add_argument("--heston", type=float, nargs=5, default=None,
                       metavar=("KAPPA", "THETA", "XI", "RHO", "V0"))
        p.add_argument("--merton", type=float, nargs=4, default=None,
                       metavar=("SIGMA", "LAM", "MU_J", "SIGMA_J"),
                       help="Merton jump-diffusion parameters (default: "
                            "sigma=0.2 lam=1 mu_j=-0.1 sigma_j=0.15)")
        p.add_argument("--vg", type=float, nargs=3, default=None,
                       metavar=("SIGMA", "THETA", "NU"),
                       help="Variance Gamma parameters (default: sigma=0.18 "
                            "theta=-0.14 nu=0.35)")
        p.add_argument("--bates", type=float, nargs=8, default=None,
                       metavar=("KAPPA", "THETA", "XI", "RHO", "V0", "LAM",
                                "MU_J", "SIGMA_J"),
                       help="Bates SVJ parameters: Heston five + lognormal "
                            "jump triple (default: default Heston + lam=0.3 "
                            "mu_j=-0.1 sigma_j=0.15)")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Price exotic and multi-asset options")
    sub = p.add_subparsers(dest="contract", required=True)

    pa = sub.add_parser("asian", help="Asian (average-price) option")
    _add_common(pa)
    pa.add_argument("--average", type=str, default="arithmetic",
                    choices=["arithmetic", "geometric"])
    pa.add_argument("--strike-type", type=str, default="fixed",
                    choices=["fixed", "floating"])
    pa.add_argument("--sampler", type=str, default="mc",
                    choices=["mc", "sobol", "mlmc"],
                    help="sobol = randomized QMC (scrambled Sobol + "
                         "Brownian bridge; ~10x lower stderr at equal paths); "
                         "mlmc = multilevel MC targeting the CONTINUOUSLY "
                         "monitored average to --eps RMS (gbm/heston)")
    pa.add_argument("--eps", type=float, default=1e-2,
                    help="mlmc target RMS error in price units")

    paa = sub.add_parser("american-asian",
                         help="American Asian option (LSM on the joint "
                              "(S, running-average) state; exercise at "
                              "every monitoring date)")
    _add_common(paa)
    paa.add_argument("--strike-type", type=str, default="fixed",
                     choices=["fixed", "floating"])
    paa.add_argument("--out-of-sample", action="store_true",
                     help="Low-biased estimator (policy fitted on "
                          "alternating path blocks)")
    paa.add_argument("--no-control-variate", action="store_true",
                     help="Disable the geometric-Asian control variate "
                          "(active on gbm + fixed strike)")

    pl = sub.add_parser("lookback", help="Lookback option on the extreme")
    _add_common(pl)
    pl.add_argument("--strike-type", type=str, default="floating",
                    choices=["fixed", "floating"])

    pb = sub.add_parser("barrier", help="Barrier option")
    _add_common(pb)
    pb.add_argument("--barrier", type=float, required=True)
    pb.add_argument("--barrier-type", type=str, default="up-out",
                    choices=["up-in", "up-out", "down-in", "down-out"])
    pb.add_argument("--continuity-correction", action="store_true",
                    help="Brownian-bridge survival weights: price the "
                         "CONTINUOUSLY monitored contract (GBM only)")

    pe = sub.add_parser("european", help="European vanilla (MC or RQMC)")
    _add_common(pe)
    pe.add_argument("--sampler", type=str, default="sobol",
                    choices=["mc", "sobol", "mlmc"],
                    help="mlmc = multilevel MC to --eps RMS accuracy "
                         "(discretization bias included; gbm/heston)")
    pe.add_argument("--eps", type=float, default=1e-2,
                    help="mlmc target RMS error in price units")

    pam = sub.add_parser(
        "american",
        help="American vanilla via LSM+CV; Levy models (gbm/merton/vg) also "
             "report the deterministic Bermudan-COS oracle at matched "
             "exercise dates and its continuous-American limit")
    _add_common(pam)
    pam.add_argument("--richardson", action="store_true",
                     help="Common-path Richardson over the exercise grid "
                          "(targets the CONTINUOUS American)")
    pam.add_argument("--no-oracle", action="store_true",
                     help="Skip the host-side Bermudan-COS oracle columns")
    pam.add_argument("--bracket", action="store_true",
                     help="Also print the primal-dual [low, high] bracket "
                          "(Rogers martingale dual, pricers/dual.py). All "
                          "models incl. sabr (beta=1) and rbergomi — for "
                          "rough vol this is the ONLY certification "
                          "available (no PDE oracle exists for H<1/2; the "
                          "exact inner law rides the frozen Volterra "
                          "history)")

    pv = sub.add_parser("varswap", help="Variance / volatility swap: "
                                        "closed-form fair strikes (QV and "
                                        "log-contract replication) + the "
                                        "discretely monitored MC strikes")
    _add_common(pv)
    pv.add_argument("--var-strike", type=float, default=None,
                    help="Traded variance strike (variance units, e.g. 0.04 "
                         "= 20%% vol): adds the swap PV per unit of variance "
                         "notional")

    pk = sub.add_parser("basket", help="European multi-asset option")
    _add_common(pk, multi=True)
    pk.add_argument("--kind", type=str, default="basket",
                    choices=["basket", "best_of", "worst_of", "spread"])
    pk.add_argument("--no-control-variate", action="store_true",
                    help="Disable the geometric-basket control variate")

    pab = sub.add_parser("american-basket",
                         help="Bermudan multi-asset option (LSM; exercise "
                              "at every simulation step)")
    _add_common(pab, multi=True)
    pab.add_argument("--kind", type=str, default="max",
                     choices=["max", "min", "basket"])
    pab.add_argument("--out-of-sample", action="store_true",
                     help="Low-biased estimator (policy fitted on "
                          "alternating path blocks)")

    return p.parse_args(argv)


def _corr_matrix(args, n):
    if args.corr is not None:
        if len(args.corr) != n * n:
            raise SystemExit(f"--corr needs {n*n} values for {n} assets")
        return np.asarray(args.corr, np.float64).reshape(n, n)
    c = np.full((n, n), float(args.rho))
    np.fill_diagonal(c, 1.0)
    return c


def run(args: argparse.Namespace) -> dict:
    import jax

    key = jax.random.key(args.seed)
    cp = cp_from_str(args.option_type)
    out = {"contract": args.contract, "n_paths": args.paths}

    if args.contract in ("asian", "american-asian", "american", "lookback",
                         "barrier", "european", "varswap"):
        spec = OptionSpec(strike=args.strike, rate=args.r, cp=cp,
                          sigma=args.sigma, div_yield=args.q)
        heston = merton = bates = vg = None
        if getattr(args, "model", "gbm") == "heston":
            hp = args.heston or _DEF_HESTON
            heston = HestonParams(kappa=hp[0], theta=hp[1], xi=hp[2],
                                  rho=hp[3], v0=hp[4])
        elif getattr(args, "model", "gbm") == "merton":
            from options_model_tpu.core.config import MertonParams
            mp = args.merton or (0.2, 1.0, -0.1, 0.15)
            merton = MertonParams(sigma=mp[0], lam=mp[1], mu_j=mp[2],
                                  sigma_j=mp[3]).validate()
        elif getattr(args, "model", "gbm") == "vg":
            from options_model_tpu.core.config import VGParams
            vp = args.vg or (0.18, -0.14, 0.35)
            vg = VGParams(sigma=vp[0], theta=vp[1], nu=vp[2]).validate()
        elif getattr(args, "model", "gbm") == "bates":
            from options_model_tpu.core.config import BatesParams
            bp = args.bates or (*_DEF_HESTON, 0.3, -0.1, 0.15)
            bates = BatesParams(
                heston=HestonParams(kappa=bp[0], theta=bp[1], xi=bp[2],
                                    rho=bp[3], v0=bp[4]),
                lam=bp[5], mu_j=bp[6], sigma_j=bp[7]).validate()
        mc = MCConfig(n_paths=args.paths, n_steps=args.steps,
                      path_block=4096)
        if args.contract == "varswap":
            if args.model == "sabr":
                raise SystemExit("varswap supports gbm/heston/merton/bates")
            from options_model_tpu.pricers.varswap import (
                varswap_mc, varswap_pv, varswap_strike,
                varswap_strike_replication)
            cf = dict(sigma=args.sigma, heston=heston, merton=merton,
                      bates=bates, vg=vg)
            out["var_strike_qv"] = varswap_strike(args.t, args.model, **cf)
            out["var_strike_replication"] = varswap_strike_replication(
                args.t, args.model, **cf)
            out.update(varswap_mc(key, args.spot, args.t, mc, args.model,
                                  sigma=args.sigma, rate=args.r,
                                  div_yield=args.q, heston=heston,
                                  merton=merton, bates=bates, vg=vg))
            # main() prints price/stderr: report the MC variance strike there
            out["price"] = out["var_strike"]
            out["stderr"] = out["var_stderr"]
            if args.var_strike is not None:
                out["pv_per_var_notional"] = varswap_pv(
                    out["var_strike"], args.var_strike, args.t, args.r)
            return out
        if getattr(args, "model", "gbm") == "sabr" and args.contract == "european":
            from options_model_tpu.core.config import SABRParams
            from options_model_tpu.models.sabr import (sabr_bs_price,
                                                       sabr_european_mc)
            sp = args.sabr or (0.2, 1.0, -0.4, 0.6)
            sabr = SABRParams(alpha=sp[0], beta=sp[1], rho=sp[2],
                              nu=sp[3]).validate()
            price, se = sabr_european_mc(
                key, args.spot, args.strike, args.r, args.t, sabr, mc,
                cp=cp, q=args.q)
            import jax.numpy as jnp
            F0 = args.spot * float(jnp.exp((args.r - args.q) * args.t))
            out["hagan_closed_form"] = float(sabr_bs_price(
                F0, args.strike, args.t, args.r, sabr, cp))
            out["price"] = float(price)
            out["stderr"] = float(se)
            return out
        if (getattr(args, "model", "gbm") == "sabr"
                and args.contract not in ("european", "american")):
            raise SystemExit("--model sabr supports the european and "
                             "american contracts")
        if getattr(args, "model", "gbm") == "rbergomi":
            if args.contract not in ("european", "american"):
                raise SystemExit("--model rbergomi supports the european "
                                 "and american contracts")
            if args.contract == "european":
                from options_model_tpu.core.config import RBergomiParams
                rp = args.rbergomi or (0.1, 1.5, -0.7, 0.04)
                rbp = RBergomiParams(H=rp[0], eta=rp[1], rho=rp[2],
                                     xi0=rp[3]).validate()
                if getattr(args, "sampler", "mc") == "sobol":
                    from options_model_tpu.pricers.qmc import (
                        price_european_qmc)
                    price, se, n = price_european_qmc(
                        args.seed, "rbergomi", args.spot, spec, args.t,
                        rbergomi=rbp, n_paths=max(args.paths // 16, 1 << 10),
                        n_steps=args.steps, replicates=16)
                    out["n_paths"] = int(n)
                else:
                    from options_model_tpu.models.rbergomi import (
                        rbergomi_european_mc)
                    price, se = rbergomi_european_mc(
                        key, args.spot, args.strike, args.r, args.t, rbp,
                        mc, cp=cp)
                out["price"] = float(price)
                out["stderr"] = float(se)
                return out
        if getattr(args, "sampler", "mc") == "mlmc":
            if args.model not in ("gbm", "heston"):
                raise SystemExit("--sampler mlmc supports gbm/heston only "
                                 "(jump couplings not implemented)")
            if args.contract == "asian" and (
                    args.average != "arithmetic"
                    or args.strike_type != "fixed"):
                raise SystemExit("--sampler mlmc prices the fixed-strike "
                                 "arithmetic Asian only")
            from options_model_tpu.pricers.mlmc import price_mlmc
            res = price_mlmc(
                key, args.spot, args.strike, args.r, args.t, cp=cp,
                payoff=args.contract, model=args.model, sigma=args.sigma,
                heston=heston, eps=args.eps, q=args.q)
            out.update({
                "price": res.price, "stderr": res.stderr,
                "bias_bound": res.bias_bound, "levels": res.levels,
                "n_per_level": res.n_per_level,
                "alpha": round(res.alpha, 3), "beta": round(res.beta, 3),
                "path_steps": res.cost,
                "mc_path_steps_equiv": res.mc_cost_equiv,
            })
            out["n_paths"] = int(sum(res.n_per_level)) * 2
            return out
        if (getattr(args, "sampler", "mc") == "sobol"
                and args.model in ("merton", "bates", "vg")
                and args.contract == "asian"):
            # European merton/bates/vg RQMC is exact (3 dims / bridged+2
            # dims / 2 dims); the pathwise Asian average has no jump/gamma-
            # bridge construction yet.
            log.info("sobol Asian sampling supports gbm/heston only; using "
                     "mc for %s", args.model)
            args.sampler = "mc"
        if args.contract == "american-asian":
            from options_model_tpu.pricers.american_asian import (
                price_american_asian)
            price, se = price_american_asian(
                key, args.spot, args.t, spec, mc, args.model,
                strike_type=args.strike_type, heston=heston, merton=merton,
                bates=bates, vg=vg, out_of_sample=args.out_of_sample,
                control_variate="off" if args.no_control_variate else "auto")
        elif args.contract == "asian":
            if args.sampler == "sobol":
                from options_model_tpu.pricers.qmc import price_asian_qmc
                price, se, n = price_asian_qmc(
                    args.seed, args.spot, args.t, spec, model=args.model,
                    heston=heston, average=args.average,
                    strike_type=args.strike_type,
                    n_paths=max(args.paths // 16, 1 << 10), n_steps=args.steps,
                    replicates=16)
                out["n_paths"] = int(n)
            else:
                from options_model_tpu.pricers.exotics import price_asian_mc
                price, se = price_asian_mc(
                    key, args.spot, args.t, spec, mc, args.model,
                    average=args.average, strike_type=args.strike_type,
                    heston=heston, merton=merton, bates=bates, vg=vg)
        elif args.contract == "american":
            from options_model_tpu.core.config import LSMConfig
            from options_model_tpu.pricers.american import price_american
            sabr = None
            if args.model == "sabr":
                from options_model_tpu.core.config import SABRParams
                sp = args.sabr or (0.2, 1.0, -0.4, 0.6)
                sabr = SABRParams(alpha=sp[0], beta=sp[1], rho=sp[2],
                                  nu=sp[3]).validate()
            rbergomi = None
            if args.model == "rbergomi":
                from options_model_tpu.core.config import RBergomiParams
                rp = args.rbergomi or (0.1, 1.5, -0.7, 0.04)
                rbergomi = RBergomiParams(H=rp[0], eta=rp[1], rho=rp[2],
                                          xi0=rp[3]).validate()
            price, se = price_american(
                key, args.spot, args.t, spec, mc,
                LSMConfig(richardson=args.richardson), args.model,
                heston=heston, merton=merton, bates=bates, vg=vg, sabr=sabr,
                rbergomi=rbergomi)
            if args.bracket:
                from options_model_tpu.pricers.dual import (
                    price_american_bracket)
                spec_b = spec
                if args.model in ("heston", "bates", "sabr", "rbergomi"):
                    # stochastic-vol duals drive the vol from the state;
                    # spec.sigma must be None there (dual_upper_from_policy)
                    from dataclasses import replace as _replace
                    spec_b = _replace(spec, sigma=None)
                br = price_american_bracket(
                    jax.random.fold_in(key, 99), args.spot, args.t, spec_b,
                    mc, model=args.model, heston=heston, merton=merton,
                    bates=bates, vg=vg, sabr=sabr, rbergomi=rbergomi)
                out["bracket_low"] = float(br.low)
                out["bracket_low_stderr"] = float(br.low_stderr)
                out["bracket_high"] = float(br.high)
                out["bracket_high_stderr"] = float(br.high_stderr)
            if args.model == "sabr" and not args.no_oracle:
                # Deterministic ADI anchor on the (F, alpha) PDE with the
                # spot-payoff projection (pricers/fd_sabr.py) — the SABR
                # analogue of the Heston leg's fd_heston oracle.
                from options_model_tpu.pricers.fd_sabr import sabr_fd_price
                out["sabr_fd_oracle"] = sabr_fd_price(
                    args.spot, args.strike, args.t, args.r, sabr, cp=cp,
                    q=args.q)
            if args.model in ("gbm", "merton", "vg") and not args.no_oracle:
                # Deterministic Fang-Oosterlee anchors (host f64, no MC
                # noise): the matched-dates Bermudan is the LSM's own
                # contract; the Richardson-in-dates limit is the
                # continuous American (pricers/cos_bermudan.py).
                from options_model_tpu.pricers.cos_bermudan import (
                    cos_american_price, cos_bermudan_price)
                okw = dict(sigma=args.sigma, merton=merton, vg=vg, cp=cp,
                           q=args.q)
                out["cos_bermudan_matched_dates"] = cos_bermudan_price(
                    args.spot, args.strike, args.t, args.r, args.model,
                    n_dates=args.steps, **okw)
                out["cos_american"] = cos_american_price(
                    args.spot, args.strike, args.t, args.r, args.model,
                    **okw)
        elif args.contract == "lookback":
            from options_model_tpu.pricers.exotics import price_lookback_mc
            price, se = price_lookback_mc(
                key, args.spot, args.t, spec, mc, args.model,
                strike_type=args.strike_type, heston=heston, merton=merton,
                bates=bates, vg=vg)
        elif args.contract == "barrier":
            from options_model_tpu.pricers.barrier import price_barrier_mc
            price, se = price_barrier_mc(
                key, args.spot, args.t, spec, args.barrier,
                args.barrier_type.replace("-", "-and-"), mc, args.model,
                heston=heston, merton=merton, bates=bates, vg=vg,
                continuity_correction=args.continuity_correction)
        else:  # european
            if args.sampler == "sobol":
                from options_model_tpu.pricers.qmc import price_european_qmc
                price, se, n = price_european_qmc(
                    args.seed, args.model, args.spot, spec, args.t,
                    heston=heston, merton=merton, bates=bates, vg=vg,
                    n_paths=max(args.paths // 16, 1 << 10),
                    n_steps=args.steps, replicates=16)
                out["n_paths"] = int(n)
            else:
                from options_model_tpu.pricers.european import (
                    make_terminal_sampler, price_european_mc)
                sampler = make_terminal_sampler(
                    args.model, args.spot, args.r, args.t,
                    sigma=args.sigma, heston=heston, merton=merton,
                    bates=bates, vg=vg, engine="auto", div_yield=args.q)
                price, se, _ = price_european_mc(key, sampler, spec,
                                                 args.t, mc)
    else:  # multi-asset
        n = len(args.spots)
        if len(args.sigmas) != n:
            raise SystemExit("--spots and --sigmas must have equal length")
        w = args.weights or [1.0 / n] * n
        corr = _corr_matrix(args, n)
        qs = [args.q] * n
        if args.contract == "basket":
            from options_model_tpu.pricers.basket import price_basket_mc
            price, se = price_basket_mc(
                key, args.spots, w, args.strike, args.t, args.r,
                args.sigmas, corr, cp, kind=args.kind, n_paths=args.paths,
                div_yields=qs,
                control_variate=not args.no_control_variate)
        else:
            from options_model_tpu.pricers.american_basket import (
                price_american_basket)
            mc = MCConfig(n_paths=args.paths, n_steps=args.steps,
                          path_block=4096)
            price, se = price_american_basket(
                key, args.spots, args.strike, args.t, args.r, args.sigmas,
                corr, cp, mc, kind=args.kind, weights=w, div_yields=qs,
                out_of_sample=args.out_of_sample)

    out["price"] = float(price)
    out["stderr"] = float(se)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    log.info("%s price = %.6f +/- %.6f  (n=%s)", out["contract"],
             out["price"], out["stderr"], out["n_paths"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
