"""Surface pricing CLI — a strike x maturity grid, user-reachable.

    python -m options_model_tpu.apps.price_surface --spot 100 \
        --k-min 70 --k-max 130 --nk 64 --t-min 0.1 --t-max 1.0 --nt 64 \
        --model heston --style american --csv surface.csv

Prices a full strike x maturity American (shared-path LSM,
pricers/surface_american.py) or European (COS for Heston, exact-terminal MC
for GBM) grid on the default device and writes a tidy CSV (K, T, price[,
iv]). The reference has no surface tool — its closest analogue is pricing
cells one-by-one through worker processes (options_model_3/options_model_3.py:
1044-1056).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from options_model_tpu.core.config import (
    HestonParams, MCConfig, cp_from_str)
from options_model_tpu.utils.logging import get_logger

log = get_logger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        description="Price a strike x maturity option surface")
    p.add_argument("--spot", type=float, default=100.0)
    p.add_argument("--r", type=float, default=0.05)
    p.add_argument("--q", type=float, default=0.0,
                   help="Continuous dividend yield")
    p.add_argument("--option-type", type=str, default="put",
                   choices=["call", "put"])
    p.add_argument("--style", type=str, default="american",
                   choices=["american", "european"])
    p.add_argument("--model", type=str, default="heston",
                   choices=["gbm", "heston"])
    p.add_argument("--sigma", type=float, default=0.2,
                   help="BS vol (model=gbm)")
    p.add_argument("--heston", type=float, nargs=5, default=None,
                   metavar=("KAPPA", "THETA", "XI", "RHO", "V0"),
                   help="Heston parameters (default: kappa=2 theta=0.04 "
                        "xi=0.3 rho=-0.7 v0=0.04)")
    p.add_argument("--k-min", type=float, default=70.0)
    p.add_argument("--k-max", type=float, default=130.0)
    p.add_argument("--nk", type=int, default=64)
    p.add_argument("--t-min", type=float, default=0.1)
    p.add_argument("--t-max", type=float, default=1.0)
    p.add_argument("--nt", type=int, default=64)
    p.add_argument("--num-simulations", type=int, default=16384)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--heston-scheme", type=str, default="euler",
                   choices=["euler", "qe"])
    p.add_argument("--engine", type=str, default="auto",
                   choices=["auto", "xla", "triton"])
    p.add_argument("--seed", type=int, default=2026)
    p.add_argument("--with-iv", action="store_true",
                   help="Also invert each price to a BSM implied vol "
                        "(European style only)")
    p.add_argument("--csv", type=str, default=None)
    return p.parse_args(argv)


def run(args):
    import jax
    import jax.numpy as jnp
    import pandas as pd

    from options_model_tpu.ops.engine import enable_compilation_cache
    enable_compilation_cache()

    cp = cp_from_str(args.option_type)
    Ks = jnp.linspace(args.k_min, args.k_max, args.nk)
    Ts = jnp.linspace(args.t_min, args.t_max, args.nt)
    hp = (HestonParams(*args.heston).validate() if args.heston else
          HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04))
    sigma = args.sigma if args.model == "gbm" else None
    heston = hp if args.model == "heston" else None
    mc = MCConfig(n_paths=args.num_simulations, n_steps=args.steps).validate()

    t0 = time.time()
    if args.style == "american":
        from options_model_tpu.pricers.surface_american import (
            price_american_surface)
        P = price_american_surface(
            jax.random.key(args.seed), args.spot, Ks, Ts, args.r, mc, cp=cp,
            model=args.model, sigma=sigma, heston=heston, engine=args.engine,
            heston_scheme=args.heston_scheme, div_yield=args.q)
    elif args.model == "heston":
        # European Heston: the COS pricer does the whole surface closed-form
        # fast (no MC error at all).
        from options_model_tpu.calibration.charfn import heston_cos_price
        P = heston_cos_price(args.spot, Ks[None, :], Ts[:, None], args.r, hp,
                             cp=cp, q=args.q)
    else:
        from options_model_tpu.pricers.surface_american import (
            price_european_surface_mc)
        P = price_european_surface_mc(
            jax.random.key(args.seed), args.spot, Ks, Ts, args.r, mc, cp=cp,
            model="gbm", sigma=sigma, engine=args.engine, div_yield=args.q)
    P = np.asarray(P)  # (nt, nk)
    elapsed = time.time() - t0
    log.info(f"{args.nt}x{args.nk} {args.style} {args.model} surface in "
             f"{elapsed:.2f}s ({args.nt * args.nk / max(elapsed, 1e-9):.0f} "
             f"options/s)")

    Km, Tm = np.meshgrid(np.asarray(Ks), np.asarray(Ts))
    df = pd.DataFrame({"K": Km.ravel(), "T": Tm.ravel(),
                       "price": P.ravel()})
    if args.with_iv and args.style == "european":
        from options_model_tpu.pricers.blackscholes import implied_vol
        df["iv"] = np.asarray(implied_vol(
            jnp.asarray(P.ravel()), args.spot, jnp.asarray(Km.ravel()),
            jnp.asarray(Tm.ravel()), args.r, cp=cp, q=args.q))
    if args.csv:
        df.to_csv(args.csv, index=False)
        log.info(f"Wrote {args.csv}")
    return {"df": df, "grid": P, "seconds": elapsed}


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        out = run(args)
    except Exception as e:
        log.error(f"Surface pricing failed: {e}")
        return 1
    df = out["df"]
    print(df.head(8).to_string(index=False))
    print(f"... {len(df)} cells in {out['seconds']:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
