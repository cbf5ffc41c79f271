"""Quick validation — four fast end-to-end checks with pass/fail prints.

The analogue of the reference's quick_validation.py (SURVEY.md §4): a smoke
pass over the main subsystems, runnable on CPU or GPU in under a minute.

    python scripts/quick_validation.py
"""

import pathlib
import sys
import time

# repo-root import without installation: `python scripts/x.py` puts scripts/
# (not the cwd) on sys.path, so the package is invisible unless added here
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np


def check(name, fn):
    t0 = time.time()
    try:
        fn()
        print(f"  [ok] {name} ({time.time() - t0:.1f}s)")
        return True
    except Exception as e:
        print(f"  [FAIL] {name}: {e}")
        return False


def check_european_vs_bs():
    import jax
    from options_model_tpu.core.config import CALL, MCConfig, OptionSpec
    from options_model_tpu.pricers import bs_price, price_european_mc
    from options_model_tpu.pricers.european import make_terminal_sampler

    spec = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=0.2)
    cfg = MCConfig(n_paths=2**16, n_steps=16, path_block=4096)
    sampler = make_terminal_sampler("gbm", 100.0, 0.05, 0.5, sigma=0.2)
    p, se, _ = price_european_mc(jax.random.key(0), sampler, spec, 0.5, cfg)
    bs = float(bs_price(100.0, 100.0, 0.5, 0.05, 0.2, 1.0))
    assert abs(float(p) - bs) < 5 * float(se), (float(p), bs, float(se))


def check_american_vs_crr():
    import jax
    from options_model_tpu.core.config import PUT, LSMConfig, MCConfig, OptionSpec
    from options_model_tpu.pricers import crr_american, price_american

    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=0.2)
    mc = MCConfig(n_paths=2**15, n_steps=50, path_block=4096)
    p, _ = price_american(jax.random.key(0), 100.0, 0.5, spec, mc,
                          LSMConfig(regressor="poly"))
    oracle = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, cp=-1.0)
    rel = abs(float(p) - oracle) / oracle
    assert rel < 0.01, f"rel err {rel:.4f}"


def check_cos_vs_parity():
    from options_model_tpu.core.config import HestonParams
    from options_model_tpu.calibration import heston_cos_price

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.5, rho=-0.7, v0=0.04)
    call = float(heston_cos_price(100.0, 100.0, 0.5, 0.05, hp, 1.0))
    put = float(heston_cos_price(100.0, 100.0, 0.5, 0.05, hp, -1.0))
    parity = 100.0 - 100.0 * np.exp(-0.05 * 0.5)
    assert abs((call - put) - parity) < 1e-2, (call, put, parity)


def check_surface_nn_fit():
    from options_model_tpu.core.config import SurfaceTrainConfig
    from options_model_tpu.data.synthetic import synthetic_smile_surface
    from options_model_tpu.surface.model import IVSurfaceModel

    K, T, iv, S0 = synthetic_smile_surface()
    cfg = SurfaceTrainConfig(hidden_dim=16, num_hidden_layers=1, epochs=150,
                             dropout=0.0, use_vega_weighting=False,
                             patience=150)
    m = IVSurfaceModel.fit(K, T, iv, S0, cfg)
    pred = m.predict(K, T)
    rmse = float(np.sqrt(np.mean((pred - iv) ** 2)))
    assert rmse < 0.05, f"surface RMSE {rmse:.4f}"


def check_dividend_yield():
    import jax
    from options_model_tpu.core.config import CALL, LSMConfig, MCConfig, OptionSpec
    from options_model_tpu.pricers import bs_price, crr_american, price_american

    q = 0.08
    c = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.25, 1.0, q=q))
    p = float(bs_price(100.0, 100.0, 1.0, 0.05, 0.25, -1.0, q=q))
    parity = 100.0 * np.exp(-q) - 100.0 * np.exp(-0.05)
    assert abs((c - p) - parity) < 1e-4, "BSM parity with q"
    spec = OptionSpec(strike=100.0, rate=0.05, cp=CALL, sigma=0.25, div_yield=q)
    mc = MCConfig(n_paths=2**15, n_steps=50, path_block=4096)
    am, _ = price_american(jax.random.key(0), 100.0, 1.0, spec, mc,
                           LSMConfig(regressor="poly"))
    oracle = crr_american(100.0, 100.0, 1.0, 0.05, 0.25, cp=1.0, q=q)
    assert am > c and abs(float(am) / oracle - 1.0) < 0.02, \
        "dividend early-exercise premium"


def check_heston_vs_fd_oracle():
    import jax
    from options_model_tpu.core.config import (
        PUT, HestonParams, LSMConfig, MCConfig, OptionSpec)
    from options_model_tpu.pricers import price_american
    from options_model_tpu.pricers.fd_heston import heston_fd_price

    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    spec = OptionSpec(strike=100.0, rate=0.05, cp=PUT, sigma=None)
    mc = MCConfig(n_paths=2**16, n_steps=50, path_block=4096)
    p, _ = price_american(jax.random.key(0), 100.0, 0.5, spec, mc,
                          LSMConfig(), model="heston", heston=hp)
    fd = heston_fd_price(100.0, 100.0, 0.5, 0.05, hp, cp=-1.0, american=True)
    rel = abs(float(p) - fd) / fd
    assert rel < 0.012, f"rel err vs ADI oracle {rel:.4f}"


def main():
    print("Quick validation (backend import + 6 checks):")
    ok = all([
        check("European MC vs Black-Scholes closed form", check_european_vs_bs),
        check("American LSM+CV vs CRR binomial oracle", check_american_vs_crr),
        check("Heston COS put-call parity", check_cos_vs_parity),
        check("IV-surface NN fits the synthetic smile", check_surface_nn_fit),
        check("Dividend yield q: parity + early-exercise premium",
              check_dividend_yield),
        check("Heston American LSM(S,v) vs ADI FD oracle",
              check_heston_vs_fd_oracle),
    ])
    print("ALL CHECKS PASSED" if ok else "SOME CHECKS FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
