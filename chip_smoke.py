#!/usr/bin/env python3
"""Smoke test of the pricer on NVIDIA GPUs.

Drives the library's main paths once through their public entry points, at
full width, and checks every result against an independent oracle (ADI PDE,
CRR tree, COS transform, published tables, or the same program on the CPU).
Any failed check raises and the script exits non-zero; nothing is caught.
It prints what it finds, each number labelled with the card, and its last
line is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Run from the repository root, one process per card:

    python3 chip_smoke.py                 # every one-GPU phase
    python3 chip_smoke.py --phase kernel  # chosen phases (repeatable)
    python3 chip_smoke.py --four          # only the four-GPU sharding checks
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
S0, K, R = 100.0, 100.0, 0.05
CARD = "unknown card"   # "name, power limit" from nvidia-smi, set by phase_device


class SmokeFailure(AssertionError):
    pass


def check(ok, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def timed(fn, *args):
    """(result, seconds) of fn(*args), synchronised with block_until_ready."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def compile_timed(fn, *args):
    """(compiled executable, compile seconds) of jax.jit(fn) at args."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: not available"
    mib = 1 << 20
    return (f"memory_analysis: args {m.argument_size_in_bytes / mib:.1f} MiB, "
            f"outputs {m.output_size_in_bytes / mib:.1f} MiB, "
            f"temps {m.temp_size_in_bytes / mib:.1f} MiB")


def peak_mib(dev) -> float:
    return (dev.memory_stats() or {}).get("peak_bytes_in_use", 0) / (1 << 20)


def params():
    from options_model_tpu.core.config import (PUT, BatesParams, HestonParams,
                                               OptionSpec)
    hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    return dict(
        hp=hp,
        bp=BatesParams(heston=hp, lam=0.3, mu_j=-0.1, sigma_j=0.15),
        put_h=OptionSpec(strike=K, rate=R, cp=PUT, sigma=None),
        put_g=OptionSpec(strike=K, rate=R, cp=PUT, sigma=0.2),
        call_h=OptionSpec(strike=K, rate=R, cp=1.0, sigma=None),
    )


def crr_oracle_source() -> str:
    """Build the native CRR oracle from the checkout's sources if a compiler
    is present; report which implementation crr_american will use."""
    subprocess.run(["make", "-s", "-C",
                    os.path.join(ROOT, "options_model_tpu", "native")],
                   capture_output=True, check=False)
    from options_model_tpu.pricers.binomial import _native_lib
    return ("native C++ (options_model_tpu/native/libcrr.so)"
            if _native_lib() is not None else "NumPy")


# --- phases -----------------------------------------------------------------

def phase_gpu_tests():
    """The gpu-marked tests, in a child pytest that holds the card alone
    (the parent has not initialised its backend yet)."""
    r = subprocess.run([sys.executable, "-m", "pytest", "tests", "-m", "gpu",
                        "-rs", "-p", "no:cacheprovider"],
                       cwd=ROOT, capture_output=True, text=True)
    tail = (r.stdout + r.stderr).strip().splitlines()[-15:]
    print("\n".join("  | " + line for line in tail))
    check(r.returncode == 0 and bool(tail) and " passed" in tail[-1],
          f"gpu-marked tests pass (pytest exit {r.returncode})")


def phase_device(n_required: int):
    import jax
    global CARD
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        print(f"no GPU: JAX reports platform {d.platform!r}", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    CARD = smi.splitlines()[0].strip()
    print(smi)
    import jaxlib
    print(f"  device_kind {d.device_kind!r}, count {len(devs)}, "
          f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    for mod in ("pandas", "flax"):
        print(f"  {mod} present: {importlib.util.find_spec(mod) is not None} "
              "(not needed)")
    check(len(devs) >= n_required, f"{n_required} GPU(s) visible")
    return devs


def phase_parity():
    """Seeded XLA-engine programs on the GPU and on the CPU of this process:
    threefry streams are platform-deterministic, so this checks the
    translation, not Monte-Carlo noise.

    In-sample LSM amplifies last-bit differences: each flipped exercise
    decision changes the regression targets of every earlier date. On the
    CPU, a one-ulp perturbation of the paths moves this American price by
    6.2e-4 relative at 2^16 paths (std over 32 seeds; max 1.9e-3) and by
    1.9e-5 at 2^20 (max 4.0e-5 over 6 seeds). The American therefore runs at
    2^20 paths, where its rtol 5e-4 is about 25 such deviations; at 2^16 the
    same rtol fails for about two seeds in five.
    """
    import jax
    from options_model_tpu.core.config import LSMConfig, MCConfig
    from options_model_tpu.pricers.american import price_american_lsm
    from options_model_tpu.pricers.european import (make_terminal_sampler,
                                                    price_european_mc)
    p = params()
    mc_a = MCConfig(n_paths=1 << 20, n_steps=50, path_block=4096)
    mc_e = MCConfig(n_paths=1 << 18, n_steps=100, path_block=4096)
    american = jax.jit(lambda k: price_american_lsm(
        k, S0, 0.5, p["put_h"], mc_a, LSMConfig(), "heston", heston=p["hp"],
        engine="xla"))
    sampler = make_terminal_sampler("heston", S0, R, 1.0, heston=p["hp"],
                                    engine="xla")
    european = jax.jit(lambda k: price_european_mc(k, sampler, p["call_h"],
                                                   1.0, mc_e)[:2])
    out = {}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            out[dev.platform] = (float(american(jax.random.key(7))[0]),
                                 float(european(jax.random.key(8))[0]))
    (ag, eg), (ac, ec) = out["gpu"], out["cpu"]
    print(f"  American Heston LSM (S,v) 2^20x50: gpu {ag!r} cpu {ac!r} "
          f"(rel {ag / ac - 1:+.2e})")
    print(f"  European Heston 2^18x100:          gpu {eg!r} cpu {ec!r} "
          f"(rel {eg / ec - 1:+.2e})")
    check(abs(eg / ec - 1) <= 1e-5, "European GPU vs CPU within rtol 1e-5")
    check(abs(ag / ac - 1) <= 5e-4, "American GPU vs CPU within rtol 5e-4")


def phase_american_heston():
    """The validated accuracy configuration: 4 seeds x 2^20 paths x 50 dates,
    deg-5 x cubic-(u,w) basis, control variate, common-path Richardson, vs
    the grid-extrapolated ADI oracle."""
    import jax
    import numpy as np
    from options_model_tpu.core.config import LSMConfig, MCConfig
    from options_model_tpu.pricers.american import price_american_richardson
    from options_model_tpu.pricers.fd_heston import heston_fd_price
    p = params()
    mc = MCConfig(n_paths=1 << 20, n_steps=50, path_block=4096)
    lsm = LSMConfig(regressor="poly", poly_degree=5, variance_basis_degree=3)
    fn = lambda k: price_american_richardson(k, S0, 0.5, p["put_h"], mc, lsm,
                                             model="heston", heston=p["hp"],
                                             engine="xla")
    keys = [jax.random.fold_in(jax.random.key(2026), s) for s in range(4)]
    compiled, t_compile = compile_timed(fn, keys[0])
    jax.block_until_ready(compiled(keys[0]))  # first run: allocation
    res, t_warm = timed(lambda: [compiled(k) for k in keys])
    prices = [float(x) for x, _ in res]
    ses = [float(s) for _, s in res]
    p_mc = float(np.mean(prices))
    se = float(np.sqrt(np.sum(np.square(ses)))) / len(ses)
    t0 = time.perf_counter()
    fd_c = heston_fd_price(S0, K, 0.5, R, p["hp"], cp=-1.0, american=True,
                           n_s=300, n_v=150, n_t=300)
    fd_f = heston_fd_price(S0, K, 0.5, R, p["hp"], cp=-1.0, american=True,
                           n_s=600, n_v=300, n_t=600)
    fd = fd_f + (fd_f - fd_c) / (2.0 ** 1.7 - 1.0)
    t_fd = time.perf_counter() - t0
    dev = jax.devices()[0]
    print(f"  [{CARD}] compile {t_compile:.3f} s, warm {t_warm:.4f} s for 4 "
          f"seeds ({t_warm / 4:.4f} s each), peak_bytes_in_use "
          f"{peak_mib(dev):.0f} MiB, {memory_line(compiled)}")
    print(f"  pooled price {p_mc!r} +- {se!r}; seeds {prices}")
    print(f"  ADI oracle {fd!r} (grids {fd_c!r}, {fd_f!r}; host {t_fd:.1f} s)")
    check(abs(p_mc - fd) <= 3 * se + 3e-4,
          f"|pooled - ADI| = {abs(p_mc - fd):.2e} <= 3 stderr + 3e-4 "
          f"= {3 * se + 3e-4:.2e}")


def phase_american_gbm():
    import jax
    from options_model_tpu.core.config import LSMConfig, MCConfig
    from options_model_tpu.pricers import crr_american
    from options_model_tpu.pricers.american import (
        price_american_richardson, price_american_with_control_variate)
    p = params()
    print(f"  CRR oracle: {crr_oracle_source()}")
    crr = crr_american(S0, K, 0.5, R, 0.2, cp=-1.0, n_steps=4096)
    mc = MCConfig(n_paths=1 << 21, n_steps=50, path_block=4096)
    rich = jax.jit(lambda k: price_american_richardson(
        k, S0, 0.5, p["put_g"], mc, LSMConfig(regressor="poly")))
    (pr, se), t = timed(rich, jax.random.key(2026))
    print(f"  [{CARD}] put Richardson+CV 2^21x50: {float(pr)!r} +- "
          f"{float(se)!r} (first call {t:.2f} s), CRR {crr!r}")
    check(abs(float(pr) / crr - 1) <= 1e-3, "Richardson+CV within 0.1% of CRR")
    mc_nn = MCConfig(n_paths=1 << 18, n_steps=50, path_block=4096)
    nn = jax.jit(lambda k: price_american_with_control_variate(
        k, S0, 0.5, p["put_g"], mc_nn, LSMConfig(regressor="nn"),
        engine="xla"))
    (pn, sen), t = timed(nn, jax.random.key(2026))
    print(f"  [{CARD}] put NN-LSM+CV 2^18x50 (default matmul precision): "
          f"{float(pn)!r} +- {float(sen)!r} (first call {t:.2f} s)")
    check(abs(float(pn) / crr - 1) <= 1e-2, "NN-LSM+CV within 1% of CRR")


def phase_european():
    import jax
    import jax.numpy as jnp
    from options_model_tpu.calibration import bates_cos_price, heston_cos_price
    from options_model_tpu.core.config import MCConfig
    from options_model_tpu.core.stats import masked_mean_stderr
    from options_model_tpu.models.multiasset import gbm_basket_terminal_exact
    from options_model_tpu.pricers.american_basket import price_american_basket
    from options_model_tpu.pricers.basket import geometric_basket_bs_price
    from options_model_tpu.pricers.european import (make_terminal_sampler,
                                                    price_european_mc)
    p = params()
    mc = MCConfig(n_paths=1 << 22, n_steps=100, path_block=4096)
    cases = [("heston", dict(heston=p["hp"]),
              float(heston_cos_price(S0, K, 1.0, R, p["hp"], cp=1.0))),
             ("bates", dict(bates=p["bp"]),
              float(bates_cos_price(S0, K, 1.0, R, p["bp"], cp=1.0)))]
    for model, kw, cos in cases:
        sampler = make_terminal_sampler(model, S0, R, 1.0, heston_scheme="qe",
                                        **kw)
        fn = jax.jit(lambda k, s=sampler: price_european_mc(
            k, s, p["call_h"], 1.0, mc)[:2])
        (m, se), t = timed(fn, jax.random.key(31))
        z = (float(m) - cos) / float(se)
        print(f"  [{CARD}] {model} QE call 2^22x100: {float(m)!r} +- "
              f"{float(se)!r} (first call {t:.2f} s), COS {cos!r}, z {z:.2f}")
        check(abs(z) <= 4, f"{model} QE European |z| <= 4 vs COS")
    # Correlated GBM: the L @ z products run at default matmul precision.
    ab = {90.0: 8.075, 100.0: 13.902, 110.0: 21.345}  # Andersen-Broadie 2004
    mc9 = MCConfig(n_paths=1 << 20, n_steps=9, path_block=4096)
    for s0, ref in ab.items():
        pb, se = price_american_basket(
            jax.random.key(3), [s0, s0], 100.0, 3.0, R, [0.2, 0.2],
            [[1.0, 0.0], [0.0, 1.0]], cp=1.0, mc=mc9, kind="max",
            div_yields=[0.10, 0.10])
        print(f"  [{CARD}] Bermudan max-call S0={s0}: {float(pb)!r} +- "
              f"{float(se)!r}, Andersen-Broadie {ref}")
        check(abs(float(pb) / ref - 1) <= 1e-2,
              f"max-call S0={s0} within 1% of Andersen-Broadie")
    s0s, sig = [100.0, 95.0, 110.0], [0.2, 0.3, 0.25]
    corr = [[1.0, 0.5, 0.3], [0.5, 1.0, 0.4], [0.3, 0.4, 1.0]]
    w = jnp.full((3,), 1.0 / 3, jnp.float32)
    S_T = gbm_basket_terminal_exact(jax.random.key(7), s0s, R, sig, corr, 0.5,
                                    1 << 22)
    geo = jnp.exp(jnp.tensordot(w, jnp.log(S_T), axes=1,
                                precision=jax.lax.Precision.HIGHEST))
    cash = jnp.maximum(geo - 100.0, 0.0) * jnp.exp(-R * 0.5)
    m, se, _ = masked_mean_stderr(cash, pair_block=1 << 22)
    cf = geometric_basket_bs_price(s0s, [1 / 3] * 3, 100.0, 0.5, R, sig, corr)
    z = (float(m) - cf) / float(se)
    print(f"  [{CARD}] correlated geometric basket 2^22: {float(m)!r} +- "
          f"{float(se)!r}, closed form {cf!r}, z {z:.2f}")
    check(abs(z) <= 4, "correlated basket |z| <= 4 vs closed form")


def phase_kernel():
    """The Triton Heston Euler terminal kernel: compile at 2^22 x 100,
    compare with the XLA simulator at the same seed, then the end-to-end
    A/B through price_european_mc."""
    import jax
    import numpy as np
    from options_model_tpu.core.config import MCConfig
    from options_model_tpu.models.heston import simulate_heston
    from options_model_tpu.ops.triton_heston import heston_terminal_triton
    from options_model_tpu.pricers.european import (make_terminal_sampler,
                                                    price_european_mc)
    p = params()
    mc = MCConfig(n_paths=1 << 22, n_steps=100, path_block=4096)
    key = jax.random.key(5)
    kern, t_c = compile_timed(
        lambda k: heston_terminal_triton(k, S0, R, 1.0, p["hp"], mc), key)
    print(f"  [{CARD}] kernel compile {t_c:.3f} s, {memory_line(kern)}")
    s_k = np.asarray(kern(key))
    s_x = np.asarray(jax.jit(lambda k: simulate_heston(
        k, S0, R, 1.0, p["hp"], mc, return_paths=False))(key))
    rel = float(np.max(np.abs(s_k / s_x - 1.0)))
    print(f"  max |S_T kernel / S_T xla - 1| over {s_k.size} paths: {rel!r}")
    check(s_k.shape == s_x.shape and np.isfinite(s_k).all(), "kernel S_T shape")
    check(rel <= 1e-4, "kernel S_T within rtol 1e-4 of simulate_heston")

    fns = {}
    for eng in ("triton", "xla"):
        sampler = make_terminal_sampler("heston", S0, R, 1.0, heston=p["hp"],
                                        engine=eng)
        fns[eng] = jax.jit(lambda k, s=sampler: price_european_mc(
            k, s, p["call_h"], 1.0, mc)[:2])
        jax.block_until_ready(fns[eng](key))  # compile + warm
    times = {"triton": [], "xla": []}
    prices = {}
    for i in range(7):
        for eng in (("triton", "xla") if i % 2 == 0 else ("xla", "triton")):
            (m, _), t = timed(fns[eng], jax.random.fold_in(key, i))
            times[eng].append(t)
            prices[eng] = float(m)
    steps = mc.n_paths * mc.n_steps
    for eng, ts in times.items():
        med = float(np.median(ts))
        print(f"  [{CARD}] A/B price_european_mc 2^22x100 engine={eng}: "
              f"median {med:.6f} s, min {min(ts):.6f} s over {len(ts)} runs "
              f"= {steps / med:.4g} path-steps/s")
    print(f"  kernel/xla median time ratio "
          f"{np.median(times['triton']) / np.median(times['xla']):.4f}")
    check(abs(prices["triton"] / prices["xla"] - 1) <= 1e-4,
          "kernel and XLA prices agree to rtol 1e-4 (same normals)")


def phase_surface():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from options_model_tpu.core.config import MCConfig
    from options_model_tpu.pricers import crr_american
    from options_model_tpu.pricers.fd_heston import heston_fd_price
    from options_model_tpu.pricers.surface_american import (
        price_american_curves_shared, price_american_surface)
    p = params()
    Ks = S0 + (jnp.arange(64) - 32).astype(jnp.float32)   # K=100 at index 32
    Ts = jnp.linspace(0.1, 1.0, 64)
    mc = MCConfig(n_paths=1 << 16, n_steps=50, path_block=4096)
    surf = jax.jit(lambda k: price_american_surface(
        k, S0, Ks, Ts, R, mc, cp=-1.0, heston=p["hp"]))
    out, t_first = timed(surf, jax.random.key(0))
    out, t_warm = timed(surf, jax.random.key(1))
    out = np.asarray(out)
    print(f"  [{CARD}] 64x64 Heston surface 2^16x50: first call "
          f"{t_first:.2f} s, warm {t_warm:.4f} s")
    check(out.shape == (64, 64) and np.isfinite(out).all(),
          "surface cells all finite")
    for i in (0, 31, 63):
        T = float(Ts[i])
        fd = heston_fd_price(S0, K, T, R, p["hp"], cp=-1.0, american=True)
        print(f"  ATM T={T:.4f}: surface {out[i, 32]!r}, ADI {fd!r}")
        check(abs(out[i, 32] / fd - 1) <= 0.02, f"ATM T={T:.3f} within 2% of ADI")

    S0s = np.array([90.0, 100.0, 110.0], np.float32)
    mc_c = MCConfig(n_paths=1 << 20, n_steps=50, path_block=4096)
    curves = jax.jit(lambda k: price_american_curves_shared(
        k, S0s, K, jnp.array([0.25], jnp.float32), R, mc_c, model="gbm",
        sigma=0.2, use_control_variate=True))
    (pc, sc), t = timed(curves, jax.random.key(4))
    print(f"  [{CARD}] curves_shared 3 spots 2^20x50: first call {t:.2f} s")
    for j, s0 in enumerate(S0s):
        crr = crr_american(float(s0), K, 0.25, R, 0.2, cp=-1.0, n_steps=4096)
        got, se = float(pc[0, j]), float(sc[0, j])
        print(f"  S0={s0}: {got!r} +- {se!r}, CRR {crr!r}")
        check(abs(got - crr) <= 4 * se + 2e-3 * crr,
              f"S0={s0} within 4 stderr + 0.2% of CRR")


def phase_calibration():
    import numpy as np
    from options_model_tpu.calibration import create_synthetic_heston_surface
    from options_model_tpu.calibration.calibrator import (HestonCalibrator,
                                                          MarketSurface)
    from options_model_tpu.core.config import HestonParams
    true = HestonParams(kappa=3.0, theta=0.05, xi=0.4, rho=-0.6, v0=0.045)
    Kc, Tc, ivc = create_synthetic_heston_surface(true, dtype=np.float64)
    cal = HestonCalibrator()
    t0 = time.perf_counter()
    fit = cal.calibrate(MarketSurface(strikes=Kc, expiries=Tc, ivs=ivc, S0=S0,
                                      rate=R))
    dt = time.perf_counter() - t0
    print(f"  [{CARD}] calibration {dt:.2f} s; objective dtype "
          f"{cal._objective_dtype}, device {cal._objective_device or 'default'}")
    print(f"  fit {fit}")
    for name in ("kappa", "theta", "xi", "rho", "v0"):
        rel = abs(getattr(fit, name) / getattr(true, name) - 1)
        check(rel <= 1e-2, f"{name} recovered within 1% (rel {rel:.2e})")


def phase_four(devs):
    """Path-sharded pricing and the task-sharded grid on four cards vs one.

    The European psums Welford partials over the same global-block streams
    the LSM simulates: rtol 2e-5 (reduction order). The path-sharded LSM
    psums its per-date Grams; their reduction order moves regression
    coefficients by ulps, which flips the exercise decisions of paths on the
    boundary and moves the price by 1e-5 to 1e-4 relative (4.15e-5 on four
    H100s at 2^22 paths; 1.4e-4 to 6.7e-4 on a virtual CPU mesh at 2^15 to
    2^18), so its check is rtol 2e-4, about 0.3 of its stderr.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from options_model_tpu.core.config import MCConfig
    from options_model_tpu.parallel import (make_mesh, price_american_grid,
                                            price_american_sharded_paths,
                                            price_european_sharded)
    p = params()
    mc = MCConfig(n_paths=1 << 22, n_steps=50, path_block=4096)
    res = {}
    for n in (4, 1):
        mesh = make_mesh(("paths",), devices=devs[:n])
        (pr, se), t = timed(lambda: price_american_sharded_paths(
            jax.random.key(9), S0, 0.5, p["put_h"], mc, mesh, model="heston",
            heston=p["hp"]))
        (pe, see, _), te = timed(lambda: price_european_sharded(
            jax.random.key(9), S0, 0.5, p["put_h"], mc, mesh, model="heston",
            heston=p["hp"]))
        res[n] = (float(pr), float(pe))
        print(f"  [{CARD}] on {n} card(s), Heston 2^22x50: sharded-paths "
              f"American {float(pr)!r} +- {float(se)!r} (first call "
              f"{t:.2f} s), European {float(pe)!r} +- {float(see)!r} "
              f"(first call {te:.2f} s)")
    am = abs(res[4][0] / res[1][0] - 1)
    eu = abs(res[4][1] / res[1][1] - 1)
    check(eu <= 2e-5, f"European 4 cards vs 1 within rtol 2e-5 ({eu:.2e})")
    check(am <= 2e-4, f"American 4 cards vs 1 within rtol 2e-4 ({am:.2e})")

    S0s = jnp.linspace(80.0, 120.0, 64)
    Ks = jnp.full((64,), K)
    Ts = jnp.tile(jnp.array([0.25, 0.5, 0.75, 1.0]), 16)
    mc_g = MCConfig(n_paths=1 << 16, n_steps=50, path_block=4096)
    grid = {}
    for n in (4, 1):
        mesh = make_mesh(("tasks",), devices=devs[:n])
        out, t = timed(lambda: price_american_grid(
            jax.random.key(10), S0s, Ks, Ts, R, mc_g, mesh, cp=-1.0,
            heston=p["hp"], model="heston", engine="xla"))
        grid[n] = np.asarray(out)
        print(f"  [{CARD}] 64-option Heston grid on {n} card(s): first call "
              f"{t:.2f} s")
    err = float(np.max(np.abs(grid[4] / grid[1] - 1)))
    check(err <= 2e-5, f"grid 4 cards vs 1 within rtol 2e-5 (max {err:.2e})")
    for d in devs[:4]:
        print(f"  {d}: peak_bytes_in_use {peak_mib(d):.0f} MiB")
    check(all(peak_mib(d) > 0 for d in devs[:4]),
          "every card allocated memory")


PHASES = {
    "parity": phase_parity,
    "american-heston": phase_american_heston,
    "american-gbm": phase_american_gbm,
    "european": phase_european,
    "kernel": phase_kernel,
    "surface": phase_surface,
    "calibration": phase_calibration,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharding checks")
    ap.add_argument("--phase", action="append", choices=sorted(PHASES),
                    help="run only these one-GPU phases (default: all, after "
                         "the gpu-marked tests)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    t_all = time.perf_counter()
    if not args.four and not args.phase:
        print("== gpu-tests", flush=True)
        phase_gpu_tests()
    print("== device", flush=True)
    devs = phase_device(4 if args.four else 1)
    from options_model_tpu.ops.engine import enable_compilation_cache
    print(f"  compilation cache: {enable_compilation_cache()}")
    names = ["four"] if args.four else (args.phase or list(PHASES))
    for name in names:
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        if name == "four":
            phase_four(devs)
        else:
            PHASES[name]()
        print(f"  ({name}: {time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"== all phases passed in {time.perf_counter() - t_all:.1f} s "
          f"[{CARD}]")
    import jax
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
