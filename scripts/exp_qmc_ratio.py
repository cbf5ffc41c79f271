"""Decompose the RQMC-vs-MC Asian stderr ratio.

With NO control variate on either side RQMC wins by ~20x in stderr; both
pricers compose the Kemna-Vorst geometric variate, so the bench ratio is
RQMC's edge on the CV RESIDUAL (arith - beta*geo) — a rougher,
higher-effective-dimension integrand where a ~4x edge is the honest number.
This script prints all four stderrs and both ratios on the active backend.

Run from the repository root: PYTHONPATH=. python scripts/exp_qmc_ratio.py
"""

import jax

from options_model_tpu.core.config import MCConfig, OptionSpec
from options_model_tpu.ops.engine import enable_compilation_cache
from options_model_tpu.pricers.exotics import price_asian_mc
from options_model_tpu.pricers.qmc import price_asian_qmc

enable_compilation_cache()

spec = OptionSpec(strike=100.0, rate=0.05, cp=-1.0, sigma=0.2)
q_paths, q_reps, n_steps = 1 << 14, 8, 50
mc_cfg = MCConfig(n_paths=q_reps * q_paths, n_steps=n_steps, path_block=4096)

print(f"backend={jax.default_backend()} paths={q_reps}x{q_paths}")

p_q, se_q, _ = price_asian_qmc(17, 100.0, 0.5, spec, n_paths=q_paths,
                               n_steps=n_steps, replicates=q_reps)
p_q0, se_q0, _ = price_asian_qmc(17, 100.0, 0.5, spec, n_paths=q_paths,
                                 n_steps=n_steps, replicates=q_reps,
                                 control_variate="off")
p_a, se_a = price_asian_mc(jax.random.key(17), 100.0, 0.5, spec, mc_cfg)
p_a0, se_a0 = price_asian_mc(jax.random.key(17), 100.0, 0.5, spec, mc_cfg,
                             control_variate="off")

print(f"MC   raw : {float(p_a0):.5f} +- {float(se_a0):.6f}")
print(f"MC   +CV : {float(p_a):.5f} +- {float(se_a):.6f}  "
      f"(CV cuts {float(se_a0)/float(se_a):.1f}x)")
print(f"RQMC raw : {float(p_q0):.5f} +- {float(se_q0):.6f}")
print(f"RQMC +CV : {float(p_q):.5f} +- {float(se_q):.6f}  "
      f"(CV cuts {float(se_q0)/float(se_q):.1f}x)")
print(f"ratio raw (RQMC edge on the payoff):   "
      f"{float(se_a0)/float(se_q0):.1f}x")
print(f"ratio CV  (RQMC edge on the residual): "
      f"{float(se_a)/float(se_q):.1f}x")
print(f"combined RQMC+CV vs raw MC:            "
      f"{float(se_a0)/float(se_q):.1f}x")
