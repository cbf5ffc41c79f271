"""options_model_tpu — an options-pricing framework on JAX for NVIDIA GPUs.

A from-scratch rebuild of the capabilities of the reference ``Levicoz/Options-model``
toolkit (see SURVEY.md), compiled end to end by XLA:

- pure-functional, PRNG-explicit pricing core (``jit``-able end to end)
- ``lax.scan`` over time steps, ``vmap`` over paths/strikes/maturities
- a fused Heston terminal kernel (Pallas, Triton route) that draws the XLA
  engine's own counter-based threefry stream
- ``shard_map`` over device meshes for batch grids and path sharding
- Greeks via autodiff; Heston calibration via characteristic-function/COS pricing
- plain-JAX IV-surface network with vega-weighted loss and no-arbitrage penalties

Layer map (mirrors SURVEY.md §1):
  core/        config pytrees, RNG discipline, streaming stats, time grids
  models/      GBM / Heston / local-vol path dynamics
  ops/         engine selection, the fused GPU kernel, the LSM basis
  pricers/     Black-Scholes closed form, European MC, American LSM, binomial oracle
  surface/     implied-volatility-surface neural network
  calibration/ Heston characteristic-function calibration
  parallel/    device meshes, sharded batch pricers
  data/        market-data adapters and synthetic oracles
  apps/        CLI, curve orchestration, plotting, UI
  utils/       logging, profiling, plotting helpers
"""

__version__ = "0.1.0"
