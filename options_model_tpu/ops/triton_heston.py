"""Fused Heston Euler terminal sampler for NVIDIA GPUs (Pallas, Triton route).

The XLA engine (models/heston.simulate_heston) runs the step loop as a
``lax.scan`` of fused kernels: every step reads and writes the (log S, v)
state and the step's normals through device memory. This kernel keeps the
state of a block of paths in registers for all steps and writes S_T once.

It draws exactly the XLA engine's normals, so its S_T equals
``simulate_heston(..., return_paths=False)`` up to float rounding and it
inherits that engine's device-count invariance:

- block keys ``fold_in(fold_in(fold_in(key, global_block), step), draw)``
  (models/blocks.block_normals), computed here as scalar threefry2x32 hashes;
- per element the partitionable threefry bits ``y0 ^ y1`` of
  ``threefry2x32(block_key, (0, index))``, then ``jax.random.normal``'s
  bits -> uniform in (-1, 1) -> ``sqrt(2) * erfinv``;
- with antithetic sampling one program owns half-block indices ``j`` and
  advances both mirrors, +z at path ``j`` and -z at path ``half + j``.

This requires ``jax_threefry_partitionable`` (the default) and threefry keys;
``heston_terminal_supported`` says whether a call qualifies.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from options_model_tpu.core.config import HestonParams, MCConfig
from options_model_tpu.models.blocks import num_blocks

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax.random.normal's uniform range: (nextafter(-1, 0), 1) in float32.
_LO = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
_SPAN = np.float32(1.0) - _LO
_SQRT2 = np.float32(np.sqrt(2.0))
_MAX_BLOCK = 512   # half-block indices per program
_NUM_WARPS = 4


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on uint32 operands, as
    jax.random's threefry2x32 primitive computes it."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def fold_in(k0, k1, data):
    """jax.random.fold_in on raw threefry key words."""
    return threefry2x32(k0, k1, jnp.zeros_like(data), data)


def normal_from_bits(bits):
    """jax.random.normal (float32) from its 32 random bits."""
    mant = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    f = jax.lax.bitcast_convert_type(mant, jnp.float32) - np.float32(1.0)
    u = jnp.maximum(_LO, f * _SPAN + _LO)
    return _SQRT2 * jax.lax.erf_inv(u)


def _block_size(n: int) -> int:
    """Largest power of two <= _MAX_BLOCK dividing n (n is a multiple of
    128: MCConfig.path_block is a multiple of 256)."""
    b = _MAX_BLOCK
    while n % b:
        b //= 2
    return b


def _kernel(par_ref, key_ref, out_ref, *, n_steps, block, antithetic):
    """One program: ``block`` indices of one path block, all steps."""
    k0 = key_ref[0]
    k1 = key_ref[1]
    b = key_ref[2] + pl.program_id(0).astype(jnp.uint32)
    idx = (pl.program_id(1) * block).astype(jnp.uint32) + jax.lax.iota(
        jnp.uint32, block)
    kb0, kb1 = fold_in(k0, k1, b)

    log_s0 = par_ref[0]
    r = par_ref[1]
    dt = par_ref[2]
    sqrt_dt = par_ref[3]
    kappa = par_ref[4]
    theta = par_ref[5]
    xi = par_ref[6]
    rho = par_ref[7]
    rho_bar = par_ref[8]
    v0 = par_ref[9]

    def advance(logS, v, z1, z2):
        w2 = rho * z1 + rho_bar * z2
        v_plus = jnp.maximum(v, 0.0)
        sqrt_v_dt = jnp.sqrt(v_plus) * sqrt_dt
        v_new = jnp.maximum(
            v_plus + kappa * (theta - v_plus) * dt + xi * sqrt_v_dt * w2, 0.0)
        logS_new = logS + (r - 0.5 * v_plus) * dt + sqrt_v_dt * z1
        return logS_new, v_new

    def draw(kt0, kt1, d):
        kd0, kd1 = fold_in(kt0, kt1, np.uint32(d))
        y0, y1 = threefry2x32(kd0, kd1, jnp.zeros_like(idx), idx)
        return normal_from_bits(y0 ^ y1)

    def step(t, carry):
        kt0, kt1 = fold_in(kb0, kb1, t.astype(jnp.uint32))
        z1 = draw(kt0, kt1, 0)
        z2 = draw(kt0, kt1, 1)
        if antithetic:
            lp, vp, lm, vm = carry
            lp, vp = advance(lp, vp, z1, z2)
            lm, vm = advance(lm, vm, -z1, -z2)
            return lp, vp, lm, vm
        return advance(*carry, z1, z2)

    logS = jnp.full((block,), log_s0, jnp.float32)
    v = jnp.full((block,), v0, jnp.float32)
    if antithetic:
        lp, _, lm, _ = jax.lax.fori_loop(0, n_steps, step, (logS, v, logS, v))
        out_ref[0, 0, :] = jnp.exp(lp)
        out_ref[0, 1, :] = jnp.exp(lm)
    else:
        logS, _ = jax.lax.fori_loop(0, n_steps, step, (logS, v))
        out_ref[0, :] = jnp.exp(logS)


def heston_terminal_supported(key: jax.Array, cfg: MCConfig) -> bool:
    """Whether the kernel reproduces simulate_heston's stream for this call."""
    return (cfg.dtype == jnp.float32
            and jax.config.jax_threefry_partitionable
            and jax.dtypes.issubdtype(key.dtype, jax.dtypes.prng_key)
            and str(jax.random.key_impl(key)) == "threefry2x32")


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def heston_terminal_triton(key: jax.Array, S0, r, T, params: HestonParams,
                           cfg: MCConfig, first_block=0,
                           interpret: bool = False) -> jnp.ndarray:
    """S_T (n_paths_rounded,) of the full-truncation Euler Heston scheme,
    equal to ``simulate_heston(key, S0, r, T, params, cfg,
    return_paths=False, first_block=first_block)`` up to float rounding.

    ``interpret=True`` runs the kernel through the Pallas interpreter (any
    backend); otherwise it compiles for the GPU and refuses other backends.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError("the Triton Heston kernel compiles for a GPU only; "
                         "pass interpret=True to run it elsewhere")
    if not heston_terminal_supported(key, cfg):
        raise ValueError("the Triton Heston kernel needs float32, threefry "
                         "keys and jax_threefry_partitionable")
    f32 = jnp.float32
    dt = jnp.asarray(T, f32) / cfg.n_steps
    rho = jnp.asarray(params.rho, f32)
    par = jnp.stack([
        jnp.log(jnp.asarray(S0, f32)), jnp.asarray(r, f32), dt, jnp.sqrt(dt),
        jnp.asarray(params.kappa, f32), jnp.asarray(params.theta, f32),
        jnp.asarray(params.xi, f32), rho, jnp.sqrt(1.0 - rho**2),
        jnp.asarray(params.v0, f32)] + [jnp.zeros((), f32)] * 6)
    kd = jax.random.key_data(key).reshape(2)
    keys = jnp.stack([kd[0], kd[1], jnp.asarray(first_block).astype(jnp.uint32),
                      jnp.uint32(0)])

    nb = num_blocks(cfg)
    half = cfg.path_block // 2
    width = half if cfg.antithetic else cfg.path_block
    block = _block_size(width)
    if cfg.antithetic:
        out_shape = (nb, 2, half)
        out_spec = pl.BlockSpec((1, 2, block), lambda i, j: (i, 0, j))
    else:
        out_shape = (nb, cfg.path_block)
        out_spec = pl.BlockSpec((1, block), lambda i, j: (i, j))
    kernel = functools.partial(_kernel, n_steps=cfg.n_steps, block=block,
                               antithetic=cfg.antithetic)
    out = pl.pallas_call(
        kernel,
        grid=(nb, width // block),
        in_specs=[pl.BlockSpec((16,), lambda i, j: (0,)),
                  pl.BlockSpec((4,), lambda i, j: (0,))],
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct(out_shape, f32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS),
        interpret=interpret,
        name="heston_euler_terminal",
    )(par, keys)
    return out.reshape(nb * cfg.path_block)
