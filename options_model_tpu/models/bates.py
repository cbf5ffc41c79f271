"""Bates (1996) stochastic-volatility jump-diffusion simulation.

Beyond-reference dynamics family completing the model lattice
(GBM -> Merton adds jumps; Heston -> Bates adds the same jumps on top of
stochastic variance). Decomposition: the compound-Poisson jump
component is INDEPENDENT of both Brownian drivers and of the variance path,
so the exact simulated Bates path factorizes as

    S_bates = S_heston(drift r) * exp( sum_t [ jump_sum_t - lam*kbar*dt ] )

where jump_sum_t aggregates the step's jumps exactly without per-jump
simulation (conditional on N_t ~ Poisson(lam dt) the summed log-jump is
N_t*mu_j + sigma_j*sqrt(N_t)*Z', as in models/merton.py). The overlay is a
pure elementwise cumsum over the (steps x paths) grid, so it composes with
ANY Heston engine — the XLA Euler/QE scans here, or the fused GPU terminal
kernel (ops/triton_heston.py) via pricers/european.make_terminal_sampler —
without touching the variance recursion. The variance matrix needed by the (S, v) LSM basis is
exactly the Heston one.

Antithetic discipline: the underlying Heston normals mirror as usual. The
overlay's draws are deliberately NOT mirrored — the Poisson count admits no
measure-preserving reflection, and drawing the jump-size normals full-width
keeps every overlay column i.i.d., so antithetic pair means remain valid
i.i.d. stderr units under any base-engine pairing layout (a mirrored
overlay would have to replicate the engine's layout exactly or silently
correlate pair units across the pricer's pair_block granularity).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from options_model_tpu.core.config import BatesParams, MCConfig
from options_model_tpu.models.blocks import num_blocks
from options_model_tpu.models.heston import simulate_heston


def jump_overlay(key: jax.Array, T, lam, mu_j, sigma_j, cfg: MCConfig,
                 return_paths: bool = True, first_block=0):
    """Multiplicative compensated compound-jump factor.

    Returns (n_steps+1, n_paths) when return_paths (row 0 is all-ones) else
    the terminal factor (n_paths,). E[factor] = 1 at every row (the -lam*kbar
    compensator), so multiplying any martingale-drift spot path by it
    preserves the discounted-martingale property.

    Keyed per (block, step, draw): chunked callers passing ``first_block``
    stay on disjoint streams, matching the simulators' convention.
    """
    dtype = cfg.dtype
    n_steps = cfg.n_steps
    dt = jnp.asarray(T, dtype) / n_steps
    lam = jnp.asarray(lam, dtype)
    mu_j = jnp.asarray(mu_j, dtype)
    sigma_j = jnp.asarray(sigma_j, dtype)
    kbar = jnp.exp(mu_j + 0.5 * sigma_j**2) - 1.0
    comp = lam * kbar * dt
    nb = num_blocks(cfg)

    def step_increment(block_key, t):
        kt = jax.random.fold_in(block_key, t)
        kn, kj = jax.random.fold_in(kt, 0), jax.random.fold_in(kt, 1)
        n_jumps = jax.random.poisson(kn, lam * dt,
                                     (cfg.path_block,)).astype(dtype)
        zj = jax.random.normal(kj, (cfg.path_block,), dtype)
        return n_jumps * mu_j + sigma_j * jnp.sqrt(n_jumps) * zj - comp

    def sim_block(block_key):
        if not return_paths:
            # Terminal-only: the per-step compound sums ADD to one compound
            # Poisson over [0, T] (given the counts each step's sum is
            # N(N_t mu_j, sigma_j^2 N_t); counts add to Poisson(lam T)), so
            # ONE (count, normal) draw pair per path replaces n_steps pairs —
            # identical law, O(paths) instead of O(paths x steps) memory
            # (the per-step version OOM'ed the 2^22-path bench leg).
            # Different stream than the path version (fold_in indices just
            # past the step range, which uses [0, n_steps)): deliberate, so
            # the two shapes never silently correlate.
            kn = jax.random.fold_in(block_key, n_steps)
            kj = jax.random.fold_in(block_key, n_steps + 1)
            n_jumps = jax.random.poisson(
                kn, lam * jnp.asarray(T, dtype),
                (cfg.path_block,)).astype(dtype)
            zj = jax.random.normal(kj, (cfg.path_block,), dtype)
            logf = (n_jumps * mu_j + sigma_j * jnp.sqrt(n_jumps) * zj
                    - comp * n_steps)
            return jnp.exp(logf)
        inc = jax.vmap(lambda t: step_increment(block_key, t))(
            jnp.arange(n_steps))                       # (n_steps, block)
        logs = jnp.cumsum(inc, axis=0)
        first = jnp.zeros((1, cfg.path_block), dtype)
        return jnp.exp(jnp.concatenate([first, logs], axis=0))

    block_keys = jax.vmap(lambda b: jax.random.fold_in(key, b))(
        first_block + jnp.arange(nb))
    out = jax.vmap(sim_block)(block_keys)
    if return_paths:
        return jnp.transpose(out, (1, 0, 2)).reshape(
            n_steps + 1, nb * cfg.path_block)
    return out.reshape(nb * cfg.path_block)


def split_bates_keys(key: jax.Array):
    """(heston_key, jump_key) — jax.random.split keeps the two sub-streams
    disjoint from each other AND from the per-block fold_in(key, b) domain
    either component uses internally."""
    kh, kj = jax.random.split(key)
    return kh, kj


def simulate_bates(key: jax.Array, S0, r, T, params: BatesParams,
                   cfg: MCConfig, return_paths: bool = True,
                   return_variance: bool = False, first_block=0,
                   scheme: str = "euler"):
    """Simulate Bates paths: Heston (Euler or QE-M) x independent jump overlay.

    ``r`` is the risk-neutral drift EXCLUDING the jump compensator (callers
    subtract any dividend yield as usual); the overlay carries -lam*kbar*dt
    itself. Returns match simulate_heston: S (n_steps+1, n_paths) [, v] or
    terminal S_T (n_paths,) [, v_T].
    """
    kh, kj = split_bates_keys(key)
    hest = simulate_heston(kh, S0, r, T, params.heston, cfg,
                           return_paths=return_paths,
                           return_variance=return_variance,
                           first_block=first_block, scheme=scheme)
    fac = jump_overlay(kj, T, params.lam, params.mu_j, params.sigma_j, cfg,
                       return_paths=return_paths, first_block=first_block)
    if return_variance:
        S, v = hest
        return S * fac, v
    return hest * fac
