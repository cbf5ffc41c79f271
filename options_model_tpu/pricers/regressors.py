"""Continuation-value regressors for Longstaff-Schwartz.

Two interchangeable regressors behind the same masked fixed-shape interface
(the fixed-shape answer to the reference's dynamic ITM gathers,
options_model_3/options_model_3.py:490-516 — see SURVEY.md §7 "hard parts"):

- masked weighted least squares on a small polynomial basis (normal
  equations; cross-shard exact via psum of the tiny (d,d)/(d,) Gram blocks)
- a plain-JAX MLP re-implementing SingleLSMNet (7 -> hidden x layers -> 1, ReLU,
  dropout; options_model_3/options_model_3.py:85-103) with a fully jitted
  optax/AdamW training loop (fixed epoch budget, best-weights tracking — the
  compiled-friendly version of the reference's early-stop-and-restore,
  :579-613).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import dataclasses

import jax
import jax.numpy as jnp
import optax

from options_model_tpu.core import nn
from options_model_tpu.core.config import LSMConfig


def solve_spd_small(A: jnp.ndarray, b: jnp.ndarray,
                    refine: int = 1) -> jnp.ndarray:
    """Solve A x = b for small SPD A (..., d, d) by fully unrolled Cholesky.

    d is static and tiny (the LSM basis width), so the factorization unrolls
    into pure elementwise arithmetic — it vmaps/batches perfectly and avoids
    the LAPACK-style custom calls ``jnp.linalg.solve`` lowers to, which
    compile and run poorly when batched inside scans. One step of
    iterative refinement tightens f32 accuracy at negligible cost.
    """
    d = A.shape[-1]

    def chol_solve(rhs):
        L = [[None] * d for _ in range(d)]
        for i in range(d):
            for j in range(i + 1):
                s = A[..., i, j]
                for k in range(j):
                    s = s - L[i][k] * L[j][k]
                if i == j:
                    L[i][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
                else:
                    L[i][j] = s / L[j][j]
        yv = [None] * d
        for i in range(d):
            s = rhs[..., i]
            for k in range(i):
                s = s - L[i][k] * yv[k]
            yv[i] = s / L[i][i]
        xv = [None] * d
        for i in reversed(range(d)):
            s = yv[i]
            for j in range(i + 1, d):
                s = s - L[j][i] * xv[j]
            xv[i] = s / L[i][i]
        return jnp.stack(xv, axis=-1)

    x = chol_solve(b)
    for _ in range(refine):
        r = b - jnp.einsum("...ij,...j->...i", A, x,
                           precision=jax.lax.Precision.HIGHEST)
        x = x + chol_solve(r)
    return x


def masked_wls_theta_centered(X: jnp.ndarray, y: jnp.ndarray, w: jnp.ndarray,
                              axis_name: Optional[str] = None,
                              ridge: float = 1e-7) -> jnp.ndarray:
    """Coefficients of the masked WLS on a caller-conditioned basis — the
    solve half of masked_wls_predict_centered, exposed for consumers that
    need the fitted FUNCTION rather than fitted values (the martingale-dual
    upper bound evaluates it in closed-form expectations, pricers/dual.py)."""
    hi = jax.lax.Precision.HIGHEST
    d = X.shape[-1]
    Z = jnp.concatenate([X, y[:, None]], axis=-1)
    G = jnp.matmul((Z * w[:, None]).T, Z, precision=hi)   # (d+1, d+1)
    if axis_name is not None:
        G = jax.lax.psum(G, axis_name)
    A = G[:d, :d]
    b = G[:d, d]
    lam = ridge * (jnp.trace(A) / d + 1.0)
    A = A + lam * jnp.eye(d, dtype=A.dtype)
    return solve_spd_small(A, b)


def masked_wls_predict_centered(X: jnp.ndarray, y: jnp.ndarray, w: jnp.ndarray,
                                axis_name: Optional[str] = None,
                                ridge: float = 1e-7) -> jnp.ndarray:
    """Fast masked WLS for a basis the CALLER has already conditioned.

    Contract: X's columns are an explicit intercept plus well-scaled,
    near-centered features (e.g. powers of the masked-centered u in
    lsm_poly_backward) — no internal standardization is performed. Everything
    reduces to ONE augmented Gram matmul G = [X|y]^T W [X|y] (a single psum
    under sharding) plus a tiny unrolled-Cholesky solve: ~2 big ops per
    regression instead of ~12 separate masked reductions, which is what the
    per-(date, strike) LSM backward pass is latency-bound on.
    """
    theta = masked_wls_theta_centered(X, y, w, axis_name=axis_name,
                                      ridge=ridge)
    return jnp.matmul(X, theta, precision=jax.lax.Precision.HIGHEST)


def masked_wls_predict(X: jnp.ndarray, y: jnp.ndarray, w: jnp.ndarray,
                       axis_name: Optional[str] = None,
                       ridge: float = 1e-7) -> jnp.ndarray:
    """Fitted values of argmin_theta sum_i w_i (X_i theta - y_i)^2 at all rows.

    X: (n, d), y: (n,), w: (n,) non-negative weights (0 = excluded row).
    With ``axis_name`` the sufficient statistics are psum-ed across the mesh
    axis, making the sharded regression equivalent to the global one.

    Numerical design:
    - all matmuls at HIGHEST precision — reduced-precision matmul passes
      (bf16, TF32) wreck the Gram conditioning of a polynomial basis
      (observed with bf16 passes: 40% LSM price error vs <0.1% on CPU);
    - columns are standardized against the masked mean/std before the normal
      equations (cond(Gram) drops by orders of magnitude), with the intercept
      handled by centering y; constant columns get zero weight automatically.
    """
    hi = jax.lax.Precision.HIGHEST

    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    wsum = allsum(jnp.maximum(w.sum(), 1e-9))
    x_mean = allsum((X * w[:, None]).sum(0)) / wsum
    x_var = allsum(((X - x_mean) ** 2 * w[:, None]).sum(0)) / wsum
    x_std = jnp.sqrt(jnp.maximum(x_var, 0.0))
    # Constant columns (e.g. an explicit intercept) carry no information once
    # y is centered — null them instead of dividing by ~0.
    keep = x_std > 1e-6
    inv_std = jnp.where(keep, 1.0 / jnp.maximum(x_std, 1e-6), 0.0)
    y_mean = allsum((y * w).sum()) / wsum

    Xs = (X - x_mean) * inv_std
    yc = y - y_mean

    Xw = Xs * w[:, None]
    A = allsum(jnp.matmul(Xw.T, Xs, precision=hi))   # (d, d)
    b = allsum(jnp.matmul(Xw.T, yc, precision=hi))   # (d,)
    lam = ridge * (jnp.trace(A) / A.shape[0] + 1.0)
    A = A + lam * jnp.eye(A.shape[0], dtype=A.dtype)
    theta = solve_spd_small(A, b)
    return jnp.matmul(Xs, theta, precision=hi) + y_mean


@dataclasses.dataclass(frozen=True)
class ContinuationMLP:
    """SingleLSMNet: input_dim -> hidden x num_layers (ReLU, dropout) -> 1.

    ``init(key, x)`` returns ``{"params": {"Dense_0": ..., "Dense_L": ...}}``;
    ``apply(params, x, deterministic, rngs={"dropout": key})`` runs it."""

    hidden: int = 128
    num_layers: int = 3
    dropout: float = 0.1

    def init(self, key: jax.Array, x, deterministic: bool = True) -> dict:
        dims = [x.shape[-1]] + [self.hidden] * self.num_layers + [1]
        keys = jax.random.split(key, len(dims) - 1)
        return {"params": {f"Dense_{i}": nn.dense_init(keys[i], dims[i],
                                                       dims[i + 1])
                           for i in range(len(dims) - 1)}}

    def apply(self, params: dict, x, deterministic: bool = True, rngs=None):
        p = params["params"]
        key = nn.dropout_key(rngs, deterministic)
        for i in range(self.num_layers):
            x = jax.nn.relu(nn.dense(p[f"Dense_{i}"], x))
            x = nn.dropout(x, self.dropout,
                           None if key is None else jax.random.fold_in(key, i))
        return nn.dense(p[f"Dense_{self.num_layers}"], x)


def full_weighted_loss(params, X, y, w, cfg: LSMConfig,
                       chunk: int = 1 << 17) -> jnp.ndarray:
    """Deterministic (no-dropout) ITM-weighted MSE over the FULL data set.

    Evaluated in row chunks under ``lax.map`` so the activation footprint
    stays at chunk x hidden regardless of n (the LSM training set is
    n_dates x n_paths rows — up to ~1e8; a single batched forward would
    need tens of GB of activations). The epoch-level best-weights criterion
    below scores candidates with this, the loss the estimator actually
    cares about."""
    model = ContinuationMLP(hidden=cfg.nn_hidden, num_layers=cfg.nn_layers,
                            dropout=cfg.nn_dropout)
    n, d = X.shape
    chunk = min(chunk, n)
    n_pad = ((n + chunk - 1) // chunk) * chunk
    Xp = jnp.concatenate([X, jnp.zeros((n_pad - n, d), X.dtype)])
    yp = jnp.concatenate([y, jnp.zeros((n_pad - n,), y.dtype)])
    wp = jnp.concatenate([w, jnp.zeros((n_pad - n,), w.dtype)])  # pad weight 0

    def chunk_sums(args):
        xb, yb, wb = args
        pred = model.apply(params, xb, deterministic=True)[:, 0]
        return (jnp.sum(wb * (pred - yb) ** 2), jnp.sum(wb))

    sq, ws = jax.lax.map(chunk_sums,
                         (Xp.reshape(-1, chunk, d), yp.reshape(-1, chunk),
                          wp.reshape(-1, chunk)))
    return jnp.sum(sq) / jnp.maximum(jnp.sum(ws), 1.0)


@partial(jax.jit, static_argnames=("cfg",))
def fit_continuation_mlp(key: jax.Array, X: jnp.ndarray, y: jnp.ndarray,
                         w: jnp.ndarray, cfg: LSMConfig):
    """Train the continuation MLP on masked data; returns
    (best_params, epoch_losses).

    X: (n, d) standardized features; y: (n,) standardized targets; w: (n,)
    weights (ITM mask). The loop is one lax.scan over epochs (inner scan over
    minibatch steps) — no host round-trips, compiled once per shape.

    Best-weights criterion: after each epoch the FULL-data deterministic
    weighted loss is evaluated and the lowest-scoring params are kept — the
    compiled analogue of the reference's epoch-granular early-stop-and-restore
    (options_model_3/options_model_3.py:599-613). A per-minibatch criterion
    (round 1/2) kept whichever params saw the luckiest batch, which is noise,
    not fit quality (VERDICT r2 weak #4). ``epoch_losses`` are those full-data
    losses, one per epoch."""
    model = ContinuationMLP(hidden=cfg.nn_hidden, num_layers=cfg.nn_layers,
                            dropout=cfg.nn_dropout)
    n = X.shape[0]
    batch = min(cfg.nn_batch, n)
    steps_per_epoch = min(max(n // batch, 1), 512)

    init_key, key = jax.random.split(key)
    params = model.init(init_key, X[:1], deterministic=True)
    tx = optax.adamw(cfg.nn_lr, weight_decay=1e-5)
    opt_state = tx.init(params)

    def loss_fn(p, xb, yb, wb, dk):
        pred = model.apply(p, xb, deterministic=False, rngs={"dropout": dk})[:, 0]
        return jnp.sum(wb * (pred - yb) ** 2) / jnp.maximum(jnp.sum(wb), 1.0)

    def train_step(carry, step_key):
        params, opt_state = carry
        ik, dk = jax.random.split(step_key)
        idx = jax.random.randint(ik, (batch,), 0, n)
        xb, yb, wb = X[idx], y[idx], w[idx]
        _, grads = jax.value_and_grad(loss_fn)(params, xb, yb, wb, dk)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), None

    def epoch(carry, epoch_key):
        params, opt_state, best_loss, best_params = carry
        (params, opt_state), _ = jax.lax.scan(
            train_step, (params, opt_state),
            jax.random.split(epoch_key, steps_per_epoch))
        loss = full_weighted_loss(params, X, y, w, cfg)
        better = loss < best_loss
        best_loss = jnp.where(better, loss, best_loss)
        best_params = jax.tree.map(
            lambda new, old: jnp.where(better, new, old), params, best_params)
        return (params, opt_state, best_loss, best_params), loss

    epoch_keys = jax.random.split(key, cfg.nn_epochs)
    (params, _, _, best_params), epoch_losses = jax.lax.scan(
        epoch, (params, opt_state, jnp.inf, params), epoch_keys)
    return best_params, epoch_losses


def mlp_predict(params, x, cfg: LSMConfig, chunk: int = 1 << 17):
    """Evaluate the continuation net on ``x`` (n, d) -> (n,).

    Row-chunked under lax.map (same rule as the full-data epoch loss above):
    the LSM pass-2 set is (n_dates x n_paths) rows — a single batched apply
    at 2^18 paths x 50 dates materializes multi-GB activations and OOMs the
    chip (observed: RESOURCE_EXHAUSTED in the bench's NN leg)."""
    model = ContinuationMLP(hidden=cfg.nn_hidden, num_layers=cfg.nn_layers,
                            dropout=cfg.nn_dropout)
    n, d = x.shape
    if n <= chunk:
        return model.apply(params, x, deterministic=True)[:, 0]
    n_pad = ((n + chunk - 1) // chunk) * chunk
    xp = jnp.concatenate([x, jnp.zeros((n_pad - n, d), x.dtype)])
    out = jax.lax.map(
        lambda xc: model.apply(params, xc, deterministic=True)[:, 0],
        xp.reshape(-1, chunk, d))
    return out.reshape(-1)[:n]
