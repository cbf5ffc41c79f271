"""Typed configuration pytrees for the pricing stack.

One frozen-dataclass config layer serving CLI, library, and UI alike — the unified
replacement for the reference's four inconsistent config mechanisms (argparse
namespaces, input() wizards, dataclasses, Streamlit widgets; SURVEY.md §5 "Config /
flag system").

All classes are frozen-dataclass pytrees (core/pytree.py) so they can flow through
`jax.jit` boundaries as static-or-traced leaves. Validation is *eager and explicit* via
``validate()`` (never inside traced code): call it at the user-input boundary.

Reference parity:
- ``HestonParams`` bounds + Feller check: heston_calibration.py:34-73
- LSM/NN hyper-parameters: options_model_3/options_model_3.py:339-374
- calibration knobs: heston_calibration.py:75-90
- IV-surface training knobs: NN_training_stock_iv.py:41-62
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
from options_model_tpu.core.pytree import pytree_dataclass, static_field

# Option type is a float "cp flag": +1 for call, -1 for put. Branch-free payoffs
# (max(cp*(S-K), 0)) keep everything jit/vmap-friendly instead of string dispatch.
CALL: float = 1.0
PUT: float = -1.0


def cp_from_str(option_type: str) -> float:
    ot = option_type.strip().lower()
    if ot in ("call", "c"):
        return CALL
    if ot in ("put", "p"):
        return PUT
    raise ValueError(f"option_type must be 'call' or 'put', got {option_type!r}")


def cp_to_str(cp: float) -> str:
    return "call" if cp > 0 else "put"


@pytree_dataclass
class OptionSpec:
    """A vanilla option contract + market environment.

    Mirrors the scalar argument cluster (S0, K, T, r, sigma, option_type) threaded
    through every reference pricer (e.g. options_model_3/options_model_3.py:439-445).
    """

    strike: float
    rate: float
    cp: float = CALL  # +1 call / -1 put
    sigma: Optional[float] = None  # constant (BS) vol; None when Heston/local-vol drives
    # Continuous dividend yield q: risk-neutral drift is (rate - q), discounting
    # stays at ``rate``. Neither the reference nor round 1 modeled dividends —
    # the single most material gap for real equity options (VERDICT r1 #10).
    div_yield: float = 0.0

    def validate(self) -> "OptionSpec":
        if self.strike <= 0:
            raise ValueError(f"strike must be positive, got {self.strike}")
        if self.rate < 0:
            raise ValueError(f"rate must be non-negative, got {self.rate}")
        if self.cp not in (CALL, PUT):
            raise ValueError(f"cp must be +1 (call) or -1 (put), got {self.cp}")
        if self.sigma is not None and self.sigma <= 0:
            raise ValueError(f"sigma must be positive, got {self.sigma}")
        if self.div_yield < 0:
            raise ValueError(f"div_yield must be non-negative, "
                             f"got {self.div_yield}")
        return self

    def payoff(self, S):
        return jnp.maximum(self.cp * (S - self.strike), 0.0)


@pytree_dataclass
class HestonParams:
    """Heston stochastic-volatility parameters.

    dv = kappa (theta - v) dt + xi sqrt(v) dW2,   corr(dW1, dW2) = rho

    Validation bounds follow the reference (heston_calibration.py:43-54); ``xi``
    is the vol-of-vol (the reference's calibration module calls it ``sigma``).
    """

    kappa: float  # mean-reversion speed
    theta: float  # long-run variance
    xi: float     # vol of vol
    rho: float    # spot/vol correlation
    v0: float     # initial variance

    def validate(self) -> "HestonParams":
        if not (0 < self.kappa < 20):
            raise ValueError(f"kappa={self.kappa} must be in (0, 20)")
        if not (0 < self.theta < 2):
            raise ValueError(f"theta={self.theta} must be in (0, 2)")
        if not (0 < self.xi < 3):
            raise ValueError(f"xi={self.xi} must be in (0, 3)")
        if not (-1 < self.rho < 1):
            raise ValueError(f"rho={self.rho} must be in (-1, 1)")
        if not (0 < self.v0 < 2):
            raise ValueError(f"v0={self.v0} must be in (0, 2)")
        return self

    def feller_condition(self) -> bool:
        """2*kappa*theta >= xi^2 keeps the variance process strictly positive."""
        return bool(2.0 * self.kappa * self.theta >= self.xi**2)

    def to_array(self) -> jnp.ndarray:
        return jnp.array([self.kappa, self.theta, self.xi, self.rho, self.v0])

    @classmethod
    def from_array(cls, x) -> "HestonParams":
        return cls(kappa=float(x[0]), theta=float(x[1]), xi=float(x[2]),
                   rho=float(x[3]), v0=float(x[4]))

    def __str__(self) -> str:
        feller = "ok" if self.feller_condition() else "VIOLATED"
        return (f"HestonParams(kappa={self.kappa:.4f}, theta={self.theta:.4f}, "
                f"xi={self.xi:.4f}, rho={self.rho:.4f}, v0={self.v0:.4f}) "
                f"Feller: {feller}")


@pytree_dataclass
class MertonParams:
    """Merton (1976) jump-diffusion parameters (beyond-reference dynamics).

    dS/S = (r - q - lam*kbar) dt + sigma dW + (J - 1) dN,
    N ~ Poisson(lam), log J ~ N(mu_j, sigma_j^2),
    kbar = E[J - 1] = exp(mu_j + sigma_j^2/2) - 1 (drift compensator, so the
    discounted price is a martingale).
    """

    sigma: float    # diffusive volatility
    lam: float      # jump intensity (expected jumps / year)
    mu_j: float     # mean log-jump size
    sigma_j: float  # log-jump-size volatility

    def validate(self) -> "MertonParams":
        if self.sigma <= 0:
            raise ValueError(f"sigma={self.sigma} must be positive")
        if self.lam < 0:
            raise ValueError(f"lam={self.lam} must be non-negative")
        if self.sigma_j < 0:
            raise ValueError(f"sigma_j={self.sigma_j} must be non-negative")
        return self

    def kbar(self) -> float:
        import math
        return math.exp(self.mu_j + 0.5 * self.sigma_j**2) - 1.0


@pytree_dataclass
class BatesParams:
    """Bates (1996) stochastic-volatility jump-diffusion (beyond-reference).

    Heston variance dynamics plus a compound-Poisson lognormal jump in the
    spot, independent of both Brownian drivers:

        dS/S = (r - q - lam*kbar) dt + sqrt(v) dW1 + (J - 1) dN
        dv   = kappa (theta - v) dt + xi sqrt(v) dW2

    The jump component is INDEPENDENT of (W1, W2, v), so the simulated Bates
    path is exactly (Heston path with the extra -lam*kbar drift) x exp(the
    compensated compound-jump process) — the jump overlay composes with any
    Heston discretization (Euler, QE-M, the fused GPU terminal kernel)
    without touching it (models/bates.py).
    """

    heston: HestonParams
    lam: float      # jump intensity (expected jumps / year)
    mu_j: float     # mean log-jump size
    sigma_j: float  # log-jump-size volatility

    def validate(self) -> "BatesParams":
        self.heston.validate()
        if self.lam < 0:
            raise ValueError(f"lam={self.lam} must be non-negative")
        if self.sigma_j < 0:
            raise ValueError(f"sigma_j={self.sigma_j} must be non-negative")
        return self

    def kbar(self) -> float:
        import math
        return math.exp(self.mu_j + 0.5 * self.sigma_j**2) - 1.0

    def feller_condition(self) -> bool:
        return self.heston.feller_condition()

    def to_array(self) -> jnp.ndarray:
        """(kappa, theta, xi, rho, v0, lam, mu_j, sigma_j) — the calibration
        parameter vector (calibration/calibrator.py's x layout)."""
        return jnp.concatenate([self.heston.to_array(),
                                jnp.array([self.lam, self.mu_j,
                                           self.sigma_j])])

    @classmethod
    def from_array(cls, x) -> "BatesParams":
        return cls(heston=HestonParams.from_array(x[:5]), lam=float(x[5]),
                   mu_j=float(x[6]), sigma_j=float(x[7]))

    def __str__(self) -> str:
        return (f"BatesParams({self.heston}, lam={self.lam:.4f}, "
                f"mu_j={self.mu_j:.4f}, sigma_j={self.sigma_j:.4f})")


@pytree_dataclass
class VGParams:
    """Variance Gamma (Madan-Carr-Chang 1998) pure-jump Levy parameters
    (beyond-reference dynamics).

        X_t = theta * G_t + sigma * W_{G_t},  G a gamma process with unit
        mean rate and variance rate nu;  S_t = S0 exp((r - q + omega) t + X_t)
        with omega = ln(1 - theta*nu - sigma^2*nu/2) / nu (the martingale
        compensator: E[e^{X_t}] = e^{-omega t}).

    Infinite-activity jumps, no diffusion component: the gamma subordinator
    makes EXACT increment simulation over any step trivial (two fixed-shape
    draws — a gamma time increment and a normal), models/vg.py.
    """

    sigma: float  # volatility of the subordinated Brownian motion
    theta: float  # drift of the subordinated Brownian motion (skew)
    nu: float     # variance rate of the gamma clock (kurtosis)

    def validate(self) -> "VGParams":
        if self.sigma <= 0:
            raise ValueError(f"sigma={self.sigma} must be positive")
        if self.nu <= 0:
            raise ValueError(f"nu={self.nu} must be positive")
        if 1.0 - self.theta * self.nu - 0.5 * self.sigma**2 * self.nu <= 0:
            raise ValueError(
                "martingale compensator undefined: need "
                f"theta*nu + sigma^2*nu/2 < 1, got theta={self.theta}, "
                f"sigma={self.sigma}, nu={self.nu}")
        return self

    def omega(self) -> float:
        """Martingale drift correction ln(1 - theta nu - sigma^2 nu/2)/nu."""
        import math
        return math.log(1.0 - self.theta * self.nu
                        - 0.5 * self.sigma**2 * self.nu) / self.nu

    def to_array(self) -> jnp.ndarray:
        return jnp.array([self.sigma, self.theta, self.nu])

    @classmethod
    def from_array(cls, x) -> "VGParams":
        return cls(sigma=float(x[0]), theta=float(x[1]), nu=float(x[2]))

    def __str__(self) -> str:
        return (f"VGParams(sigma={self.sigma:.4f}, theta={self.theta:.4f}, "
                f"nu={self.nu:.4f})")


@pytree_dataclass
class SABRParams:
    """SABR stochastic-volatility parameters (beyond-reference dynamics).

        dF = alpha_t F^beta dW1,   d alpha = nu alpha dW2,
        corr(dW1, dW2) = rho,  alpha_0 = alpha.

    The industry-standard smile model (Hagan et al. 2002, "Managing Smile
    Risk"); ``models/sabr.py`` carries the closed-form lognormal implied vol,
    the exact-lognormal-alpha simulator, and the smile calibrator.
    """

    alpha: float  # initial instantaneous vol level
    beta: float   # CEV backbone exponent in [0, 1]
    rho: float    # forward/vol correlation
    nu: float     # vol of vol

    def validate(self) -> "SABRParams":
        if self.alpha <= 0:
            raise ValueError(f"alpha={self.alpha} must be positive")
        if not 0.0 <= self.beta <= 1.0:
            raise ValueError(f"beta={self.beta} must be in [0, 1]")
        if not -1.0 < self.rho < 1.0:
            raise ValueError(f"rho={self.rho} must be in (-1, 1)")
        if self.nu < 0:
            raise ValueError(f"nu={self.nu} must be non-negative")
        return self

    def to_array(self) -> jnp.ndarray:
        return jnp.array([self.alpha, self.beta, self.rho, self.nu])

    @classmethod
    def from_array(cls, x) -> "SABRParams":
        return cls(alpha=float(x[0]), beta=float(x[1]), rho=float(x[2]),
                   nu=float(x[3]))

    def __str__(self) -> str:
        return (f"SABRParams(alpha={self.alpha:.4f}, beta={self.beta:.2f}, "
                f"rho={self.rho:.4f}, nu={self.nu:.4f})")


@pytree_dataclass
class RBergomiParams:
    """Rough Bergomi parameters (beyond-reference dynamics).

        v_t = xi0 * exp(eta * Y_t - eta^2/2 * t^{2H}),
        Y_t = sqrt(2H) int_0^t (t-s)^{H-1/2} dW_s   (Var Y_t = t^{2H}),
        dS/S = r dt + sqrt(v_t) (rho dW + sqrt(1-rho^2) dW_perp)

    Bayer-Friz-Gatheral (2016) "Pricing under rough volatility" with a FLAT
    forward-variance curve xi0. ``H`` is the Hurst roughness (equity-fitted
    values ~0.05-0.15; H=0.5 reduces to a MARKOVIAN lognormal-variance model
    dv = eta v dW, the anchor models/rbergomi.py validates against).
    ``models/rbergomi.py`` carries the hybrid-scheme simulator (the Volterra
    convolution runs as one lower-triangular matmul) and the
    exact-covariance Cholesky oracle.
    """

    H: float     # Hurst exponent of the Volterra kernel, in (0, 0.5]
    eta: float   # vol-of-vol of the log-variance
    rho: float   # spot/vol correlation
    xi0: float   # flat forward variance level (= E[v_t] for all t)

    def validate(self) -> "RBergomiParams":
        if not 0.0 < self.H <= 0.5:
            raise ValueError(f"H={self.H} must be in (0, 0.5] (H=0.5 is the "
                             "Markovian lognormal-variance limit)")
        if self.eta < 0:
            raise ValueError(f"eta={self.eta} must be non-negative")
        if not -1.0 < self.rho < 1.0:
            raise ValueError(f"rho={self.rho} must be in (-1, 1)")
        if not 0.0 < self.xi0 < 2.0:
            raise ValueError(f"xi0={self.xi0} must be in (0, 2)")
        return self

    def to_array(self) -> jnp.ndarray:
        return jnp.array([self.H, self.eta, self.rho, self.xi0])

    @classmethod
    def from_array(cls, x) -> "RBergomiParams":
        return cls(H=float(x[0]), eta=float(x[1]), rho=float(x[2]),
                   xi0=float(x[3]))

    def __str__(self) -> str:
        return (f"RBergomiParams(H={self.H:.3f}, eta={self.eta:.4f}, "
                f"rho={self.rho:.4f}, xi0={self.xi0:.4f})")


@pytree_dataclass
class MCConfig:
    """Monte-Carlo workload shape.

    ``n_paths`` is rounded up internally to a whole number of ``path_block``
    blocks so antithetic pairing stays exact (the reference instead
    truncated to even and simulated an odd tail path separately,
    options_model_3/options_model_3.py:235-249 — a shape-dynamic pattern XLA
    cannot tile).
    """

    n_paths: int = 100_000
    n_steps: int = 50
    antithetic: bool = True
    path_block: int = 4096   # paths per RNG/sharding block; multiple of 256
    dtype: jnp.dtype = static_field(jnp.float32)

    def validate(self) -> "MCConfig":
        if self.n_paths <= 0 or self.n_steps <= 0:
            raise ValueError("n_paths and n_steps must be positive")
        if self.path_block % 256 != 0:
            raise ValueError("path_block must be a multiple of 256 (whole "
                             "power-of-two kernel blocks)")
        return self


@pytree_dataclass
class LSMConfig:
    """Longstaff-Schwartz regression configuration.

    regressor='poly' uses the masked weighted-least-squares polynomial basis (the
    principled version of the vestigial ``lsm_poly_degree`` knob, Options_model.py:53);
    regressor='nn' reproduces the reference's single shared continuation-value MLP
    (SingleLSMNet, options_model_3/options_model_3.py:85-103) in plain JAX.
    """

    regressor: str = static_field("poly")
    poly_degree: int = static_field(3)
    nn_hidden: int = 128
    nn_layers: int = 3
    nn_epochs: int = 25
    nn_lr: float = 1e-3
    nn_batch: int = 4096
    nn_dropout: float = 0.1
    # Policy-iteration rounds for the shared continuation net. The
    # reference's pass-1 targets are the discounted TERMINAL cashflows
    # (options_model_3/options_model_3.py:485-516) — whose true regression
    # function IS the European value, so the induced policy exercises
    # wherever the payoff's time value is negative: far too early (measured
    # -2.6% to -3.4% vs CRR on the 50-date put at 2^16 paths; no net
    # capacity can fix targets that point at the wrong function). Rounds
    # >= 2 refit the net on the cashflows realized under the CURRENT policy
    # (the classic Longstaff-Schwartz target, pricers/american.
    # _policy_targets), converging to a self-consistent policy while keeping
    # the single-shared-net design. Measured (with the residual baseline,
    # pricers/american._nn_continuation): 2 rounds -0.5/-1.0%, 3 rounds
    # -0.3/-0.9% (in-sample/out-of-sample; a 4th is noise). 1 =
    # reference-exact.
    nn_policy_iters: int = static_field(3)
    use_control_variate: bool = True
    # Control-variate coefficient: 'opt' estimates the variance-minimizing
    # beta* = -Cov(cash, adj)/Var(adj) over antithetic pair means
    # (core/stats.optimal_cv_beta) — guarantees the CV never reports a
    # LARGER stderr than the plain estimator (up to estimation noise);
    # 'one' is the reference's fixed beta=1
    # (options_model_3/options_model_3.py:653-677), which is a measured
    # wash-or-worse on ATM puts because antithetic pairing already cancels
    # the monotone component both legs share.
    cv_beta: str = static_field("opt")
    european_approximation: bool = False
    # Heston only: span the VARIANCE state in the regression basis (w, w^2,
    # u*w columns). The continuation value is a function of (S, v); S-only
    # regression under-detects exercise and prices ~0.7% below the ADI
    # oracle (pricers/fd_heston.py); with the variance columns the gap is
    # ~0.01%. Ignored for dynamics without a variance state.
    variance_basis: bool = static_field(True)
    # Degree of the variance-state block when variance_basis is on: 2 keeps
    # the original [w, w^2, u*w] columns; 3 appends [w^3, u^2 w, u w^2] —
    # the full cubic in (u, w). The (S, v) exercise boundary is a curve in
    # the plane the regression must bend around; measured policy bias on
    # the pooled 6-seed Heston-American leg vs the extrapolated ADI oracle
    # (bench.py): deg3/vdeg2 -0.168%, deg3/vdeg3 -0.131%, deg5/vdeg3
    # -0.056% (+-0.035%) — the accuracy config the bench leg runs. Default
    # stays 2: the cheap config for sweeps, where the shared-path
    # amortization dominates and per-point bias averages out visually.
    variance_basis_degree: int = static_field(2)
    # True: fit regressions (poly) or the continuation net (nn) on half the
    # paths, price on the other half — the low-biased Longstaff-Schwartz
    # estimator (no foresight bias).
    out_of_sample: bool = static_field(False)
    # Common-path Richardson extrapolation to the continuous-exercise limit:
    # the n-date LSM prices a BERMUDAN option (-0.13% at 50 dates); the
    # fine/coarse levels share paths so 2*P_n - P_{n/2} is nearly noise-free
    # (pricers/american.price_american_richardson — this flag routes grid
    # sweeps through the same scheme). poly re-regresses the coarse sub-grid;
    # nn reads both policies off one shared continuation net
    # (pricers/american.richardson_nn_stat).
    richardson: bool = static_field(False)

    def validate(self) -> "LSMConfig":
        if self.regressor not in ("poly", "nn"):
            raise ValueError(f"regressor must be 'poly' or 'nn', got {self.regressor}")
        if not (1 <= self.poly_degree <= 8):
            raise ValueError(f"poly_degree must be in [1, 8], got {self.poly_degree}")
        if self.nn_policy_iters < 1:
            raise ValueError(
                f"nn_policy_iters must be >= 1, got {self.nn_policy_iters}")
        if self.cv_beta not in ("one", "opt"):
            raise ValueError(
                f"cv_beta must be 'one' or 'opt', got {self.cv_beta!r}")
        if self.variance_basis_degree not in (2, 3):
            raise ValueError(f"variance_basis_degree must be 2 or 3, got "
                             f"{self.variance_basis_degree}")
        return self


@pytree_dataclass
class SurfaceTrainConfig:
    """IV-surface network training configuration (NN_training_stock_iv.py:41-62)."""

    epochs: int = 50
    batch_size: int = 128
    lr: float = 1e-3
    weight_decay: float = 1e-4
    lambda_butterfly: float = 1e-3
    lambda_calendar: float = 1e-4
    hidden_dim: int = 64
    num_hidden_layers: int = 4
    dropout: float = 0.1
    epsilon: float = 1e-4       # IV floor applied at the network output
    val_split: float = 0.15
    patience: int = 8
    use_cosine_schedule: bool = True
    use_augmentation: bool = True
    seed: int = 42
    mc_dropout: bool = True
    mc_samples: int = 20
    use_vega_weighting: bool = True
    grad_clip: float = 1.0

    def validate(self) -> "SurfaceTrainConfig":
        if not (0 < self.val_split < 1):
            raise ValueError("val_split must be in (0, 1)")
        if self.epochs <= 0 or self.batch_size <= 0:
            raise ValueError("epochs and batch_size must be positive")
        return self


@pytree_dataclass
class CalibrationConfig:
    """Heston calibration configuration (heston_calibration.py:75-90).

    The pricing engine inside the objective is the COS characteristic-function
    pricer (calibration/charfn.py) — not Monte Carlo — so ``max_iterations`` of a
    few hundred is cheap.
    """

    use_vega_weighting: bool = True
    min_vega_weight: float = 0.01
    max_iterations: int = 2000
    tolerance: float = 1e-8
    cos_n: int = 256           # COS series terms
    cos_L: float = 12.0        # truncation width in std devs
    seed: int = 42
    verbose: bool = False
    regime_detection: bool = True
    optimization_methods: Tuple[str, ...] = static_field(
        ("L-BFGS-B", "differential_evolution", "dual_annealing"),
    )

    def validate(self) -> "CalibrationConfig":
        if self.cos_n < 16:
            raise ValueError("cos_n must be >= 16")
        return self


def asdict(cfg) -> dict:
    """Plain-dict view of any config pytree (for logging / serialization)."""
    return dataclasses.asdict(cfg)
