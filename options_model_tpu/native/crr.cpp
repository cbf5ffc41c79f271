// Native CRR binomial pricer.
//
// The binomial tree is a strictly sequential triangular recursion — a shape
// that maps poorly onto an accelerator — so the oracle runs host-side. This
// C++ kernel is the fast path behind pricers/binomial.py (ctypes binding); the
// NumPy implementation there is the semantic reference and fallback.
//
// Build: make -C options_model_tpu/native   (produces libcrr.so)

#include <algorithm>
#include <cmath>
#include <limits>
#include <vector>

extern "C" {

// cp: +1 call / -1 put. american: 1 = early exercise allowed.
// q_div: continuous dividend yield (risk-neutral growth r - q_div; the
// discount rate stays r).
double crr_price_q(double S0, double K, double T, double r, double q_div,
                   double sigma, int cp, int n_steps, int american) {
  const double dt = T / n_steps;
  const double u = std::exp(sigma * std::sqrt(dt));
  const double d = 1.0 / u;
  const double disc = std::exp(-r * dt);
  const double p = (std::exp((r - q_div) * dt) - d) / (u - d);
  // Mirror the NumPy fallback's validation: outside (0,1) the tree's
  // risk-neutral measure is invalid — return NaN so the Python wrapper
  // raises instead of silently pricing with negative probabilities.
  if (!(p > 0.0 && p < 1.0)) return std::numeric_limits<double>::quiet_NaN();
  const double q = 1.0 - p;

  std::vector<double> value(n_steps + 1);
  // Terminal layer: S = S0 * u^(2j - n)
  for (int j = 0; j <= n_steps; ++j) {
    const double S_T = S0 * std::exp(sigma * std::sqrt(dt) * (2.0 * j - n_steps));
    value[j] = std::max(cp * (S_T - K), 0.0);
  }

  for (int step = n_steps - 1; step >= 0; --step) {
    for (int j = 0; j <= step; ++j) {
      double cont = disc * (p * value[j + 1] + q * value[j]);
      if (american) {
        const double S_t = S0 * std::exp(sigma * std::sqrt(dt) * (2.0 * j - step));
        const double ex = cp * (S_t - K);
        cont = std::max(cont, ex);
      }
      value[j] = cont;
    }
  }
  return value[0];
}

// Original q-less entry point, kept for ABI stability.
double crr_price(double S0, double K, double T, double r, double sigma,
                 int cp, int n_steps, int american) {
  return crr_price_q(S0, K, T, r, 0.0, sigma, cp, n_steps, american);
}

}  // extern "C"
