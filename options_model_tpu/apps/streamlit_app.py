"""Streamlit web UI (reference component #21, options_model_2_ui.py /
options_ui.py): input widgets -> BS/Heston curve sweeps on the device mesh ->
progress bar -> Plotly charts -> dataframe preview -> CSV download.

Run: streamlit run options_model_tpu/apps/streamlit_app.py

Where the reference forced a spawn start-method and an opt-in process pool
("may cause issues on Windows", options_ui.py:30), the sweep here is a single
jitted sharded program — no worker processes to manage.
"""

from __future__ import annotations

import io

try:
    import streamlit as st
except ImportError:  # pragma: no cover
    raise SystemExit("streamlit is not installed; use the CLI (apps/cli.py)")

from options_model_tpu.core.config import HestonParams, cp_from_str
from options_model_tpu.apps.curves import CurveRequest, compute_curves
from options_model_tpu.utils.plotting import plot_option_curves


def main():
    st.title("American Option Pricer")
    st.caption("Longstaff-Schwartz Monte Carlo on JAX")

    with st.sidebar:
        ticker = st.text_input("Ticker (label only when spot is set)", "AMD")
        spot = st.number_input("Spot price S0", value=120.0, min_value=0.01)
        K = st.number_input("Strike K", value=125.0, min_value=0.01)
        r = st.number_input("Risk-free rate", value=0.05, step=0.01)
        q = st.number_input("Dividend yield q", value=0.0, step=0.01,
                            min_value=0.0)
        sigma = st.number_input("Volatility (sigma)", value=0.30, step=0.01,
                                min_value=0.01)
        option_type = st.selectbox("Option type", ["call", "put"])
        model = st.selectbox("Model", ["bs", "heston", "both", "merton",
                                       "bates", "vg"])
        if model == "vg":
            st.caption("Variance Gamma (pure-jump Levy; sigma above is the "
                       "subordinated-Brownian vol)")
            vg_theta = st.number_input("VG skew theta", value=-0.1, step=0.01)
            vg_nu = st.number_input("VG kurtosis nu", value=0.3,
                                    min_value=0.01, step=0.05)
        if model in ("merton", "bates"):
            st.caption("Jump triple (lognormal jumps on top of the "
                       "diffusion)")
            j_lam = st.number_input("Jump intensity lam", value=0.3,
                                    min_value=0.0, step=0.1)
            j_mu = st.number_input("Mean log-jump mu_j", value=-0.1,
                                   step=0.01)
            j_sig = st.number_input("Log-jump vol sigma_j", value=0.15,
                                    min_value=0.0, step=0.01)
        days = st.slider("Days to expiry", 1, 90, 21)
        ipd = st.slider("Intervals per day", 1, 8, 4)
        sims = st.select_slider("MC paths", [10_000, 50_000, 100_000, 500_000,
                                             1_000_000], value=100_000)
        s0_lo = st.number_input("S0 grid start", value=110)
        s0_hi = st.number_input("S0 grid end", value=130)
        s0_step = st.number_input("S0 grid step", value=5, min_value=1)
        seed = st.number_input("Seed", value=42)

    if not st.button("Run Analysis", type="primary"):
        st.info("Configure the sweep in the sidebar and press Run Analysis.")
        return

    cp = cp_from_str(option_type)
    s0_list = sorted(set(list(range(int(s0_lo), int(s0_hi) + 1,
                                    int(s0_step))) + [int(spot)]))
    total_points = int(days) * int(ipd)
    heston = HestonParams(kappa=2.0, theta=sigma**2, xi=0.3, rho=-0.7,
                          v0=sigma**2)

    bar = st.progress(0.0, text="pricing...")

    def progress(frac, eta):
        bar.progress(min(frac, 1.0), text=f"pricing... ETA {eta:.0f}s")

    runs = []
    if model in ("bs", "both"):
        runs.append(("Black-Scholes", CurveRequest(
            s0_list=s0_list, strike=K, rate=r, cp=cp, model="gbm", sigma=sigma,
            div_yield=float(q),
            intervals_per_day=ipd, total_points=total_points,
            num_simulations=int(sims), seed=int(seed))))
    if model in ("heston", "both"):
        runs.append(("Heston", CurveRequest(
            s0_list=s0_list, strike=K, rate=r, cp=cp, model="heston",
            heston=heston, sigma=None, use_control_variate=False,
            div_yield=float(q),
            intervals_per_day=ipd, total_points=total_points,
            num_simulations=int(sims), seed=int(seed))))
    if model == "merton":
        from options_model_tpu.core.config import MertonParams
        runs.append(("Merton", CurveRequest(
            s0_list=s0_list, strike=K, rate=r, cp=cp, model="merton",
            merton=MertonParams(sigma=sigma, lam=float(j_lam),
                                mu_j=float(j_mu), sigma_j=float(j_sig)),
            sigma=sigma, div_yield=float(q),
            intervals_per_day=ipd, total_points=total_points,
            num_simulations=int(sims), seed=int(seed))))
    if model == "bates":
        from options_model_tpu.core.config import BatesParams
        runs.append(("Bates", CurveRequest(
            s0_list=s0_list, strike=K, rate=r, cp=cp, model="bates",
            bates=BatesParams(heston=heston, lam=float(j_lam),
                              mu_j=float(j_mu), sigma_j=float(j_sig)),
            # same rule as the Heston run above: the f32 COS CV leg's ~2e-3
            # noise floor (charfn.py) isn't worth it at UI path counts
            sigma=None, use_control_variate=False, div_yield=float(q),
            intervals_per_day=ipd, total_points=total_points,
            num_simulations=int(sims), seed=int(seed))))
    if model == "vg":
        from options_model_tpu.core.config import VGParams
        runs.append(("Variance Gamma", CurveRequest(
            s0_list=s0_list, strike=K, rate=r, cp=cp, model="vg",
            vg=VGParams(sigma=sigma, theta=float(vg_theta),
                        nu=float(vg_nu)).validate(),
            # same COS-CV noise-floor rule as the Heston/Bates runs
            sigma=None, use_control_variate=False, div_yield=float(q),
            intervals_per_day=ipd, total_points=total_points,
            num_simulations=int(sims), seed=int(seed))))

    for name, req in runs:
        st.subheader(name)
        try:
            df = compute_curves(req, progress=progress)
        except Exception as e:
            st.error(f"{name} sweep failed: {e}")
            continue
        fig = plot_option_curves(df, s0_list, spot, K, sigma, r, option_type,
                                 ticker, name)
        if fig is not None:
            st.plotly_chart(fig, use_container_width=True)
        st.dataframe(df.head(20))
        buf = io.StringIO()
        df.to_csv(buf, index=False)
        st.download_button(f"Download {name} CSV", buf.getvalue(),
                           file_name=f"{ticker}_{name.lower()}_curves.csv")
    bar.progress(1.0, text="done")


def _in_streamlit() -> bool:
    try:
        from streamlit.runtime.scriptrunner import get_script_run_ctx
        return get_script_run_ctx() is not None
    except Exception:
        return False


if _in_streamlit():  # streamlit executes the module top-level
    main()

