"""Application layer: curve orchestration, CLI (offline), plotting gates,
profiling utilities."""

import jax
import numpy as np
import pytest

from options_model_tpu.apps.cli import parse_args, run
from options_model_tpu.apps.curves import (
    CurveRequest,
    compute_curve_for_S0,
    compute_curves,
)
from options_model_tpu.core.config import HestonParams
from options_model_tpu.utils.profiling import (
    Timer,
    device_memory_stats,
    estimate_total_runtime,
)


class TestCurves:
    def test_sweep_schema_and_shape(self, key):
        req = CurveRequest(s0_list=[95.0, 100.0, 105.0], strike=100.0,
                           rate=0.05, cp=-1.0, intervals_per_day=2,
                           total_points=4, num_simulations=4096,
                           sigma=0.2, engine="xla", use_control_variate=False)
        df = compute_curves(req)
        assert list(df.columns) == ["S0", "Days to Expiry", "Option Value",
                                    "StdErr"]
        assert len(df) == 3 * 4
        # >= 0 (exactly 0 when every payoff is identical, e.g. deep OTM)
        assert (df["StdErr"] >= 0).all() and (df["StdErr"] > 0).any()
        # descending days within each S0 (reference record ordering)
        one = df[df["S0"] == 95.0]["Days to Expiry"].values
        assert one[0] > one[-1]

    def test_put_value_decreasing_in_s0(self):
        req = CurveRequest(s0_list=[90.0, 100.0, 110.0], strike=100.0,
                           rate=0.05, cp=-1.0, intervals_per_day=1,
                           total_points=2, num_simulations=8192, sigma=0.2,
                           engine="xla")
        df = compute_curves(req)
        far = df[df["Days to Expiry"] == df["Days to Expiry"].max()]
        vals = far.sort_values("S0")["Option Value"].values
        assert vals[0] > vals[1] > vals[2]

    def test_progress_callback_called(self):
        calls = []
        req = CurveRequest(s0_list=[100.0], strike=100.0, rate=0.05,
                           cp=-1.0, intervals_per_day=1, total_points=2,
                           num_simulations=2048, sigma=0.2, engine="xla")
        compute_curves(req, progress=lambda f, eta: calls.append((f, eta)))
        assert calls and calls[-1][0] == pytest.approx(1.0)

    def test_single_s0_curve(self, key):
        recs = compute_curve_for_S0(key, 100.0, 100.0, 0.05, -1.0,
                                    intervals_per_day=1, total_points=3,
                                    num_simulations=4096, sigma=0.2,
                                    engine="xla")
        assert len(recs) == 3
        assert all(np.isfinite(r["Option Value"]) for r in recs)

    def test_heston_sweep(self):
        hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
        req = CurveRequest(s0_list=[100.0], strike=100.0, rate=0.05, cp=-1.0,
                           intervals_per_day=1, total_points=2,
                           num_simulations=4096, model="heston", heston=hp,
                           sigma=None, use_control_variate=False, engine="xla")
        df = compute_curves(req)
        assert np.isfinite(df["Option Value"]).all()


class TestCLI:
    def test_parse_defaults(self):
        args = parse_args([])
        assert args.model == "both" and args.K == 125.0

    def test_offline_bs_run(self, tmp_path):
        csv = str(tmp_path / "out.csv")
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", "bs", "--num-simulations", "4096",
            "--s0-start", "95", "--s0-end", "105", "--s0-step", "5",
            "--total-points", "2", "--intervals-per-day", "1",
            "--engine", "xla", "--csv", csv, "--option-type", "put"])
        out = run(args)
        assert "bs" in out and len(out["bs"]) > 0
        assert (tmp_path / "out_bs.csv").exists()
        assert 0 < out["greeks"]["Gamma"] < 1

    def test_offline_heston_run(self):
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.25", "--K", "100",
            "--model", "heston", "--num-simulations", "4096",
            "--s0-start", "100", "--s0-end", "100", "--s0-step", "1",
            "--total-points", "1", "--intervals-per-day", "1",
            "--engine", "xla"])
        out = run(args)
        assert np.isfinite(out["heston"]["Option Value"]).all()

    def test_greeks_override(self):
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--model", "bs",
            "--num-simulations", "2048", "--s0-start", "100", "--s0-end", "100",
            "--total-points", "1", "--intervals-per-day", "1",
            "--engine", "xla",
            "--greeks", "0.5", "0.02", "0.3", "-0.01", "0.2"])
        out = run(args)
        assert out["greeks"]["Delta"] == 0.5

    @pytest.mark.slow
    def test_synthetic_nn_iv_run(self):
        # --iv nn with --synthetic: surface net trained on the smile oracle,
        # then local-vol curves (exercises the whole NN-IV pipeline offline).
        args = parse_args([
            "--spot", "100", "--K", "100", "--model", "bs", "--iv", "nn",
            "--synthetic", "--nn-epochs", "60", "--nn-hidden", "16",
            "--num-simulations", "2048", "--s0-start", "100", "--s0-end", "100",
            "--total-points", "1", "--intervals-per-day", "1",
            "--engine", "xla", "--option-type", "put"])
        out = run(args)
        assert 0.01 < out["sigma"] < 1.0
        assert np.isfinite(out["bs"]["Option Value"]).all()


class TestUtils:
    def test_timer(self):
        with Timer("x") as t:
            sum(range(1000))
        assert t.elapsed >= 0.0

    def test_eta(self):
        assert estimate_total_runtime(10.0, 2, 10) == pytest.approx(50.0)
        assert estimate_total_runtime(10.0, 2, 10, n_parallel=5) == pytest.approx(10.0)
        assert estimate_total_runtime(1.0, 0, 10) == 0.0

    def test_memory_stats_no_crash(self):
        stats = device_memory_stats()
        assert isinstance(stats, dict)

    def test_plot_gates_no_crash(self):
        import pandas as pd
        from options_model_tpu.utils.plotting import (
            plot_calibration_results,
            plot_option_curves,
            plot_training_diagnostics,
        )
        df = pd.DataFrame({"S0": [100.0, 100.0], "Days to Expiry": [2.0, 1.0],
                           "Option Value": [5.0, 4.0]})
        plot_option_curves(df, [100.0], 100.0, 100.0, 0.2, 0.05, "put",
                           "TEST", "BS")
        plot_training_diagnostics([1.0, 0.5], [1.1, 0.6],
                                  np.array([100.0]), np.array([0.5]),
                                  np.array([0.2]), np.array([0.21]))
        hp = HestonParams(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
        plot_calibration_results(np.array([0.2, 0.25]), np.array([0.21, 0.24]),
                                 np.array([10.0, 12.0]), hp, 0.01, "normal_vol")


class TestInteractiveWizard:
    def test_wizard_overrides_and_defaults(self):
        from options_model_tpu.apps.cli import interactive_wizard
        args = parse_args(["--K", "100"])
        answers = iter([
            "TSLA",   # ticker
            "",       # expiry
            "105",    # strike
            "",       # rate
            "0.01",   # dividend yield q
            "put",    # option type
            "",       # simulations
            "",       # seed
            "", "", "",  # s0 start/end/step
            "",       # intervals per day
            "heston",  # model
            "0.3",    # iv
            "qe",     # heston scheme
            "nn",     # lsm regressor
            "y",      # richardson
            "y",      # european approximation
            "",       # greeks override (blank = compute)
        ])
        out = interactive_wizard(args, input_fn=lambda prompt: next(answers))
        assert out.ticker == "TSLA"
        assert out.K == 105.0
        assert out.q == 0.01
        assert out.option_type == "put"
        assert out.model == "heston"
        assert out.iv == "0.3"
        assert out.heston_scheme == "qe"
        assert out.lsm_regressor == "nn"
        assert out.richardson is True
        assert out.european_approximation is True
        assert out.greeks is None  # blank kept the computed Greeks
        assert out.r == 0.05  # blank kept the default

    def test_wizard_greeks_override(self):
        from options_model_tpu.apps.cli import interactive_wizard
        args = parse_args([])
        answers = iter([""] * 18 + ["0.5 0.02 0.1 -0.01 0.05"])
        out = interactive_wizard(args, input_fn=lambda prompt: next(answers))
        assert out.greeks == [0.5, 0.02, 0.1, -0.01, 0.05]

    @pytest.mark.parametrize("bad", ["0.5 0.02 0.1", "delta=0.5"])
    def test_wizard_greeks_malformed_keeps_computed(self, bad, capsys):
        # malformed override must not abort the 19-prompt session
        from options_model_tpu.apps.cli import interactive_wizard
        args = parse_args([])
        answers = iter([""] * 18 + [bad])
        out = interactive_wizard(args, input_fn=lambda prompt: next(answers))
        assert out.greeks is None
        assert "exactly 5 numbers" in capsys.readouterr().out

    def test_wizard_invalid_choice_keeps_current(self, capsys):
        # Choice-constrained prompts mirror argparse's choices= validation: a
        # typo ('qe-m', 'poli') keeps the current value visibly instead of
        # surviving all 19 prompts and crashing deep in pricing.
        from options_model_tpu.apps.cli import interactive_wizard
        args = parse_args([])
        answers = [""] * 19
        answers[5] = "pu"            # option type typo
        answers[12] = "blackscholes"  # model typo
        answers[14] = "qe-m"         # heston scheme typo
        answers[15] = "poli"         # lsm regressor typo
        it = iter(answers)
        out = interactive_wizard(args, input_fn=lambda prompt: next(it))
        assert out.option_type == "call"
        assert out.model == "both"
        assert out.heston_scheme == "euler"
        assert out.lsm_regressor == "poly"
        assert capsys.readouterr().out.count("is not one of") == 4

    def test_cli_progress_bar_renders(self):
        import io

        from options_model_tpu.apps.cli import _progress_bar
        buf = io.StringIO()
        cb = _progress_bar("sweep", stream=buf)
        cb(0.5, 12.0)
        cb(1.0, 0.0)
        text = buf.getvalue()
        assert "sweep" in text and "50%" in text and "100%" in text
        assert text.endswith("\n")  # finished bar closes the line

    def test_european_approximation_grid(self, key):
        # euro-approx sweep should track BS European closely
        from options_model_tpu.pricers import bs_price
        req = CurveRequest(s0_list=[100.0], strike=100.0, rate=0.05, cp=1.0,
                           intervals_per_day=1, total_points=1,
                           num_simulations=65536, sigma=0.2,
                           european_approximation=True, engine="xla")
        df = compute_curves(req)
        T = 1.0 / 365.0
        bs = float(bs_price(100.0, 100.0, T, 0.05, 0.2, 1.0))
        assert abs(df["Option Value"].iloc[0] - bs) < 0.05


class TestNewCLIFlags:
    def test_qe_and_oos_flags(self):
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.25", "--K", "100",
            "--model", "heston", "--heston-scheme", "qe",
            "--lsm-out-of-sample", "--num-simulations", "8192",
            "--s0-start", "100", "--s0-end", "100", "--total-points", "1",
            "--intervals-per-day", "1", "--engine", "xla"])
        out = run(args)
        assert np.isfinite(out["heston"]["Option Value"]).all()


class TestBracketFlag:
    @pytest.mark.slow
    def test_cli_bracket(self, caplog):
        """--bracket reports a live-spot primal-dual interval with
        low <= high and both finite (pricers/dual.py through the CLI)."""
        from options_model_tpu.apps.cli import parse_args, run
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", "bs", "--bracket", "--num-simulations", "8192",
            "--s0-start", "100", "--s0-end", "100", "--total-points", "1",
            "--intervals-per-day", "1", "--engine", "xla",
            "--option-type", "put"])
        out = run(args)
        br = out["bracket"]
        assert np.isfinite([br["low"], br["high"]]).all()
        assert 0.0 < br["low"] <= br["high"]
        assert br["low_stderr"] > 0 and br["high_stderr"] > 0

    @pytest.mark.slow
    def test_cli_bracket_heston(self):
        """--bracket under --model heston routes the variance-basis policy
        and the Euler-replicating dual (out['bracket_heston'])."""
        from options_model_tpu.apps.cli import parse_args, run
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", "heston", "--bracket", "--num-simulations", "8192",
            "--s0-start", "100", "--s0-end", "100", "--total-points", "1",
            "--intervals-per-day", "1", "--engine", "xla",
            "--option-type", "put"])
        out = run(args)
        assert "bracket" not in out  # GBM leg not requested
        br = out["bracket_heston"]
        assert np.isfinite([br["low"], br["high"]]).all()
        assert 0.0 < br["low"] <= br["high"]
        assert br["low_stderr"] > 0 and br["high_stderr"] > 0


class TestNNLSMEndToEnd:
    @pytest.mark.slow
    def test_grid_nn_regressor_agrees_with_poly_and_crr(self, key, devices8):
        """The NN-LSM regressor reached through the grid pricer agrees with
        the poly regressor and the CRR oracle on a GBM put (VERDICT r1 #3)."""
        from options_model_tpu.core.config import PUT, LSMConfig, MCConfig
        from options_model_tpu.parallel import make_mesh, price_american_grid
        from options_model_tpu.pricers import crr_american

        mesh = make_mesh(("tasks",), devices=devices8)
        S0s = np.full(8, 100.0, np.float32)
        Ks = np.full(8, 100.0, np.float32)
        Ts = np.full(8, 0.5, np.float32)
        mc = MCConfig(n_paths=16384, n_steps=12, path_block=2048)
        lsm_nn = LSMConfig(regressor="nn", nn_epochs=30, nn_hidden=64,
                           nn_layers=2, nn_dropout=0.0, nn_lr=3e-3)
        p_nn = price_american_grid(key, S0s, Ks, Ts, 0.05, mc, mesh, cp=PUT,
                                   sigma=0.2, model="gbm", engine="xla",
                                   use_control_variate=False, lsm=lsm_nn)
        p_poly = price_american_grid(key, S0s, Ks, Ts, 0.05, mc, mesh, cp=PUT,
                                     sigma=0.2, model="gbm", engine="xla",
                                     use_control_variate=False)
        crr = crr_american(100.0, 100.0, 0.5, 0.05, 0.2, PUT, n_steps=2048)
        # The reference's two-pass NN scheme regresses on discounted TERMINAL
        # cashflows (options_model_3.py:482-516), which under-detects early
        # exercise: measured ~1.6% low vs poly/CRR on this workload. 3% band
        # pins the wiring + the scheme's intrinsic accuracy.
        assert abs(float(p_nn[0]) / crr - 1.0) < 0.03
        assert abs(float(p_nn[0]) / float(p_poly[0]) - 1.0) < 0.03

    @pytest.mark.slow
    def test_cli_lsm_regressor_nn(self):
        from options_model_tpu.apps.cli import parse_args, run
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", "bs", "--lsm-regressor", "nn", "--nn-epochs", "5",
            "--nn-hidden", "16", "--num-simulations", "4096",
            "--s0-start", "100", "--s0-end", "100", "--total-points", "1",
            "--intervals-per-day", "1", "--engine", "xla",
            "--option-type", "put"])
        out = run(args)
        assert np.isfinite(out["bs"]["Option Value"]).all()
        assert (out["bs"]["Option Value"] > 0).all()

    def test_cli_oos_with_nn_regressor_rejected(self):
        from options_model_tpu.apps.cli import parse_args, run
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--model", "bs",
            "--lsm-regressor", "nn", "--lsm-out-of-sample",
            "--num-simulations", "2048", "--s0-start", "100",
            "--s0-end", "100", "--total-points", "1",
            "--intervals-per-day", "1", "--engine", "xla"])
        with pytest.raises(ValueError, match="out_of_sample"):
            run(args)


class TestTradingGrid:
    def test_curves_trading_step_rule(self):
        """grid_mode='trading' uses the v1.5 step clamp ceil(d*intervals) in
        [2, 500] (options_model_v1.5.py:221) and prices finitely."""
        req = CurveRequest(s0_list=[100.0], strike=100.0, rate=0.05, cp=-1.0,
                           intervals_per_day=2, total_points=2,
                           num_simulations=2048, sigma=0.2,
                           grid_mode="trading", engine="xla",
                           use_control_variate=False)
        df = compute_curves(req)
        assert np.isfinite(df["Option Value"]).all()

    def test_curves_rejects_bad_grid_mode(self):
        req = CurveRequest(s0_list=[100.0], strike=100.0, rate=0.05,
                           grid_mode="lunar", num_simulations=2048, sigma=0.2)
        with pytest.raises(ValueError, match="grid_mode"):
            compute_curves(req)

    def test_cli_trading_grid_derives_points(self):
        """--grid-mode trading derives total_points from the remaining
        regular-session hours to --expiry (VERDICT r1 weak #5)."""
        import datetime
        from options_model_tpu.core.timegrid import (
            TRADING_HOURS_PER_DAY, compute_trading_hours_remaining)
        expiry = datetime.date.today() + datetime.timedelta(days=3)
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", "bs", "--grid-mode", "trading",
            "--expiry", expiry.isoformat(),
            "--num-simulations", "2048", "--s0-start", "100",
            "--s0-end", "100", "--s0-step", "1",
            "--intervals-per-day", "1", "--engine", "xla",
            "--option-type", "put", "--no-control-variate"])
        out = run(args)
        hours = compute_trading_hours_remaining(expiry)
        expected = max(1, int(np.ceil(hours / TRADING_HOURS_PER_DAY)))
        assert len(out["bs"]) == expected


class TestVerboseStats:
    def test_cashflow_statistics_values(self):
        import jax.numpy as jnp
        from options_model_tpu.core.stats import cashflow_statistics
        cash = jnp.array([0.0, 2.0, 4.0, 100.0])
        mask = jnp.array([1.0, 1.0, 1.0, 0.0])  # masked-out outlier
        st = {k: float(v) for k, v in cashflow_statistics(cash, mask).items()}
        assert st["mean"] == pytest.approx(2.0)
        assert st["min"] == 0.0 and st["max"] == 4.0
        assert st["p_worthless"] == pytest.approx(1.0 / 3.0)
        assert st["std"] == pytest.approx(2.0)

    def test_cli_verbose_emits_live_stats(self):
        """--verbose reports the reference's pricing statistics at the live
        spot (mean/std/min/max/P(worthless), options_model_2.py:316-333)."""
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", "bs", "--num-simulations", "8192",
            "--s0-start", "100", "--s0-end", "100", "--total-points", "1",
            "--intervals-per-day", "1", "--engine", "xla",
            "--option-type", "put", "--verbose"])
        out = run(args)
        st = out["live_stats"]
        assert 0.0 <= st["p_worthless"] <= 1.0
        assert st["min"] >= 0.0 and st["max"] > st["mean"] > 0.0


class TestSurfaceCLI:
    def test_european_cos_surface_with_iv(self, tmp_path):
        from options_model_tpu.apps.price_surface import main, parse_args, run
        csv = str(tmp_path / "surf.csv")
        args = parse_args([
            "--style", "european", "--model", "heston", "--option-type",
            "call", "--nk", "8", "--nt", "4", "--with-iv", "--csv", csv])
        out = run(args)
        df = out["df"]
        assert len(df) == 32 and np.isfinite(df["price"]).all()
        # COS surface IVs should sit in a sane band around sqrt(theta)=0.2
        assert ((df["iv"] > 0.05) & (df["iv"] < 0.8)).all()
        assert (tmp_path / "surf.csv").exists()

    def test_american_gbm_surface_matches_crr_corner(self):
        from options_model_tpu.apps.price_surface import parse_args, run
        from options_model_tpu.pricers import crr_american
        args = parse_args([
            "--style", "american", "--model", "gbm", "--sigma", "0.2",
            "--option-type", "put", "--nk", "4", "--nt", "2",
            "--k-min", "90", "--k-max", "110", "--t-min", "0.25",
            "--t-max", "0.5", "--num-simulations", "16384", "--steps", "20",
            "--engine", "xla"])
        out = run(args)
        P = out["grid"]  # (nt, nk)
        oracle = crr_american(100.0, 110.0, 0.5, 0.05, 0.2, cp=-1.0,
                              n_steps=1024)
        assert abs(P[-1, -1] / oracle - 1.0) < 0.02

    def test_dividend_flag(self):
        from options_model_tpu.apps.price_surface import parse_args, run
        args_q = parse_args([
            "--style", "european", "--model", "heston", "--option-type",
            "call", "--nk", "4", "--nt", "2", "--q", "0.05"])
        args_0 = parse_args([
            "--style", "european", "--model", "heston", "--option-type",
            "call", "--nk", "4", "--nt", "2"])
        pq = run(args_q)["grid"]
        p0 = run(args_0)["grid"]
        # dividend lowers call prices (deep-OTM cells sit at the COS
        # truncation floor ~1e-5 where the ordering is noise)
        assert (pq <= p0 + 1e-4).all()
        assert (pq < p0)[p0 > 0.01].all()


class TestPlotPaths:
    def test_cli_plot_paths_writes_png(self, tmp_path):
        """--plot-paths + --diagnostics-dir saves the v1.5 sample-path figure
        (options_model_v1.5.py:130-138)."""
        pytest.importorskip("matplotlib")
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", "bs", "--num-simulations", "4096",
            "--s0-start", "100", "--s0-end", "100", "--total-points", "1",
            "--intervals-per-day", "1", "--engine", "xla",
            "--option-type", "put", "--plot-paths",
            "--diagnostics-dir", str(tmp_path)])
        run(args)
        png = tmp_path / "sample_paths.png"
        assert png.exists() and png.stat().st_size > 10_000


class TestHestonParamsFlag:
    def test_explicit_params_flow(self):
        # Explicit LOW-vol params vs the hist-vol-seeded default (25% vol):
        # the priced values must differ materially, proving the flag's
        # parameters actually reach the pricer.
        base = ["--spot", "100", "--hist-vol", "0.25", "--K", "100",
                "--model", "heston", "--num-simulations", "8192",
                "--s0-start", "100", "--s0-end", "100", "--total-points", "1",
                "--intervals-per-day", "1", "--engine", "xla",
                "--option-type", "put"]
        out_lo = run(parse_args(base + ["--heston-params", "2.5", "0.01",
                                        "0.1", "-0.7", "0.01"]))
        out_def = run(parse_args(base))
        p_lo = out_lo["heston"]["Option Value"].iloc[0]
        p_def = out_def["heston"]["Option Value"].iloc[0]
        assert np.isfinite(p_lo) and np.isfinite(p_def)
        assert p_lo < 0.7 * p_def  # 10% vol prices well below 25% vol

    def test_invalid_params_rejected(self):
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.25", "--model", "heston",
            "--heston-params", "2.5", "0.04", "0.3", "-2.0", "0.04",
            "--num-simulations", "2048", "--s0-start", "100",
            "--s0-end", "100", "--total-points", "1",
            "--intervals-per-day", "1", "--engine", "xla"])
        assert main_returns_error(args)


def main_returns_error(args):
    from options_model_tpu.apps.cli import run as _run
    try:
        _run(args)
        return False
    except ValueError:
        return True


class TestStreamlitGate:
    def test_import_without_streamlit_exits_cleanly(self):
        """The UI module is import-gated: without streamlit it raises
        SystemExit with a pointer to the CLI instead of a bare ImportError."""
        import importlib
        import sys
        sys.modules.pop("options_model_tpu.apps.streamlit_app", None)
        try:
            import streamlit  # noqa: F401
            pytest.skip("streamlit installed; gate not exercised")
        except ImportError:
            pass
        with pytest.raises(SystemExit, match="streamlit"):
            importlib.import_module("options_model_tpu.apps.streamlit_app")


class TestExoticCLI:
    def _run(self, argv):
        from options_model_tpu.apps.price_exotic import parse_args, run
        return run(parse_args(argv))

    def test_asian_sobol_matches_mc(self):
        base = ["asian", "--paths", "16384", "--steps", "16",
                "--t", "0.5", "--strike", "100"]
        out_q = self._run(base + ["--sampler", "sobol"])
        out_m = self._run(base + ["--sampler", "mc"])
        tol = 4.0 * (out_q["stderr"] ** 2 + out_m["stderr"] ** 2) ** 0.5
        assert abs(out_q["price"] - out_m["price"]) < max(tol, 5e-3)
        assert out_q["stderr"] < out_m["stderr"]

    def test_barrier_continuity_hits_reiner_rubinstein(self):
        from options_model_tpu.pricers.barrier import barrier_price_rr
        out = self._run(["barrier", "--barrier", "120", "--barrier-type",
                         "up-out", "--continuity-correction",
                         "--paths", "32768", "--steps", "50"])
        rr = barrier_price_rr(100.0, 100.0, 0.5, 0.05, 0.2, 120.0,
                              "up-and-out", cp=1.0)
        assert abs(out["price"] - float(rr)) < 4.0 * out["stderr"] + 1e-3

    def test_lookback_runs(self):
        out = self._run(["lookback", "--paths", "8192", "--steps", "16"])
        assert out["price"] > 0.0 and np.isfinite(out["stderr"])

    def test_european_sobol_tight(self):
        from options_model_tpu.pricers import bs_price
        out = self._run(["european", "--paths", "16384"])
        ref = float(bs_price(100.0, 100.0, 0.5, 0.05, 0.2, 1.0))
        assert abs(out["price"] - ref) < max(4.0 * out["stderr"], 3e-3)

    def test_basket_cli_and_corr_flag(self):
        out = self._run(["basket", "--spots", "100", "95", "--sigmas",
                         "0.2", "0.3", "--rho", "0.4", "--paths", "16384"])
        assert out["price"] > 0.0
        out2 = self._run(["basket", "--spots", "100", "95", "--sigmas",
                          "0.2", "0.3", "--corr", "1", "0.4", "0.4", "1",
                          "--paths", "16384", "--seed", "2026"])
        assert abs(out2["price"] - out["price"]) < 6.0 * (
            out["stderr"] + out2["stderr"]) + 1e-3

    def test_american_basket_cli(self):
        out = self._run(["american-basket", "--spots", "100", "100",
                         "--sigmas", "0.2", "0.2", "--rho", "0.0",
                         "--q", "0.10", "--kind", "max", "--t", "3.0",
                         "--steps", "9", "--option-type", "call",
                         "--paths", "16384"])
        # Andersen-Broadie 13.902 cell at modest paths: within ~3%
        assert abs(out["price"] - 13.902) / 13.902 < 0.03

    def test_bad_corr_length_exits(self):
        with pytest.raises(SystemExit):
            self._run(["basket", "--spots", "100", "95", "--sigmas",
                       "0.2", "0.3", "--corr", "1", "0.4", "0.4"])

    @pytest.mark.slow
    def test_american_cli_with_cos_oracle(self):
        out = self._run(["american", "--model", "merton", "--option-type",
                         "put", "--paths", "16384", "--steps", "25",
                         "--merton", "0.2", "1.0", "-0.1", "0.15"])
        # Deterministic oracle columns present and consistent: the LSM price
        # sits near the matched-dates Bermudan, which lies below the
        # continuous-American limit.
        berm = out["cos_bermudan_matched_dates"]
        assert berm <= out["cos_american"] + 1e-9
        assert abs(out["price"] - berm) < max(0.02 * berm,
                                              4.0 * out["stderr"])

    def test_american_cli_no_oracle_for_heston(self):
        out = self._run(["american", "--model", "heston", "--option-type",
                         "put", "--paths", "16384", "--steps", "25"])
        assert "cos_bermudan_matched_dates" not in out
        assert out["price"] > 0

    def test_american_cli_sabr(self):
        # SABR American through the dispatcher (round 4): the (S, alpha)
        # LSM basis rides the variance-basis plumbing; anchored offline by
        # the fd_sabr ADI oracle in tests/test_sabr.py — here just the CLI
        # wiring and the early-exercise ordering vs the European contract.
        out = self._run(["american", "--model", "sabr", "--option-type",
                         "put", "--paths", "16384", "--steps", "25",
                         "--t", "0.5", "--sabr", "0.2", "1.0", "-0.4", "0.6"])
        eu = self._run(["european", "--model", "sabr", "--option-type",
                        "put", "--paths", "16384", "--steps", "25",
                        "--t", "0.5", "--sabr", "0.2", "1.0", "-0.4", "0.6"])
        assert out["price"] > 0 and out["stderr"] > 0
        # American put >= European put (up to MC noise on both legs)
        assert out["price"] >= eu["price"] - 4.0 * (out["stderr"]
                                                    + eu["stderr"])

    def test_american_cli_rbergomi(self):
        # rough-Bergomi through the dispatcher: (S, v) LSM on the hybrid
        # scheme (a documented Markovian-projection lower bound, validated
        # against the Cholesky-exact and H=1/2 ADI oracles in
        # tests/test_rbergomi.py) — here the CLI wiring + exercise ordering.
        args = ["--option-type", "put", "--paths", "16384", "--steps", "25",
                "--t", "0.5", "--rbergomi", "0.1", "1.5", "-0.7", "0.04"]
        out = self._run(["american", "--model", "rbergomi"] + args)
        eu = self._run(["european", "--model", "rbergomi"] + args)
        assert out["price"] > 0 and out["stderr"] > 0
        assert out["price"] >= eu["price"] - 4.0 * (out["stderr"]
                                                    + eu["stderr"])
        with pytest.raises(SystemExit):  # european/american-only family
            self._run(["asian", "--model", "rbergomi", "--paths", "8192"])

    def test_sabr_european_cli(self):
        out = self._run(["european", "--model", "sabr", "--paths", "32768",
                         "--steps", "32", "--t", "0.5"])
        # MC vs the reported Hagan closed form: 4 sigma + the O(nu^2 T)
        # approximation allowance (tests/test_sabr.py measures ~0.2%)
        ref = out["hagan_closed_form"]
        assert abs(out["price"] - ref) < 4.0 * out["stderr"] + 3e-3 * ref
        with pytest.raises(SystemExit):  # european-only family
            self._run(["asian", "--model", "sabr", "--paths", "8192"])

    def test_mlmc_sampler_cli(self):
        from options_model_tpu.pricers import bs_price
        out = self._run(["european", "--sampler", "mlmc", "--eps", "0.05",
                         "--t", "0.5"])
        ref = float(bs_price(100.0, 100.0, 0.5, 0.05, 0.2, 1.0))
        assert abs(out["price"] - ref) < 4.0 * out["stderr"] + 0.05
        assert out["levels"] >= 3
        with pytest.raises(SystemExit):  # jump couplings not implemented
            self._run(["european", "--sampler", "mlmc", "--model", "merton"])


class TestBatesCLI:
    """model='bates' reachable from the exotic pricer and the calibrate app."""

    def _run(self, argv):
        from options_model_tpu.apps.price_exotic import parse_args, run
        return run(parse_args(argv))

    @pytest.mark.slow
    def test_exotic_bates_asian_and_european(self):
        out = self._run(["asian", "--model", "bates", "--paths", "8192",
                         "--steps", "16"])
        assert out["price"] > 0.0 and np.isfinite(out["stderr"])
        # sobol falls back to mc for bates (logged), still prices
        out2 = self._run(["european", "--model", "bates", "--sampler",
                          "sobol", "--paths", "8192", "--steps", "16"])
        from options_model_tpu.calibration import bates_cos_price
        from options_model_tpu.core import BatesParams, HestonParams
        bp = BatesParams(heston=HestonParams(kappa=2.0, theta=0.04, xi=0.3,
                                             rho=-0.7, v0=0.04),
                         lam=0.3, mu_j=-0.1, sigma_j=0.15)
        cos = float(bates_cos_price(100.0, 100.0, 0.5, 0.05, bp, cp=1.0))
        assert abs(out2["price"] - cos) < 4.0 * out2["stderr"] + 0.05

    def test_exotic_bates_explicit_params(self):
        out = self._run(["barrier", "--model", "bates", "--bates", "2.0",
                         "0.04", "0.3", "-0.7", "0.04", "0.5", "-0.1",
                         "0.15", "--barrier", "80", "--barrier-type",
                         "down-out", "--paths", "8192", "--steps", "16"])
        assert out["price"] > 0.0

    @pytest.mark.slow
    def test_calibrate_cli_bates_test_mode(self):
        from options_model_tpu.apps.calibrate import parse_args, run
        summary = run(parse_args(["--test", "--model", "bates",
                                  "--methods", "L-BFGS-B"]))
        assert summary["error"] < 1e-3
        assert "lam" in summary["param_errors"]
        assert summary["param_errors"]["lam"] < 0.05

    def test_calibrate_cli_rbergomi_wiring(self, monkeypatch):
        """--model rbergomi routes to calibration/rbergomi.py with the CLI's
        rho/seed/budget knobs and reports recovery errors. The MC fit itself
        is exercised by tests/test_rbergomi_calibration.py (and on the GPU by
        the bench leg); here the full-budget engine is stubbed so the CLI
        wiring test stays CPU-fast."""
        import options_model_tpu.apps.calibrate as cal
        from options_model_tpu.core.config import RBergomiParams

        calls = {}

        def fake_surface(true, S0=100.0, rate=0.05, noise_std=0.0, seed=42):
            calls["true"] = true
            K = np.array([90.0, 100.0, 110.0])
            T = np.array([0.25, 1.0])
            return K, T, np.full((2, 3), 0.2)

        def fake_fit(K, T, iv, S0, rate, *, rho, seed, max_polish_evals):
            calls["rho"] = rho
            calls["evals"] = max_polish_evals
            p = RBergomiParams(H=0.12, eta=1.4, rho=rho, xi0=0.041)
            return p, {"error": 0.002, "fitted": {"H": p.H, "eta": p.eta,
                                                  "xi0": p.xi0}}

        import options_model_tpu.calibration.rbergomi as crb
        monkeypatch.setattr(crb, "create_synthetic_rbergomi_surface",
                            fake_surface)
        monkeypatch.setattr(crb, "calibrate_rbergomi_to_data", fake_fit)
        summary = cal.run(cal.parse_args(
            ["--test", "--model", "rbergomi", "--rho", "-0.6",
             "--polish-evals", "40"]))
        assert calls["rho"] == -0.6 and calls["evals"] == 40
        assert calls["true"].rho == -0.6
        assert summary["param_errors"]["H"] == pytest.approx(0.02)
        with pytest.raises(SystemExit, match="price-surface"):
            cal.run(cal.parse_args(["--test", "--model", "rbergomi",
                                    "--price-surface", "x.csv"]))

    @pytest.mark.slow
    def test_calibrate_cli_bates_price_surface(self, tmp_path):
        """Calibrate -> price: the fitted Bates dynamics drive the American
        surface workload (jump overlay composed with the (S, v) backward)."""
        from options_model_tpu.apps.calibrate import parse_args, run
        csv = str(tmp_path / "bates_surface.csv")
        summary = run(parse_args(["--test", "--model", "bates", "--methods",
                                  "L-BFGS-B", "--price-surface", csv,
                                  "--surface-size", "3", "4"]))
        import pandas as pd
        df = pd.read_csv(csv)
        assert len(df) == 12 and np.isfinite(df["price"]).all()
        # puts increase in strike at fixed maturity
        g = df[df["T"] == df["T"].min()].sort_values("K")["price"].to_numpy()
        assert (np.diff(g) > -1e-3).all()


class TestJumpFamilySweeps:
    """--model merton / --model bates in the main reference-parity CLI."""

    def _run(self, model, extra=()):
        from options_model_tpu.apps.cli import parse_args, run
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", model, "--num-simulations", "4096",
            "--s0-start", "95", "--s0-end", "105", "--s0-step", "5",
            "--total-points", "2", "--intervals-per-day", "1",
            "--engine", "xla", "--option-type", "put", *extra])
        return run(args)

    def test_merton_sweep(self):
        out = self._run("merton")
        df = out["merton"]
        assert len(df) == 6 and np.isfinite(df["Option Value"]).all()
        # put value decreasing in S0 at the far point
        far = df[df["Days to Expiry"] == df["Days to Expiry"].max()]
        v = far.sort_values("S0")["Option Value"].to_numpy()
        assert v[0] > v[-1]

    @pytest.mark.slow
    def test_bates_sweep_with_explicit_jump(self):
        out = self._run("bates", ("--bates-params", "0.5", "-0.12", "0.2",
                                  "--heston-params", "2.0", "0.04", "0.3",
                                  "-0.7", "0.04"))
        df = out["bates"]
        assert len(df) == 6 and np.isfinite(df["Option Value"]).all()
        assert "bs" not in out and "heston" not in out


class TestJumpBracketCLI:
    @pytest.mark.slow
    def test_cli_bracket_merton(self):
        from options_model_tpu.apps.cli import parse_args, run
        args = parse_args([
            "--spot", "100", "--hist-vol", "0.2", "--K", "100",
            "--model", "merton", "--num-simulations", "8192",
            "--s0-start", "100", "--s0-end", "100", "--s0-step", "1",
            "--total-points", "1", "--intervals-per-day", "1",
            "--engine", "xla", "--option-type", "put", "--bracket"])
        out = run(args)
        br = out["bracket_merton"]
        assert br["low"] <= br["high"] + 2 * (br["low_stderr"]
                                              + br["high_stderr"])
        assert np.isfinite(br["high"]) and br["high"] > 0
