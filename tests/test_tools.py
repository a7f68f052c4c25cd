"""Tests for the operator tooling: results checker, readiness validation,
monitor, CLI."""

import json

import numpy as np
import pandas as pd
import pytest

from iv_engine.config import get_config
from iv_engine.pipeline import MemoryStore, PipelineRunner
from iv_engine.pipeline import storage as st
from iv_engine.pipeline.check_results import (
    check_candle_results,
    check_interpolation_results,
    compare_minute_vs_reconstructed,
    quick_summary,
)
from iv_engine.pipeline.sample_data import generate_sample_tickers
from iv_engine.pipeline.validate import (
    estimate_processing,
    validate_readiness,
)


@pytest.fixture
def ran_store(tmp_path):
    cfg = get_config("testing")
    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    cfg.processing.dtype = "float64"
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(num_symbols=3, hours=8))
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    runner.run_all()
    return cfg, store


def test_check_interpolation_results(ran_store):
    _, store = ran_store
    rep = check_interpolation_results(store)
    assert rep["ok"]
    assert rep["output_rows"] > rep["source_rows"]
    assert 50 < rep["expansion_ratio"] < 70
    assert rep["interpolated_rows"] + rep["original_rows"] == rep["output_rows"]
    assert len(rep["top_symbols"]) == 3


def test_check_candle_results(ran_store):
    _, store = ran_store
    rep = check_candle_results(store)
    assert rep["ok"]
    assert rep["invalid_ohlc_rows"] == 0
    assert rep["negative_volume_rows"] == 0
    assert 4.5 < rep["compression_ratio"] < 5.5


def test_compare_minute_vs_reconstructed(ran_store):
    _, store = ran_store
    df = compare_minute_vs_reconstructed(store, n=8)
    assert len(df) == 8
    assert df["matches"].all()


def test_quick_summary(ran_store):
    _, store = ran_store
    s = quick_summary(store)
    assert s["pipeline_complete"]
    assert s[st.TICKERS]["symbols"] == 3


def test_validate_readiness_empty_store(tmp_path):
    cfg = get_config("testing")
    rep = validate_readiness(cfg, MemoryStore(), task="interpolation")
    assert not rep["ready"]
    assert not rep["checks"]["table_trading_tickers"]["ok"]


def test_validate_readiness_ready(ran_store):
    cfg, store = ran_store
    rep = validate_readiness(cfg, store, task="interpolation")
    assert rep["ready"]


def test_estimate_processing(ran_store):
    cfg, store = ran_store
    rep = estimate_processing(cfg, store)
    assert rep["input_rows"] > 0
    assert rep["measured_grid_points_per_s"] > 0
    assert rep["estimated_seconds"] >= 0


def test_monitor_render(ran_store, capsys):
    cfg, _ = ran_store
    from iv_engine.monitoring.monitor import RealtimeMonitor
    mon = RealtimeMonitor(cfg)
    mon.run(max_iterations=2)
    out = capsys.readouterr().out
    assert "batch" in out and "completed=" in out
    assert "batch complete" in out  # finished runs auto-exit


def test_monitor_throughput_and_eta(ran_store):
    """Throughput/ETA come from consecutive polls (reference
    performance_monitor.py:226-265): first poll primes, second reports;
    a stalled batch with pending symbols gets no ETA."""
    cfg, _ = ran_store
    from iv_engine.monitoring.monitor import RealtimeMonitor
    mon = RealtimeMonitor(cfg)
    s1 = {"task": "interpolation", "batch_id": 7,
          "by_status": {"completed": 10, "pending": 20},
          "output_rows": 100}
    assert mon.throughput(s1) == {}
    import time as _t
    _t.sleep(0.01)
    s2 = {"task": "interpolation", "batch_id": 7,
          "by_status": {"completed": 20, "pending": 10},
          "output_rows": 300}
    tp = mon.throughput(s2)
    assert tp["rows_per_sec"] > 0
    assert tp["symbols_per_min"] > 0
    # 10 done in dt, 10 remaining -> ETA ~ dt
    assert tp["eta_s"] is not None and tp["eta_s"] > 0
    _t.sleep(0.01)
    tp3 = mon.throughput(s2)  # no progress since last poll
    assert tp3["eta_s"] is None
    # the monitored batch changes (--task all: interpolation -> bridge):
    # a cross-batch delta would be negative garbage — first poll of the
    # new batch must prime instead (round-4 review)
    _t.sleep(0.01)
    s3 = {"task": "bridge", "batch_id": 9,
          "by_status": {"completed": 0, "pending": 30}, "output_rows": 0}
    assert mon.throughput(s3) == {}


def test_monitor_skips_stray_manifest_files(ran_store, tmp_path):
    """A stray .jsonl in the manifest dir (editor backup, notes) used to
    crash _latest_manifest with int('notes') (round-4 review)."""
    cfg, _ = ran_store
    from iv_engine.monitoring.monitor import RealtimeMonitor
    d = cfg.checkpoint.manifest_dir
    with open(f"{d}/notes.jsonl", "w") as f:
        f.write("scratch\n")
    with open(f"{d}/interpolation_12.bak.jsonl", "w") as f:
        f.write("{}\n")
    m = RealtimeMonitor(cfg)._latest_manifest()
    assert m is not None and isinstance(m.batch_id, int)


def test_monitor_alerts_persist_across_frames(ran_store, monkeypatch):
    """A persistent CRITICAL must render on EVERY frame — per-message
    dedup made it visible for exactly one repaint (round-4 review)."""
    cfg, _ = ran_store
    from iv_engine.monitoring import monitor as mon_mod
    monkeypatch.setattr(mon_mod, "host_memory_stats",
                        lambda: {"host_used_pct": 97.0})
    mon = mon_mod.RealtimeMonitor(cfg)
    m = mon._latest_manifest()
    first = mon.alerts(m)
    second = mon.alerts(m)
    assert any(lvl == "CRITICAL" for lvl, _ in first)
    assert first == second  # still visible on the next frame


def test_perf_logger_does_not_propagate(tmp_path):
    """Perf events are their own stream: they must not duplicate into
    the console/main-log handlers (round-4 review)."""
    import logging as _logging

    from iv_engine.monitoring import logging as mlog
    mlog.setup_logging(log_dir=str(tmp_path / "logs"))
    assert _logging.getLogger("iv_engine.performance").propagate is False


def test_host_system_census_survives_probe_failure(monkeypatch):
    """One unavailable psutil counter (common in containers) must not
    discard the whole census (round-4 review)."""
    import psutil

    from iv_engine.monitoring.metrics import host_system_census

    def boom():
        raise RuntimeError("no net counters in this container")

    monkeypatch.setattr(psutil, "net_io_counters", boom)
    c = host_system_census()
    assert c["net_sent_mb"] is None
    assert c["cpu_percent"] is not None
    assert c["process_rss_gb"] > 0


def test_host_system_census_shape():
    from iv_engine.monitoring.metrics import host_system_census
    c = host_system_census()
    assert "cpu_percent_per_core" in c
    assert "disk_used_pct" in c
    assert "net_recv_mb" in c
    assert c["process_rss_gb"] > 0


def test_cli_end_to_end(tmp_path, monkeypatch, capsys):
    from iv_engine import cli
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["--generate-sample-tickers", "--symbols", "2",
                   "--env", "development", "--json",
                   "--data-root", str(tmp_path / "data")])
    assert rc == 0
    rc = cli.main(["--task", "interpolation", "--env", "development",
                   "--json", "--data-root", str(tmp_path / "data")])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    payload = json.loads(out[-1])
    assert payload["task1"]["by_status"]["completed"] == 2
    rc = cli.main(["--list-batches", "--json",
                   "--data-root", str(tmp_path / "data")])
    assert rc == 0
    batches = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(batches) == 1


def test_cli_rejects_unknown_task():
    from iv_engine import cli
    with pytest.raises(SystemExit):
        cli.main(["--task", "nonsense"])


@pytest.mark.parametrize("method", ["svi", "essvi", "rbf", "ah"])
def test_surface_task_alternative_methods(ran_store, method):
    from iv_engine.pipeline.surface_task import run_surface_fit
    cfg, store = ran_store
    cfg.surface.smile_method = method
    cfg.surface.lm_max_iters = 40
    rep = run_surface_fit(cfg, store, method=method)
    # 3 sample symbols -> 1 usable chain at most; tolerate 0 if chain too
    # small, but the call must succeed and report its method
    assert rep.get("method", method) == method or rep["surfaces"] == 0


def test_surface_task_local_vol_columns(tmp_path):
    """surface.compute_local_vol persists Dupire local vol + density
    columns alongside the evaluated grid (real chain: 2 expiries x 6
    strikes of one underlying)."""
    import numpy as np
    from iv_engine.pipeline.surface_task import (SURFACES,
                                                 run_surface_fit)
    cfg = get_config("testing")
    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    cfg.interpolation.min_data_points = 5
    cfg.surface.compute_local_vol = True
    symbols = [f"btc-{exp}-{strike}-c"
               for exp in ("28apr23", "30jun23")
               for strike in (20000, 22000, 24000, 26000, 28000, 30000)]
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(hours=8,
                                                    symbols=symbols))
    runner = PipelineRunner(cfg, store=store)
    runner.run_task1()
    rep = run_surface_fit(cfg, store)
    assert rep["surfaces"] == 1
    df = store.read(SURFACES)
    assert "local_vol" in df.columns and "density" in df.columns
    assert np.isfinite(df["local_vol"]).all()
    assert np.isfinite(df["density"]).all()
    assert (df["local_vol"] >= 0).all()


def test_surface_task_parity_mode(tmp_path):
    """surface.compensated (CLI --parity) runs the double-f32 spline
    path and persists the df64 low limb: (total_variance,
    total_variance_lo) reconstructs the x64 value (models.spline)."""
    import numpy as np
    from iv_engine.pipeline.surface_task import (SURFACES,
                                                 run_surface_fit)
    cfg = get_config("testing")
    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    cfg.interpolation.min_data_points = 5
    cfg.surface.compensated = True
    symbols = [f"btc-{exp}-{strike}-c"
               for exp in ("28apr23", "30jun23")
               for strike in (20000, 22000, 24000, 26000, 28000, 30000)]
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(hours=8,
                                                    symbols=symbols))
    runner = PipelineRunner(cfg, store=store)
    runner.run_task1()
    rep = run_surface_fit(cfg, store)
    assert rep["surfaces"] == 1
    df = store.read(SURFACES)
    assert "total_variance_lo" in df.columns
    tv = df["total_variance"].to_numpy()
    lo = df["total_variance_lo"].to_numpy()
    assert np.isfinite(lo).all()
    # the low limb is a genuine sub-ulp correction: tiny vs hi, nonzero
    # somewhere, and the interpolating spline reprices quotes exactly
    assert (np.abs(lo) <= 1e-7 * np.maximum(np.abs(tv), 1e-6)).all()
    assert np.any(lo != 0.0)
    assert (df["fit_rmse"] == 0.0).all()
    # clamped BC has no compensated form — must fail loudly, not quietly
    # fall back to f32
    cfg.surface.spline_bc = "clamped"
    with pytest.raises(ValueError, match="compensated"):
        run_surface_fit(cfg, store)


def test_surface_task_ah_local_vol_columns(tmp_path):
    """method='ah' + compute_local_vol persists the model's OWN local
    vol (exact calibration product) and the log-moneyness
    Breeden-Litzenberger density (converted from the model's
    strike-space d2C/dK2 so the 'density' column means the same thing
    for every smile_method — round-3 advisor finding)."""
    import numpy as np
    from iv_engine.pipeline.surface_task import (SURFACES,
                                                 run_surface_fit)
    cfg = get_config("testing")
    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    cfg.interpolation.min_data_points = 5
    cfg.surface.smile_method = "ah"
    cfg.surface.compute_local_vol = True
    cfg.surface.ah_grid = 65      # light quick-tier shapes
    cfg.surface.ah_iters = 6
    symbols = [f"btc-{exp}-{strike}-c"
               for exp in ("28apr23", "30jun23")
               for strike in (20000, 22000, 24000, 26000, 28000, 30000)]
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(hours=8,
                                                    symbols=symbols))
    runner = PipelineRunner(cfg, store=store)
    runner.run_task1()
    rep = run_surface_fit(cfg, store)
    assert rep["surfaces"] == 1 and rep["method"] == "ah"
    df = store.read(SURFACES)
    assert "local_vol" in df.columns and "density" in df.columns
    assert np.isfinite(df["local_vol"]).all()
    assert (df["local_vol"] > 0).all()
    # AH guarantee: the persisted surface is arbitrage-free
    assert df["butterfly_ok"].all() and df["calendar_ok"].all()
    # density >= 0 up to the documented f32/f64 price tolerance
    assert df["density"].min() > -1e-10
    # the two boundary-condition grid columns carry no PDE row: they
    # persist NaN, never a fabricated zero density
    assert df["density"].isna().any()
    assert np.isfinite(df["density"]).sum() > 0


def test_parquet_parts_and_compaction(tmp_path):
    from iv_engine.pipeline import ParquetStore
    store = ParquetStore(str(tmp_path / "d"), compact_after=4)
    for i in range(3):
        df = pd.DataFrame({
            "symbol": ["a"], "timestamp": [pd.Timestamp("2023-01-01")
                                           + pd.Timedelta(minutes=i)],
            "open": [float(i)]})
        store.write("t", df, upsert_keys=["symbol", "timestamp"])
    assert len(store._parts("t")) == 3
    assert store.count("t") == 3
    # upsert an existing key -> still 3 logical rows, newest value wins
    store.write("t", pd.DataFrame({
        "symbol": ["a"], "timestamp": [pd.Timestamp("2023-01-01")],
        "open": [99.0]}), upsert_keys=["symbol", "timestamp"])
    # 4th part triggered compaction (explicitly enabled on this store)
    assert len(store._parts("t")) == 1
    out = store.read("t").sort_values("timestamp")
    assert len(out) == 3
    assert out["open"].iloc[0] == 99.0
    # fast count equals exact count after compaction
    assert store.count("t") == store.count("t", exact=True) == 3


def test_monitor_alerts_thresholds(ran_store):
    from iv_engine.monitoring.monitor import RealtimeMonitor
    from iv_engine.pipeline.manifest import RunManifest
    cfg, _ = ran_store
    cfg.monitoring.memory_warn_pct = 0.0   # any usage trips the warning
    cfg.monitoring.low_throughput_surfaces_s = 1e12  # everything is "slow"
    mon = RealtimeMonitor(cfg)
    batches = RunManifest.list_batches(cfg.checkpoint.manifest_dir,
                                       task="interpolation")
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation",
                    batches[0]["batch_id"])
    alerts = mon.alerts(m)
    levels = {lvl for lvl, _ in alerts}
    assert levels & {"WARNING", "CRITICAL"}
    # alerts reflect CURRENT state every frame (the dashboard repaints
    # the whole screen, so message-dedup would hide a persistent
    # condition after one frame — round-4 review)
    assert mon.alerts(m) == alerts


def test_surface_from_prices_when_iv_missing(rng):
    """Quotes with NaN iv but valid mark_price are recovered via BS
    inversion in build_chains."""
    import jax.numpy as jnp
    from iv_engine.ops.black_scholes import bs_price
    from iv_engine.pipeline.surface_task import build_chains

    S, T, r = 25000.0, 0.25, 0.03
    strikes = np.array([22000, 23000, 24000, 25000, 26000, 27000.0])
    true_iv = 0.5 + 0.1 * (np.log(strikes / S)) ** 2
    prices = np.asarray(bs_price(jnp.float64(S), jnp.array(strikes),
                                 jnp.float64(T), jnp.float64(r),
                                 jnp.array(true_iv), True))
    df = pd.DataFrame({
        "symbol": [f"btc-27mar23-{int(k)}-c" for k in strikes],
        "date": pd.Timestamp("2023-03-20"),
        "iv": np.nan,
        "underlying_price": S,
        "time_to_maturity": T,
        "mark_price": prices,
        "interest_rate": r,
    })
    chains = build_chains(df)
    assert len(chains) == 1
    np.testing.assert_allclose(np.sort(chains[0]["iv"]),
                               np.sort(true_iv), atol=1e-6)


def test_check_surface_results(ran_store):
    from iv_engine.pipeline.check_results import (
        check_surface_results)
    from iv_engine.pipeline.surface_task import run_surface_fit
    cfg, store = ran_store
    rep0 = check_surface_results(store)
    assert not rep0["ok"] and "no fitted surfaces" in rep0["reason"]
    run_surface_fit(cfg, store)
    rep = check_surface_results(store)
    if rep.get("surfaces", 0):  # chains may be too thin on tiny fixtures
        assert rep["ok"]
        assert rep["iv_range"][0] > 0


@pytest.mark.slow
def test_cli_sample_candles_to_task2_flow(tmp_path, monkeypatch, capsys):
    """Reference flow: generate sample 1-min candles, reconstruct 5-min
    (main.py --generate-sample-candles + --task candles, which was broken
    in the reference, SURVEY §2.1.1)."""
    from iv_engine import cli
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    assert cli.main(["--generate-sample-candles", "--symbols", "3",
                     "--env", "development", "--json",
                     "--data-root", root]) == 0
    assert cli.main(["--task", "candles", "--env", "development",
                     "--json", "--data-root", root]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    payload = json.loads(out[-1])
    assert payload["task2"]["by_status"]["completed"] == 3
    # 24h of 1-min bars -> 288 five-minute bars per symbol
    assert payload["status"]["reconstructed_candles"]["rows"] == 3 * 288


def test_cli_both_flow(tmp_path, monkeypatch, capsys):
    from iv_engine import cli
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    cli.main(["--generate-sample-tickers", "--symbols", "2",
              "--env", "development", "--json", "--data-root", root])
    cli.main(["--generate-sample-candles", "--symbols", "2",
              "--env", "development", "--json", "--data-root", root])
    assert cli.main(["--task", "both", "--env", "development", "--json",
                     "--data-root", root]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["task1"]["by_status"]["completed"] == 2
    assert payload["task2"]["by_status"]["completed"] == 2


@pytest.mark.slow
def test_large_run_confirmation(tmp_path, monkeypatch, capsys):
    """>100 symbols on a TTY prompts; 'n' aborts; --yes bypasses."""
    from iv_engine import cli
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    cli.main(["--generate-sample-tickers", "--symbols", "120",
              "--env", "development", "--json", "--data-root", root])
    monkeypatch.setattr("sys.stdin.isatty", lambda: True)
    monkeypatch.setattr("builtins.input", lambda *_: "n")
    cli.main(["--task", "interpolation", "--env", "development", "--json",
              "--data-root", root])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload.get("aborted")
    monkeypatch.setattr("builtins.input",
                        lambda *_: pytest.fail("--yes must skip prompt"))
    cli.main(["--task", "interpolation", "--yes", "--env", "development",
              "--json", "--data-root", root])
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["task1"]["by_status"]["completed"] == 120


@pytest.mark.slow
def test_with_monitor_side_process(tmp_path, monkeypatch, capsys):
    from iv_engine import cli
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    cli.main(["--generate-sample-tickers", "--symbols", "2",
              "--env", "development", "--json", "--data-root", root])
    rc = cli.main(["--task", "interpolation", "--with-monitor",
                   "--env", "development", "--json", "--data-root", root])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["task1"]["by_status"]["completed"] == 2


def test_cli_compact(tmp_path, monkeypatch, capsys):
    from iv_engine import cli
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    cli.main(["--generate-sample-tickers", "--symbols", "2",
              "--env", "development", "--json", "--data-root", root])
    cli.main(["--generate-sample-tickers", "--symbols", "2",
              "--env", "development", "--json", "--data-root", root])
    rc = cli.main(["--compact", "--json", "--data-root", root])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["trading_tickers"]["parts_after"] == 1


@pytest.mark.slow
def test_cli_surface_method_flag(tmp_path, monkeypatch, capsys):
    """--task surface --method essvi overrides config.smile_method."""
    from iv_engine import cli
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    assert cli.main(["--generate-sample-tickers", "--symbols", "12",
                     "--env", "development", "--json",
                     "--data-root", root]) == 0
    assert cli.main(["--task", "interpolation", "--env", "development",
                     "--json", "--data-root", root]) == 0
    rc = cli.main(["--task", "surface", "--method", "essvi",
                   "--env", "development", "--json", "--data-root", root])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    payload = json.loads(out[-1])
    assert payload["surface"]["method"] == "essvi"


def test_surface_task_rbf_penalized_batched(tmp_path):
    """method='rbf' with no-arb penalties on: the surface task fits the
    whole shape bucket as ONE batched penalized fit (no per-underlying
    Python loop), flags come back clean, and fit_rmse is persisted."""
    import numpy as np
    from iv_engine.pipeline.surface_task import (SURFACES,
                                                 run_surface_fit)
    cfg = get_config("testing")
    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    cfg.interpolation.min_data_points = 5
    cfg.surface.smile_method = "rbf"
    cfg.surface.rbf_smoothing = 1e-6
    cfg.surface.rbf_butterfly_penalty = 1000.0
    cfg.surface.rbf_calendar_penalty = 1000.0
    cfg.surface.rbf_penalty_iters = 12
    # two underlyings with the same chain shape -> one bucket, B=2
    symbols = [f"{und}-{exp}-{strike}-c"
               for und in ("btc", "eth")
               for exp in ("28apr23", "30jun23")
               for strike in (20000, 22000, 24000, 26000, 28000)]
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(hours=8,
                                                    symbols=symbols))
    runner = PipelineRunner(cfg, store=store)
    runner.run_task1()
    rep = run_surface_fit(cfg, store)
    assert rep["method"] == "rbf"
    assert rep["surfaces"] == 2
    df = store.read(SURFACES)
    assert set(df["underlying"]) == {"btc", "eth"}
    assert "fit_rmse" in df.columns
    assert np.isfinite(df["fit_rmse"]).all()
    assert df["butterfly_ok"].all()
    assert df["calendar_ok"].all()
    assert np.isfinite(df["total_variance"]).all()


def test_cli_init_env_and_check_db(tmp_path, capsys):
    """Setup-time operator conveniences (reference setup.py:104-232):
    --init-env writes a .env template; --check-db self-tests the
    configured storage backend."""
    import json as _json
    import os
    from iv_engine import cli

    rc = cli.main(["--init-env", "--data-root", str(tmp_path)])
    assert rc == 0
    env_path = tmp_path / ".env"
    assert env_path.exists()
    text = env_path.read_text()
    assert "IVTPU_STORAGE__BACKEND" in text and "ENVIRONMENT" in text
    # refuses to clobber
    assert cli.main(["--init-env", "--data-root", str(tmp_path)]) == 1

    capsys.readouterr()
    rc = cli.main(["--check-db", "--json", "--storage", "parquet",
                   "--data-root", str(tmp_path / "data")])
    assert rc == 0
    payload = _json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["ok"] and payload["backend"] == "parquet"


def test_surface_task_mesh_parity(tmp_path):
    """run_surface_fit under mesh (8,) pads the underlying batch to a
    mesh multiple with quote_mask-False rows and persists EXACTLY the
    table the unsharded fit produces (round 4: the surface task is the
    other production compute path wired to the pipeline mesh)."""
    import numpy as np
    from iv_engine.pipeline.surface_task import (SURFACES,
                                                 run_surface_fit)
    symbols = [f"{u}-{exp}-{strike}-c"
               for u in ("btc", "eth")
               for exp in ("28apr23", "30jun23")
               for strike in (20000, 22000, 24000, 26000, 28000)]
    tables = {}
    for shape in ((1,), (8,)):
        cfg = get_config("testing")
        cfg.checkpoint.manifest_dir = str(tmp_path / f"runs{shape[0]}")
        cfg.interpolation.min_data_points = 5
        cfg.processing.mesh_shape = shape
        store = MemoryStore()
        store.write(st.TICKERS, generate_sample_tickers(hours=8,
                                                        symbols=symbols))
        runner = PipelineRunner(cfg, store=store)
        runner.run_task1()
        rep = run_surface_fit(cfg, store)
        assert rep["surfaces"] == 2, rep
        tables[shape] = (store.read(SURFACES)
                         .sort_values(["underlying", "expiry_t",
                                       "log_moneyness"])
                         .reset_index(drop=True))
    a, b = tables[(1,)], tables[(8,)]
    pd.testing.assert_frame_equal(a, b)


def test_cli_shard_flag_validation(capsys):
    from iv_engine import cli
    assert cli.main(["--shard", "nonsense", "--json"]) == 2
    assert "I/N" in capsys.readouterr().err
    assert cli.main(["--shard", "4/4", "--json"]) == 2
    assert "out of range" in capsys.readouterr().err


def test_validate_readiness_survives_backend_outage(ran_store, monkeypatch):
    """A device init failure reports ready=False with the error instead
    of crashing the readiness check."""
    import jax

    from iv_engine.pipeline.validate import validate_readiness

    def boom():
        raise RuntimeError("UNAVAILABLE: device init failure")

    monkeypatch.setattr(jax, "devices", boom)
    cfg, store = ran_store
    rep = validate_readiness(cfg, store)
    assert rep["ready"] is False
    assert "UNAVAILABLE" in rep["checks"]["device"]["error"]


def test_compare_minute_vs_reconstructed_filters_frequency(ran_store):
    """Mixed-frequency reconstructed tables: the audit must select one
    frequency and size the source window from it — a hardcoded 5-min
    span compared 15-min rows against a third of their source candles
    (round-4 review)."""
    import pandas as pd

    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.check_results import (
        compare_minute_vs_reconstructed)

    cfg, store = ran_store
    minute = store.read(st.MINUTE_CANDLES)
    sym = str(minute["symbol"].iloc[0])
    sub = minute[minute["symbol"].astype(str) == sym].sort_values(
        "timestamp")
    # synthesize 15-min rows from the real 1-min data
    grp = sub.set_index("timestamp").resample("15min")
    recon15 = pd.DataFrame({
        "open": grp["open"].first(), "high": grp["high"].max(),
        "low": grp["low"].min(), "close": grp["close"].last(),
        "volume": grp["volume"].sum(),
    }).dropna().reset_index()
    recon15["symbol"] = sym
    recon15["frequency"] = "15min"
    store.write(st.RECONSTRUCTED, recon15,
                upsert_keys=["symbol", "timestamp", "frequency"])

    for freq in ("5min", "15min"):
        df = compare_minute_vs_reconstructed(store, symbol=sym, n=6,
                                             frequency=freq)
        full = df[df["src_count"] == int(freq[:-3])]
        assert len(full) > 0, freq
        assert full["matches"].all(), (freq, df)


def test_build_chains_dedupes_f32_colliding_strikes():
    """Two x64-distinct strikes whose f32 log-moneyness collide must
    collapse to one quote: the device solvers run f32, and a zero-width
    knot interval infs that surface silently (round-5 chip drive)."""
    from iv_engine.pipeline.surface_task import build_chains

    S = 25000.0
    # strikes at log-moneyness ~0.5 separated by 1e-9 in k: distinct in
    # x64, identical after the f32 round (ulp(0.5) = 6e-8)
    strikes = [22000.0, 23000.0, 24000.0,
               S * np.exp(0.5), S * np.exp(0.5 + 1e-9), 42000.0]
    df = pd.DataFrame({
        "symbol": [f"btc-27mar23-{k:.6f}-c" for k in strikes],
        "date": pd.Timestamp("2023-03-20"),
        "iv": 0.5,
        "underlying_price": S,
        "time_to_maturity": 0.25,
    })
    chains = build_chains(df)
    assert len(chains) == 1
    k32 = chains[0]["k"].astype(np.float32)
    assert (np.diff(k32) > 0).all(), k32
    assert len(k32) == 5


def test_cli_check_quick_emits_census_only(tmp_path, monkeypatch, capsys):
    """--check --quick prints ONE payload (the quick census) and skips
    the per-task audits (reference check_results.py --quick)."""
    from iv_engine import cli
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    assert cli.main(["--generate-sample-tickers", "--symbols", "1",
                     "--env", "development", "--json",
                     "--data-root", root]) == 0
    capsys.readouterr()
    assert cli.main(["--check", "--quick", "--json",
                     "--data-root", root]) == 0
    quick = capsys.readouterr().out.strip().splitlines()
    assert len(quick) == 1  # census only
    assert cli.main(["--check", "--json", "--data-root", root]) == 0
    full = capsys.readouterr().out.strip().splitlines()
    assert len(full) == 4  # census + task1 + task2 + surface audits


@pytest.mark.slow
def test_surface_task_ah_batch_cap(tmp_path, monkeypatch):
    """surface.ah_max_batch chunks AH fits (compile-wall guard, VERDICT
    r4 #7): a bucket bigger than the cap is
    fit in <=cap chunks whose persisted output matches the one-batch
    fit; other methods are untouched by the knob."""
    from iv_engine import models
    from iv_engine.pipeline.surface_task import (SURFACES,
                                                 run_surface_fit)
    cfg = get_config("testing")
    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    cfg.interpolation.min_data_points = 5
    cfg.surface.smile_method = "ah"
    cfg.surface.ah_grid = 33
    cfg.surface.ah_iters = 2
    symbols = [f"{und}-{exp}-{strike}-c"
               for und in ("btc", "eth", "sol")
               for exp in ("28apr23", "30jun23")
               for strike in (20000, 22000, 24000, 26000, 28000, 30000)]
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(hours=8,
                                                    symbols=symbols))
    PipelineRunner(cfg, store=store).run_task1()

    seen = []
    real_get = models.get

    def recording_get(name):
        m = real_get(name)

        def fit_eval(k, iv, T, quote_mask, scfg, dev):
            seen.append(int(k.shape[0]))
            return m.fit_eval(k, iv, T, quote_mask, scfg, dev=dev)

        return models.SurfaceModel(name=m.name, fit_eval=fit_eval,
                                   attach_local_vol=m.attach_local_vol)

    monkeypatch.setattr(models, "get", recording_get)

    def grid(df):
        return (df.sort_values(["underlying", "expiry_t", "log_moneyness"])
                .reset_index(drop=True))

    # NB: the recorder sees post-mesh-padding batches — each <=cap chunk
    # still pads up to the 8-virtual-device mesh multiple, so the cap
    # shows up as the NUMBER of fit calls, not their padded width.
    cfg.surface.ah_max_batch = 1
    rep = run_surface_fit(cfg, store)
    assert rep["surfaces"] == 3
    assert len(seen) == 3, f"cap not honoured: fit calls {seen}"
    chunked = grid(store.read(SURFACES))

    seen.clear()
    cfg.surface.ah_max_batch = None  # disabled -> whole bucket, one batch
    rep = run_surface_fit(cfg, store)
    assert rep["surfaces"] == 3
    assert len(seen) == 1
    pd.testing.assert_frame_equal(chunked, grid(store.read(SURFACES)))
