"""End-to-end pipeline tests on the memory/parquet stores, with a pandas
oracle replicating the reference algorithms per symbol."""

import numpy as np
import pandas as pd
import pytest

from iv_engine.config import get_config
from iv_engine.pipeline import (
    MemoryStore,
    ParquetStore,
    PipelineRunner,
    RunManifest,
)
from iv_engine.pipeline import storage as st
from iv_engine.pipeline.sample_data import (
    generate_sample_candles,
    generate_sample_tickers,
)


@pytest.fixture
def cfg(tmp_path):
    c = get_config("testing")
    c.checkpoint.manifest_dir = str(tmp_path / "runs")
    c.storage.backend = "memory"
    c.monitoring.log_dir = str(tmp_path / "logs")
    c.processing.dtype = "float64"  # parity mode (CPU x64 suite)
    return c


def _reference_interpolation(symbol_df):
    """The reference Task-1 algorithm (core.py:16-81) with the
    is_interpolated defect fixed (intended semantics)."""
    sd = symbol_df.sort_values("date").reset_index(drop=True)
    timeline = pd.date_range(sd["date"].min(), sd["date"].max(), freq="1min")
    merged = pd.DataFrame({"date": timeline}).merge(sd, on="date", how="left")
    was_obs = merged["iv"].notna() | merged["symbol"].notna()
    for col in ("iv", "underlying_price", "time_to_maturity"):
        merged[col] = merged[col].interpolate(method="linear")
    for col in ("symbol", "strike", "callput", "interest_rate", "mark_price",
                "index_price", "volume", "quote_volume"):
        if col in merged.columns:
            merged[col] = merged[col].ffill()
    merged["is_interpolated"] = ~was_obs
    merged = merged.dropna(
        subset=["symbol", "iv", "underlying_price", "time_to_maturity"])
    return merged


def test_task1_matches_reference_algorithm(cfg):
    tickers = generate_sample_tickers(num_symbols=3, hours=12, drop_frac=0.2)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    cfg.interpolation.max_gap_hours = 0  # bridge all gaps, like the reference
    runner = PipelineRunner(cfg, store=store)
    summary = runner.run_task1()
    assert summary["by_status"].get("completed") == 3

    out = store.read(st.INTERPOLATED)
    for symbol, sub in tickers.groupby("symbol"):
        ref = _reference_interpolation(sub)
        got = out[out["symbol"] == symbol].sort_values("date")
        assert len(got) == len(ref), symbol
        for col in ("iv", "underlying_price", "time_to_maturity",
                    "mark_price", "index_price", "volume"):
            np.testing.assert_allclose(
                got[col].to_numpy(float), ref[col].to_numpy(float),
                atol=1e-6, err_msg=f"{symbol}:{col}")
        np.testing.assert_array_equal(
            got["is_interpolated"].to_numpy(), ref["is_interpolated"].to_numpy())


def test_task1_greeks_populated(cfg):
    tickers = generate_sample_tickers(num_symbols=2, hours=12)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    PipelineRunner(cfg, store=store).run_task1()
    out = store.read(st.INTERPOLATED)
    for g in ("delta", "gamma", "theta", "vega", "rho"):
        assert g in out.columns
        assert out[g].notna().all()
    # call deltas in (0,1), put deltas in (-1,0)
    calls = out[out["callput"] == "C"]
    puts = out[out["callput"] == "P"]
    assert ((calls["delta"] > 0) & (calls["delta"] < 1)).all()
    assert ((puts["delta"] > -1) & (puts["delta"] < 0)).all()


def test_task1_guardrails_skip(cfg):
    tickers = generate_sample_tickers(num_symbols=2, hours=12)
    # symbol with too few points
    few = tickers[tickers["symbol"] == tickers["symbol"].iloc[0]].head(3)
    few = few.assign(symbol="btc-few-1000-c")
    store = MemoryStore()
    store.write(st.TICKERS, pd.concat([tickers, few]))
    cfg.interpolation.min_data_points = 10
    runner = PipelineRunner(cfg, store=store)
    summary = runner.run_task1()
    assert summary["by_status"].get("skipped") == 1
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation",
                    summary["batch_id"])
    rec = m.records()["btc-few-1000-c"]
    assert rec.status == "skipped"
    assert "insufficient data points" in rec.error_message


@pytest.mark.slow
def test_full_pipeline_and_task2_parity(cfg):
    tickers = generate_sample_tickers(num_symbols=3, hours=10)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    res = runner.run_all()
    assert res["task1"]["by_status"].get("completed") == 3
    assert res["bridge"]["by_status"].get("completed") == 3
    assert res["task2"]["by_status"].get("completed") == 3

    minute = store.read(st.MINUTE_CANDLES)
    recon = store.read(st.RECONSTRUCTED)
    assert len(minute) and len(recon)

    # Task-2 parity vs the reference pandas groupby (core.py:70-89)
    for symbol, sub in minute.groupby("symbol"):
        data = sub.sort_values("timestamp").copy()
        data["time_group"] = data["timestamp"].dt.floor("5min")
        agg = data.groupby("time_group").agg(
            open=("open", "first"), high=("high", "max"),
            low=("low", "min"), close=("close", "last"),
            volume=("volume", "sum"))
        counts = data.groupby("time_group").size()
        agg = agg[counts >= 5]
        got = recon[recon["symbol"] == symbol].sort_values("timestamp")
        assert len(got) == len(agg), symbol
        for col in ("open", "high", "low", "close", "volume"):
            np.testing.assert_allclose(
                got[col].to_numpy(float), agg[col].to_numpy(float),
                rtol=1e-6, err_msg=f"{symbol}:{col}")

    # bridge output respects OHLC invariants
    assert (minute["high"] >= minute["low"]).all()
    assert (minute["high"] >= minute[["open", "close"]].max(axis=1) - 1e-9).all()
    assert (minute["volume"] >= 0).all()


def test_resume_reprocesses_only_pending(cfg):
    tickers = generate_sample_tickers(num_symbols=3, hours=12)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    s1 = runner.run_task1()
    batch_id = s1["batch_id"]
    # simulate a crash: mark one symbol error
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", batch_id)
    victim = sorted(m.records())[0]
    m.error_symbol(victim, "simulated crash")
    assert m.pending_symbols() == [victim]
    s2 = runner.run_task1(resume_batch_id=batch_id)
    m2 = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", batch_id)
    assert m2.records()[victim].status == "completed"
    assert m2.is_done()


@pytest.mark.slow
def test_bridge_determinism(cfg):
    tickers = generate_sample_tickers(num_symbols=2, hours=8)
    results = []
    for _ in range(2):
        store = MemoryStore()
        store.write(st.TICKERS, tickers)
        cfg.interpolation.min_data_points = 5
        runner = PipelineRunner(cfg, store=store)
        runner.run_task1()
        runner.run_bridge()
        results.append(store.read(st.MINUTE_CANDLES)
                       .sort_values(["symbol", "timestamp"])
                       .reset_index(drop=True))
    pd.testing.assert_frame_equal(results[0], results[1])


_XPROC_BRIDGE_SCRIPT = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from iv_engine.config import get_config
from iv_engine.pipeline import PipelineRunner
from iv_engine.pipeline import storage as st
from iv_engine.pipeline.storage import ParquetStore
from iv_engine.pipeline.sample_data import generate_sample_tickers

out_dir = sys.argv[1]
cfg = get_config("testing")
cfg.checkpoint.manifest_dir = out_dir + "/runs"
cfg.monitoring.log_dir = out_dir + "/logs"
cfg.processing.dtype = "float64"
cfg.interpolation.min_data_points = 5
store = ParquetStore(out_dir + "/data")
store.write(st.TICKERS, generate_sample_tickers(num_symbols=2, hours=8))
r = PipelineRunner(cfg, store=store)
r.run_task1()
r.run_bridge()
"""


@pytest.mark.slow
def test_bridge_determinism_across_processes(tmp_path):
    """Two fresh interpreters with different PYTHONHASHSEED must write
    byte-identical candle tables — the bridge PRNG keys derive from a
    stable CRC32 fold, not salted hash() (ADVICE r1, high). This is the
    property --resume relies on: a resumed run (a new process) rewrites
    resumed symbols with the same draws as the original run."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "xproc_bridge.py"
    script.write_text(_XPROC_BRIDGE_SCRIPT)
    results = []
    for seed in ("1", "20771"):
        out_dir = tmp_path / f"run_{seed}"
        env = dict(os.environ)
        env["PYTHONHASHSEED"] = seed
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (repo, env.get("PYTHONPATH", "")) if p)
        proc = subprocess.run(
            [sys.executable, str(script), str(out_dir)],
            env=env, cwd=repo, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        from iv_engine.pipeline.storage import ParquetStore
        store = ParquetStore(str(out_dir / "data"))
        results.append(store.read(st.MINUTE_CANDLES)
                       .sort_values(["symbol", "timestamp"])
                       .reset_index(drop=True))
    pd.testing.assert_frame_equal(results[0], results[1])


def test_sample_candles_match_reference_shape():
    df = generate_sample_candles(num_symbols=5, hours=24)
    assert len(df) == 5 * 24 * 60
    assert set(df.columns) == {"symbol", "timestamp", "open", "high", "low",
                               "close", "volume"}
    assert (df["high"] >= df[["open", "close"]].max(axis=1)).all()
    assert (df["low"] <= df[["open", "close"]].min(axis=1)).all()
    assert df["symbol"].nunique() == 5


def test_status_census(cfg):
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(num_symbols=2, hours=6))
    runner = PipelineRunner(cfg, store=store)
    status = runner.status()
    assert status[st.TICKERS]["symbols"] == 2
    assert status[st.RECONSTRUCTED]["rows"] == 0


@pytest.mark.parametrize("store_cls", ["memory", "parquet"])
def test_storage_adapters(tmp_path, store_cls):
    store = (MemoryStore() if store_cls == "memory"
             else ParquetStore(str(tmp_path / "data")))
    df = pd.DataFrame({
        "symbol": ["a", "a", "b"],
        "timestamp": pd.date_range("2023-01-01", periods=3, freq="1min"),
        "open": [1.0, 2.0, 3.0],
    })
    assert store.write("t", df) == 3
    assert store.count("t") == 3
    assert store.list_symbols("t") == ["a", "b"]
    # upsert: overwrite one row, add one
    df2 = df.iloc[[0]].assign(open=9.0)
    df3 = pd.concat([df2, pd.DataFrame({
        "symbol": ["c"], "timestamp": [pd.Timestamp("2023-01-01")],
        "open": [5.0]})])
    store.write("t", df3, upsert_keys=["symbol", "timestamp"])
    out = store.read("t")
    # fast count may overcount across un-compacted upsert parts
    exact = (store.count("t", exact=True)
             if store_cls == "parquet" else store.count("t"))
    assert exact == 4
    assert len(out) == 4
    assert out[(out["symbol"] == "a")].sort_values("timestamp")["open"].iloc[0] == 9.0
    out_a = store.read("t", symbols=["a"])
    assert set(out_a["symbol"]) == {"a"}
    store.drop("t")
    assert store.count("t") == 0


def test_transient_failure_retried(cfg, monkeypatch):
    """max_retries is wired (the reference declared enable_auto_recovery/
    max_retries and never read them, SURVEY §5.3): a transient store
    failure must not mark symbols as errors."""
    tickers = generate_sample_tickers(num_symbols=2, hours=12)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    calls = {"n": 0}
    real_write = store.write

    def flaky_write(table, df, upsert_keys=None):
        if table == st.INTERPOLATED:
            calls["n"] += 1
            if calls["n"] == 1:
                raise IOError("simulated transient storage failure")
        return real_write(table, df, upsert_keys=upsert_keys)

    monkeypatch.setattr(store, "write", flaky_write)
    summary = runner.run_task1()
    assert summary["by_status"].get("completed") == 2
    assert calls["n"] == 2  # first attempt failed, retry succeeded


def test_persistent_failure_marks_errors(cfg, monkeypatch):
    tickers = generate_sample_tickers(num_symbols=2, hours=12)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    cfg.checkpoint.max_retries = 1
    runner = PipelineRunner(cfg, store=store)

    def always_fail(table, df, upsert_keys=None):
        raise IOError("permanent failure")

    monkeypatch.setattr(store, "write", always_fail)
    summary = runner.run_task1()
    assert summary["by_status"].get("error") == 2
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation",
                    summary["batch_id"])
    assert all("permanent failure" in r.error_message
               for r in m.records().values())


def test_manifest_flush_interval(tmp_path):
    m = RunManifest(str(tmp_path), "interpolation", 123, flush_interval=10)
    m.initialize_symbols([f"s{i}" for i in range(4)])
    # buffered: file not yet written
    import os
    assert not os.path.exists(m.path) or os.path.getsize(m.path) == 0
    m.flush()
    m2 = RunManifest(str(tmp_path), "interpolation", 123)
    assert len(m2.records()) == 4


@pytest.mark.parametrize("frequency,method", [
    ("1min", "linear"), ("5min", "linear"), ("1min", "cubic")])
@pytest.mark.slow
def test_fused_pipeline_matches_staged(cfg, frequency, method):
    """run_pipeline_fused must produce identical tables to staged run_all
    (deterministic bridge keys make the chain order-free) — including at
    a non-default interpolation frequency (ADVICE r1: the staged bridge
    used to unpack at hardcoded 1min spacing) and with method='cubic'
    (VERDICT r1 item 6: the fused path used to downgrade cubic to
    linear)."""
    if frequency != "1min":
        cfg.interpolation.frequency = frequency
        cfg.candle_reconstruction.source_frequency = frequency
        cfg.candle_reconstruction.target_frequency = "15min"
        cfg.candle_reconstruction.min_candles_required = 3
    cfg.interpolation.method = method
    # drop_frac varies per-symbol obs counts so cubic exercises the
    # obs-count sub-bucketing in both paths
    tickers = generate_sample_tickers(num_symbols=3, hours=10,
                                      drop_frac=0.2)

    stores = {}
    for mode in ("staged", "fused"):
        store = MemoryStore()
        store.write(st.TICKERS, tickers)
        cfg.interpolation.min_data_points = 5
        runner = PipelineRunner(cfg, store=store)
        if mode == "staged":
            res = runner.run_all()
        else:
            res = runner.run_pipeline_fused()
            assert res["fused"]
        assert res["task1"]["by_status"].get("completed") == 3
        assert res["task2"]["by_status"].get("completed") == 3
        stores[mode] = store

    for table in (st.INTERPOLATED, st.MINUTE_CANDLES, st.RECONSTRUCTED):
        a = (stores["staged"].read(table)
             .sort_values(["symbol"] + (["date"] if table == st.INTERPOLATED
                                        else ["timestamp"]))
             .reset_index(drop=True))
        b = (stores["fused"].read(table)
             .sort_values(["symbol"] + (["date"] if table == st.INTERPOLATED
                                        else ["timestamp"]))
             .reset_index(drop=True))
        drop = [c for c in ("batch_id", "created_at") if c in a.columns]
        # symbol may be categorical or string depending on how many
        # write batches the store concatenated — values must match
        a["symbol"] = a["symbol"].astype(str)
        b["symbol"] = b["symbol"].astype(str)
        pd.testing.assert_frame_equal(a.drop(columns=drop),
                                      b.drop(columns=drop))


@pytest.mark.slow
def test_price_priority_rule_live_and_paths_agree(cfg):
    """A symbol whose raw underlying_price coverage is below the 80%
    threshold must ride mark_price in BOTH the staged and fused bridge
    (reference ohlcv_converter.py:189-207). Round-4 review: the staged
    rule read the post-fill INTERPOLATED table, where underlying_price
    is populated on every stored row by construction (task 1 fills
    per-column NaNs and only stores finite-underlying rows), so the
    rule was dead — it always picked underlying_price and diverged
    from the fused pick. It now reads raw TICKERS coverage."""
    tickers = generate_sample_tickers(num_symbols=2, hours=10)
    syms = sorted(tickers["symbol"].unique())
    victim = syms[0]
    idx = tickers.index[tickers["symbol"] == victim]
    rng = np.random.default_rng(3)
    # keep ~40% coverage: enough to interpolate a valid grid, below 0.8
    drop = rng.choice(idx, size=int(len(idx) * 0.6), replace=False)
    tickers.loc[drop, "underlying_price"] = np.nan
    cfg.interpolation.min_data_points = 5

    stores = {}
    for mode in ("staged", "fused"):
        store = MemoryStore()
        store.write(st.TICKERS, tickers)
        runner = PipelineRunner(cfg, store=store)
        res = (runner.run_all() if mode == "staged"
               else runner.run_pipeline_fused())
        assert res["task1"]["by_status"].get("completed") == 2
        stores[mode] = store

    for table in (st.MINUTE_CANDLES, st.RECONSTRUCTED):
        a = (stores["staged"].read(table)
             .sort_values(["symbol", "timestamp"]).reset_index(drop=True))
        b = (stores["fused"].read(table)
             .sort_values(["symbol", "timestamp"]).reset_index(drop=True))
        drop_cols = [c for c in ("batch_id", "created_at") if c in a.columns]
        a["symbol"] = a["symbol"].astype(str)
        b["symbol"] = b["symbol"].astype(str)
        pd.testing.assert_frame_equal(a.drop(columns=drop_cols),
                                      b.drop(columns=drop_cols))

    # the victim's candles ride mark_price (~2% of underlying x iv), the
    # full-coverage symbol rides underlying — magnitudes separate by 10x+
    m = stores["staged"].read(st.MINUTE_CANDLES)
    m["symbol"] = m["symbol"].astype(str)
    vic = m[m["symbol"] == victim]["close"].median()
    oth = m[m["symbol"] == syms[1]]["close"].median()
    assert len(m) and vic < 0.1 * oth, (vic, oth)


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_quality_gate_isolates_single_symbol(cfg, mode):
    """One poisoned symbol in a bucket errors alone; the rest complete
    and their candles are written (VERDICT r1 item 4 — the reference
    isolated failures per symbol, batch_processor.py:132-142). The
    deterministic validation failure must not burn retries."""
    tickers = generate_sample_tickers(num_symbols=8, hours=6)
    syms = sorted(tickers["symbol"].unique())
    victim = syms[3]
    # a 1-minute alternating price series drives the spread-simulation
    # close recurrence negative -> candles are emitted but fail the
    # gate's positivity check (valid-but-bad, the gate's purpose)
    n = 30
    poison = pd.DataFrame({
        "symbol": victim,
        "date": pd.date_range("2023-03-20 09:00", periods=n, freq="1min"),
        "iv": 0.5,
        "underlying_price": np.where(np.arange(n) % 2 == 0, 100.0, 10.0),
        "time_to_maturity": 0.1,
        "strike": 24500.0,
        "callput": "c",
    })
    tickers = pd.concat(
        [tickers[tickers["symbol"] != victim], poison], ignore_index=True)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    if mode == "staged":
        res = runner.run_all()
    else:
        res = runner.run_pipeline_fused()
    assert res["task1"]["by_status"].get("completed") == 8
    assert res["bridge"]["by_status"].get("completed") == 7
    assert res["bridge"]["by_status"].get("error") == 1
    candles = store.read(st.MINUTE_CANDLES)
    assert victim not in set(candles["symbol"].unique())
    assert len(set(candles["symbol"].unique())) == 7
    m = RunManifest(cfg.checkpoint.manifest_dir, "bridge",
                    res["bridge"]["batch_id"])
    rec = m.records()[victim]
    assert rec.status == "error"
    assert "quality gate" in rec.error_message


@pytest.mark.slow
def test_task2_alternative_frequencies(cfg):
    """15-minute reconstruction matches the pandas oracle (the reference
    parameterised target_frequency but was only ever run at 5min)."""
    store = MemoryStore()
    store.write(st.MINUTE_CANDLES,
                generate_sample_candles(num_symbols=2, hours=6))
    cfg.candle_reconstruction.target_frequency = "15min"
    cfg.candle_reconstruction.min_candles_required = 15
    runner = PipelineRunner(cfg, store=store)
    summary = runner.run_task2()
    assert summary["by_status"].get("completed") == 2
    recon = store.read(st.RECONSTRUCTED)
    minute = store.read(st.MINUTE_CANDLES)
    for symbol, sub in minute.groupby("symbol"):
        data = sub.sort_values("timestamp").copy()
        data["g"] = data["timestamp"].dt.floor("15min")
        agg = data.groupby("g").agg(
            open=("open", "first"), high=("high", "max"),
            low=("low", "min"), close=("close", "last"),
            volume=("volume", "sum"))
        counts = data.groupby("g").size()
        agg = agg[counts >= 15]
        got = recon[recon["symbol"] == symbol].sort_values("timestamp")
        assert len(got) == len(agg)
        np.testing.assert_allclose(got["volume"].to_numpy(float),
                                   agg["volume"].to_numpy(float), rtol=1e-6)
        assert (got["source_candles"] == 15).all()


@pytest.mark.slow
def test_task2_misaligned_t0_keeps_trailing_bucket(cfg):
    """A symbol whose first timestamp is not aligned to the target
    frequency must keep its trailing partial bucket when
    min_candles_required allows it (ADVICE r1, medium: the old segment
    grid was one slot short and silently dropped the tail)."""
    ts = pd.date_range("2023-03-20 00:14", periods=64, freq="1min")
    minute = pd.DataFrame({
        "symbol": "btc-test-opt",
        "timestamp": ts,
        "open": 100.0, "high": 101.0, "low": 99.0, "close": 100.5,
        "volume": 1.0,
    })
    store = MemoryStore()
    store.write(st.MINUTE_CANDLES, minute)
    cfg.candle_reconstruction.target_frequency = "15min"
    cfg.candle_reconstruction.min_candles_required = 1
    runner = PipelineRunner(cfg, store=store)
    summary = runner.run_task2()
    assert summary["by_status"].get("completed") == 1
    recon = store.read(st.RECONSTRUCTED).sort_values("timestamp")
    data = minute.copy()
    data["g"] = data["timestamp"].dt.floor("15min")
    oracle = data.groupby("g").agg(volume=("volume", "sum"))
    assert len(recon) == len(oracle)
    np.testing.assert_allclose(recon["volume"].to_numpy(float),
                               oracle["volume"].to_numpy(float))


def test_duplicate_ticker_rows_keep_last(cfg):
    """(symbol, date) duplicates keep the last observation — the
    reference's left-merge would have duplicated timeline rows
    (SURVEY §2 note)."""
    t = generate_sample_tickers(num_symbols=1, hours=12)
    dup = t.iloc[[3]].assign(iv=9.99)
    store = MemoryStore()
    store.write(st.TICKERS, pd.concat([t, dup], ignore_index=True))
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    runner.run_task1()
    out = store.read(st.INTERPOLATED)
    row = out[out["date"] == t["date"].iloc[3]]
    assert len(row) == 1
    np.testing.assert_allclose(row["iv"].iloc[0], 9.99)


def test_empty_tickers_summary(cfg):
    runner = PipelineRunner(cfg, store=MemoryStore())
    s = runner.run_task1()
    assert s["total_symbols"] == 0
    s = runner.run_pipeline_fused()
    assert s["task1"]["total_symbols"] == 0


def test_graceful_stop_leaves_resumable_manifest(cfg, monkeypatch):
    """request_stop between buckets: processed symbols complete, the rest
    stay pending, and --resume finishes them."""
    # force multiple small batches
    cfg.processing.batch_size = 16
    tickers = generate_sample_tickers(num_symbols=40, hours=8)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)

    orig = runner._attempt
    calls = {"n": 0}

    def stopping_attempt(label, fn):
        calls["n"] += 1
        if calls["n"] == 1:
            runner.request_stop()  # stop after the FIRST bucket
        return orig(label, fn)

    monkeypatch.setattr(runner, "_attempt", stopping_attempt)
    s1 = runner.run_task1()
    done = s1["by_status"].get("completed", 0)
    pending = s1["by_status"].get("pending", 0)
    assert done >= 16 and pending > 0 and done + pending == 40

    runner2 = PipelineRunner(cfg, store=store)
    s2 = runner2.run_task1(resume_batch_id=s1["batch_id"])
    assert s2["by_status"].get("completed") == 40


def test_fused_skips_and_resume(cfg, monkeypatch):
    tickers = generate_sample_tickers(num_symbols=4, hours=10)
    few = tickers[tickers["symbol"] == tickers["symbol"].iloc[0]].head(3)
    few = few.assign(symbol="btc-tiny-1-c")
    store = MemoryStore()
    store.write(st.TICKERS, pd.concat([tickers, few]))
    cfg.interpolation.min_data_points = 10
    runner = PipelineRunner(cfg, store=store)
    s = runner.run_pipeline_fused()
    assert s["task1"]["by_status"].get("skipped") == 1
    assert s["task2"]["by_status"].get("skipped") == 1
    assert s["task1"]["by_status"].get("completed") == 4
    # resume with everything done -> nothing pending, summary intact
    s2 = runner.run_pipeline_fused(
        resume_batch_id=s["task1"]["batch_id"])
    total = sum(s2["task1"]["by_status"].values())
    assert s2["task1"]["by_status"].get("pending", 0) == 0
    assert total == 5


@pytest.mark.slow
def test_task1_cubic_matches_pandas(cfg):
    """method='cubic': pipeline output matches the reference algorithm
    with pandas Series.interpolate(method='cubic')."""
    tickers = generate_sample_tickers(num_symbols=3, hours=12)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    cfg.interpolation.method = "cubic"
    cfg.interpolation.max_gap_hours = 0
    runner = PipelineRunner(cfg, store=store)
    summary = runner.run_task1()
    assert summary["by_status"].get("completed") == 3
    out = store.read(st.INTERPOLATED)
    for symbol, sub in tickers.groupby("symbol"):
        sd = sub.sort_values("date").reset_index(drop=True)
        timeline = pd.date_range(sd["date"].min(), sd["date"].max(),
                                 freq="1min")
        merged = pd.DataFrame({"date": timeline}).merge(sd, on="date",
                                                        how="left")
        got = out[out["symbol"] == symbol].sort_values("date")
        for col in ("iv", "underlying_price", "time_to_maturity"):
            expected = merged[col].interpolate(method="cubic").to_numpy()
            np.testing.assert_allclose(
                got[col].to_numpy(float), expected, atol=1e-6,
                err_msg=f"{symbol}:{col}")


def test_task1_cubic_nan_at_obs_falls_back(cfg, caplog):
    tickers = generate_sample_tickers(num_symbols=2, hours=12)
    tickers.loc[tickers.index[3], "iv"] = np.nan  # NaN at an observation
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    cfg.interpolation.method = "cubic"
    runner = PipelineRunner(cfg, store=store)
    summary = runner.run_task1()
    assert summary["by_status"].get("completed") == 2  # linear fallback ran


def test_split_by_obs_count_repads_to_shape_schedule(cfg):
    """Cubic sub-batches re-pad to ingest.batch_pad sizes so each distinct
    obs-count group hits the same compiled shape as regular batches."""
    from iv_engine.pipeline.runner import _split_by_obs_count
    from iv_engine.pipeline import ingest

    B, C, L = 24, 8, 32
    n_obs = np.zeros(B, np.int64)
    n_obs[:20] = 7
    n_obs[20:23] = 5  # 3 rows of a second obs count
    obs_mask = np.zeros((B, L), bool)
    for i in range(23):
        obs_mask[i, : n_obs[i]] = True
    batch = ingest.PackedBatch(
        bucket_len=L, symbols=[f"s{i}" for i in range(23)],
        t0_minutes=np.zeros(B, np.int64), valid_len=np.full(B, L, np.int64),
        values=np.zeros((B, C, L), np.float32), obs_mask=obs_mask,
        timeline_mask=np.ones((B, L), bool), n_obs=n_obs,
        const_cols={"strike": [1.0] * 23 + [None]},
    )
    subs = _split_by_obs_count(batch, max_batch=256)
    assert sorted(s.values.shape[0] for s in subs) == [16, 32]
    for s in subs:
        B_pad = s.values.shape[0]
        assert s.obs_mask.shape[0] == B_pad
        assert len(s.const_cols["strike"]) == B_pad
        pad_rows = B_pad - len(s.symbols)
        if pad_rows:
            assert not s.obs_mask[len(s.symbols):].any()
            assert np.isnan(s.values[len(s.symbols):]).all()


def test_chunked_reads_bound_each_read_and_match_unchunked(cfg):
    """read_chunk_symbols bounds every storage read to a symbol group
    (VERDICT r1 item 8: whole-table reads are a host-RAM cliff at
    32M+-row scale) without changing any output table."""
    class CountingStore(MemoryStore):
        def __init__(self):
            super().__init__()
            self.read_sizes = []

        def read(self, table, symbols=None, columns=None):
            if symbols is not None:
                self.read_sizes.append(len(symbols))
            return super().read(table, symbols=symbols, columns=columns)

    tickers = generate_sample_tickers(num_symbols=5, hours=6)
    results = {}
    for chunk in (0, 2):
        store = CountingStore()
        store.write(st.TICKERS, tickers)
        cfg.interpolation.min_data_points = 5
        cfg.processing.read_chunk_symbols = chunk
        runner = PipelineRunner(cfg, store=store)
        res = runner.run_pipeline_fused()
        assert res["task1"]["by_status"].get("completed") == 5
        if chunk:
            assert max(store.read_sizes) <= chunk
        results[chunk] = store.read(st.RECONSTRUCTED).sort_values(
            ["symbol", "timestamp"]).reset_index(drop=True)
    for df in results.values():
        df["symbol"] = df["symbol"].astype(str)
    pd.testing.assert_frame_equal(results[0].drop(columns=["created_at"]),
                                  results[2].drop(columns=["created_at"]))


def test_compact_pack_matches_dense_and_device_scatter():
    """Compact packing (device-side grid scatter) must reproduce the
    dense host layout exactly, both via densify() and via
    tasks.scatter_batch."""
    from iv_engine.pipeline.ingest import pack_symbols
    from iv_engine.pipeline import tasks

    df = generate_sample_tickers(num_symbols=4, hours=12, drop_frac=0.2)
    dense = pack_symbols(df, (2048,), min_points=2, compact=False).batches[0]
    comp = pack_symbols(df, (2048,), min_points=2, compact=True).batches[0]
    values, obs_mask, timeline_mask = tasks.scatter_batch(
        comp.obs_vals, comp.obs_row, comp.obs_pos, comp.valid_len,
        B=comp.batch_padded, C=len(comp.columns), L=comp.bucket_len)
    np.testing.assert_array_equal(np.asarray(obs_mask), dense.obs_mask)
    np.testing.assert_array_equal(np.asarray(timeline_mask),
                                  dense.timeline_mask)
    np.testing.assert_allclose(np.asarray(values), dense.values,
                               equal_nan=True)
    comp.densify()
    np.testing.assert_array_equal(comp.obs_mask, dense.obs_mask)
    np.testing.assert_allclose(comp.values, dense.values, equal_nan=True)


def test_task1_date_window(cfg):
    """Date-window filter (reference batch_processor.py:28-51): only
    observations inside [start, end] feed the interpolation."""
    tickers = generate_sample_tickers(num_symbols=2, hours=24)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    s = runner.run_task1(start_date="2023-03-20 12:00",
                         end_date="2023-03-20 20:00")
    assert s["by_status"].get("completed") == 2
    out = store.read(st.INTERPOLATED)
    assert out["date"].min() >= pd.Timestamp("2023-03-20 12:00")
    assert out["date"].max() <= pd.Timestamp("2023-03-20 20:00")
    # 8h window of hourly obs -> 481 minutes per symbol
    assert len(out) == 2 * (8 * 60 + 1)


def test_bridge_batch_id_filter(cfg):
    """run_bridge(batch_id=...) converts only that task-1 batch's rows
    (reference get_interpolated_symbols batch filter)."""
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(num_symbols=2, hours=8))
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    s1 = runner.run_task1()
    res = runner.run_bridge(batch_id=s1["batch_id"] + 999)  # no such batch
    assert res["by_status"].get("completed", 0) == 0
    res = runner.run_bridge(batch_id=s1["batch_id"])
    assert res["by_status"].get("completed") == 2


def test_cubic_split_keys_on_grid_counts(cfg):
    """Round-3 review finding: _split_by_obs_count keyed on SOURCE n_obs
    while _obs_positions checks ON-GRID counts, so one symbol with an
    off-grid observation silently demoted its whole sub-batch (including
    aligned symbols) to the linear fallback. Split on grid counts and
    both sub-batches take the uniform cubic path."""
    from iv_engine.pipeline import ingest
    from iv_engine.pipeline.runner import (_obs_positions,
                                           _split_by_obs_count)

    base = pd.Timestamp("2023-03-20")
    rows = []
    for sym, offsets in (
            ("aligned", [0, 60, 120, 180, 240]),       # all on 1-min grid
            ("offgrid", [0, 60, 90, 120, 180, 240])):  # 90s falls off a
        #                                          5-min grid (freq below)
        for off in offsets:
            rows.append(dict(symbol=sym, date=base + pd.Timedelta(
                minutes=off), iv=0.5, underlying_price=100.0,
                time_to_maturity=0.1))
    df = pd.DataFrame(rows)
    packed = ingest.pack_symbols(df, [64], min_points=2,
                                 max_span_days=30,
                                 max_timeline_points=100_000,
                                 freq_minutes=60, compact=False)
    assert len(packed.batches) == 1
    subs = _split_by_obs_count(packed.batches[0])
    # BOTH symbols have 5 on-grid observations (offgrid's 90-min tick is
    # dropped from the grid), so they share ONE uniform sub-batch and
    # the cubic fast path applies to both — under the old n_obs split
    # the offgrid symbol landed in a k=6 sub-batch whose _obs_positions
    # check failed, demoting it to linear
    assert len(subs) == 1
    pos, clean = _obs_positions(subs[0])
    assert pos is not None and clean


def test_pack_symbols_dedupes_same_minute_rows(cfg):
    """Two DISTINCT timestamps inside one epoch minute must collapse to
    one observation: duplicate (row, pos) coordinates are undefined
    under the device scatter's unique_indices=True (round-3 review
    finding). The last row per minute wins, like the timestamp dedup."""
    from iv_engine.pipeline import ingest

    base = pd.Timestamp("2023-03-20")
    rows = []
    for sec, iv in ((10, 0.4), (50, 0.6)):   # same minute, two ticks
        rows.append(dict(symbol="s", date=base + pd.Timedelta(seconds=sec),
                         iv=iv, underlying_price=100.0,
                         time_to_maturity=0.1))
    rows.append(dict(symbol="s", date=base + pd.Timedelta(minutes=2),
                     iv=0.5, underlying_price=100.0,
                     time_to_maturity=0.1))
    packed = ingest.pack_symbols(pd.DataFrame(rows), [64], min_points=2,
                                 max_span_days=30,
                                 max_timeline_points=100_000,
                                 freq_minutes=1, compact=True)
    b = packed.batches[0]
    real = b.obs_row < len(b.symbols)
    coords = list(zip(b.obs_row[real].tolist(), b.obs_pos[real].tolist()))
    assert len(coords) == len(set(coords))   # unique scatter coordinates
    assert len(coords) == 2                  # minute collapsed to 1 obs
    iv_col = b.obs_vals[real][:, 0]
    assert iv_col[0] == np.float32(0.6)      # last tick of the minute won


@pytest.mark.parametrize("mode", ["staged", "fused"])
def test_pipeline_mesh_sharding_byte_identical(cfg, mode):
    """The pipeline wired to the device mesh (round-3 verdict item 2:
    processing.mesh_shape was decorative, the production path ran one
    chip) must produce BYTE-identical tables under mesh (1,) and
    mesh (8,) — per-row math, no collectives, so sharding the symbol
    dim is observationally free."""
    tickers = generate_sample_tickers(num_symbols=8, hours=6,
                                      drop_frac=0.1)
    stores = {}
    for shape in ((1,), (8,)):
        cfg.processing.mesh_shape = shape
        store = MemoryStore()
        store.write(st.TICKERS, tickers)
        cfg.interpolation.min_data_points = 5
        runner = PipelineRunner(cfg, store=store)
        # mesh really built (or really skipped) from the config knobs
        if shape == (1,):
            assert runner.mesh is None
        else:
            assert runner.mesh is not None
            assert dict(runner.mesh.shape) == {"data": 8}
        res = (runner.run_all() if mode == "staged"
               else runner.run_pipeline_fused())
        assert res["task1"]["by_status"].get("completed") == 8
        assert res["task2"]["by_status"].get("completed") == 8
        stores[shape] = store
    for table in (st.INTERPOLATED, st.MINUTE_CANDLES, st.RECONSTRUCTED):
        key = ["symbol"] + (["date"] if table == st.INTERPOLATED
                            else ["timestamp"])
        a, b = (stores[s].read(table).sort_values(key)
                .reset_index(drop=True) for s in ((1,), (8,)))
        drop = [c for c in ("batch_id", "created_at") if c in a.columns]
        a["symbol"] = a["symbol"].astype(str)
        b["symbol"] = b["symbol"].astype(str)
        pd.testing.assert_frame_equal(a.drop(columns=drop),
                                      b.drop(columns=drop))


def test_symbol_sharding_across_processes(cfg, tmp_path):
    """processing.shard_index/shard_count (CLI --shard I/N): two shard
    runs into ONE store produce exactly the unsharded run's tables, and
    each shard's manifest covers only its own partition — the
    reference's worker fan-out lifted to independent processes with
    storage upserts as the rendezvous (batch_processor.py:234-239).
    Ownership is hash-of-name (crc32 % n), NOT positional: positional
    slicing was neither idempotent under --resume nor stable when
    staged stages discover from a shared, still-growing table
    (round-4 review)."""
    from iv_engine.pipeline.runner import symbol_fold

    tickers = generate_sample_tickers(num_symbols=7, hours=6)
    cfg.interpolation.min_data_points = 5

    ref_store = MemoryStore()
    ref_store.write(st.TICKERS, tickers)
    PipelineRunner(cfg, store=ref_store).run_pipeline_fused()

    universe = sorted(tickers["symbol"].unique())
    expect = {i: sum(1 for s in universe if symbol_fold(s) % 2 == i)
              for i in (0, 1)}
    assert expect[0] + expect[1] == 7 and min(expect.values()) >= 1

    shared = MemoryStore()
    shared.write(st.TICKERS, tickers)
    owned = {}
    for i in (0, 1):
        cfg.processing.shard_index, cfg.processing.shard_count = i, 2
        cfg.checkpoint.manifest_dir = str(tmp_path / f"shard{i}")
        runner = PipelineRunner(cfg, store=shared)
        # hash ownership is idempotent: re-applying the partition (the
        # --resume path re-filters pending symbols) changes nothing
        part = runner._shard_symbols(universe)
        assert runner._shard_symbols(part) == part
        res = runner.run_pipeline_fused()
        owned[i] = res["task1"]["by_status"].get("completed", 0)
    assert owned == expect                    # disjoint, complete cover

    for table in (st.INTERPOLATED, st.MINUTE_CANDLES, st.RECONSTRUCTED):
        key = ["symbol"] + (["date"] if table == st.INTERPOLATED
                            else ["timestamp"])
        a = ref_store.read(table).sort_values(key).reset_index(drop=True)
        b = shared.read(table).sort_values(key).reset_index(drop=True)
        drop = [c for c in ("batch_id", "created_at") if c in a.columns]
        a["symbol"] = a["symbol"].astype(str)
        b["symbol"] = b["symbol"].astype(str)
        pd.testing.assert_frame_equal(a.drop(columns=drop),
                                      b.drop(columns=drop))


def test_run_all_scopes_downstream_stages(cfg):
    """A scoped run_all (limit / symbols / resume / dates) must bridge
    and reconstruct ONLY this run's symbols. Round-4 review: the CLI's
    default task silently dropped --resume, and a '--test' smoke run
    interpolated 3 symbols then bridged/reconstructed every symbol in
    the shared tables."""
    tickers = generate_sample_tickers(num_symbols=3, hours=6)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    runner.run_all()  # prior full run populates all shared tables

    res = runner.run_all(limit=1)
    assert res["task1"]["by_status"].get("completed") == 1
    # downstream stages touched 1 symbol, not the 3 already in storage
    assert res["bridge"]["by_status"].get("completed") == 1
    assert res["task2"]["by_status"].get("completed") == 1

    # resume flows through: error one symbol of the limited batch, then
    # run_all(resume) re-processes exactly it end-to-end
    bid = res["task1"]["batch_id"]
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", bid)
    victim = sorted(m.records())[0]
    m.error_symbol(victim, "simulated crash")
    m.flush()
    res2 = runner.run_all(resume_batch_id=bid)
    assert res2["task1"]["by_status"].get("completed") == 1
    assert res2["bridge"]["by_status"].get("completed") == 1


def test_monitor_wait_for_new_batch(cfg, tmp_path, capsys):
    """--with-monitor's side process waits for the run's manifest to
    appear instead of exiting on 'no manifests' or a previous finished
    batch (round-4 review)."""
    import threading
    import time as _t

    from iv_engine.monitoring.monitor import RealtimeMonitor

    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    mon = RealtimeMonitor(cfg, interval_s=0.05)

    def make_manifest():
        _t.sleep(0.2)
        m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", 99)
        m.initialize_symbols(["a"])
        m.complete_symbol("a", input_rows=5, output_rows=10,
                          processing_time=0.1)
        m.flush()

    t = threading.Thread(target=make_manifest)
    t.start()
    mon.run(wait_for_new=True, wait_s=5.0)
    t.join()
    out = capsys.readouterr().out
    assert "batch 99" in out and "batch complete" in out

    # and an empty dir gives up gracefully after the wait budget
    cfg.checkpoint.manifest_dir = str(tmp_path / "never")
    t0 = _t.time()
    RealtimeMonitor(cfg, interval_s=0.05).run(wait_for_new=True,
                                              wait_s=0.3)
    assert _t.time() - t0 >= 0.25
    assert "no run manifests" in capsys.readouterr().out


def test_shard_index_out_of_range_raises(cfg):
    """A config/env shard_index outside [0, shard_count) must raise, not
    wrap with % n — wrapping silently aliased another shard's partition
    (duplicate work, masked rollout misconfiguration; round-4 review).
    The CLI already validates; this covers the env/config path."""
    cfg.processing.shard_index, cfg.processing.shard_count = 2, 2
    runner = PipelineRunner(cfg, store=MemoryStore())
    with pytest.raises(ValueError, match="shard_index"):
        runner._shard_symbols(["AAA", "BBB"])


def test_resume_reprocesses_mid_processing_symbols(cfg):
    """A symbol caught mid-PROCESSING by a crash (flushed start_symbol,
    no completion) must re-run on --resume — excluding it silently
    dropped its output forever while is_done() stayed False (round-4
    review)."""
    tickers = generate_sample_tickers(num_symbols=2, hours=6)
    store = MemoryStore()
    store.write(st.TICKERS, tickers)
    cfg.interpolation.min_data_points = 5
    runner = PipelineRunner(cfg, store=store)
    s1 = runner.run_task1()
    bid = s1["batch_id"]
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", bid)
    victim = sorted(m.records())[0]
    m.start_symbol(victim, input_rows=5)   # crash signature
    m.flush()
    m2 = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", bid)
    assert m2.pending_symbols() == [victim]
    s2 = runner.run_task1(resume_batch_id=bid)
    m3 = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", bid)
    assert m3.records()[victim].status == "completed"
    assert m3.is_done()


def test_list_batches_skips_malformed_manifest(cfg, tmp_path):
    """One foreign-version manifest record (extra fields) must not
    abort --list-batches (round-4 review)."""
    d = str(tmp_path / "runs")
    m = RunManifest(d, "interpolation", 100)
    m.initialize_symbols(["a"])
    m.flush()
    with open(f"{d}/interpolation_101.jsonl", "w") as f:
        f.write('{"symbol": "x", "status": "pending", '
                '"mystery_field": 1}\n')
    out = RunManifest.list_batches(d, task="interpolation")
    assert [b["batch_id"] for b in out] == [100]
