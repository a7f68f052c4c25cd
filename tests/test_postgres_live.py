"""PostgreSQL integration tests over a REAL socket.

Two modes, same tests:
  * ``IVTPU_PG_TEST_DSN`` set (e.g. ``host=localhost dbname=test
    user=postgres password=pw``): runs against that live server, with
    psycopg2 if installed or the bundled pure-Python wire driver
    (pipeline/pgwire.py) otherwise.
  * no DSN (this image — no psycopg2, no pg8000, no server, nothing
    installable): runs against the in-process loopback mock server
    (tests/pg_mock_server.py) speaking the actual v3 byte protocol with
    SCRAM-SHA-256 auth, through the same PostgresStore + pgwire path a
    live deployment without psycopg2 would use. Nothing skips.

Exercises the full adapter surface: DDL on first write, upsert
overwrite semantics, CHECK-constraint enforcement (valid_ohlc —
reference candle_schema.py:41-48), streaming reads, and a small
end-to-end pipeline run through the PostgresStore.
"""

import os

import numpy as np
import pandas as pd
import pytest

pytestmark = pytest.mark.pg_live

_DSN = os.environ.get("IVTPU_PG_TEST_DSN")


def _live_params():
    parts = dict(kv.split("=", 1) for kv in _DSN.split())
    return dict(
        host=parts.get("host", "localhost"),
        database=parts.get("dbname", parts.get("database", "test")),
        user=parts.get("user", "postgres"),
        password=parts.get("password", ""),
        port=int(parts.get("port", 5432)),
    )


@pytest.fixture
def live_store():
    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.storage import PostgresStore
    server = None
    if _DSN:
        store = PostgresStore(**_live_params(), connect_test=True)
    else:
        from tests.pg_mock_server import MockPgServer
        server = MockPgServer(auth="scram-sha-256", user="ivtpu",
                              password="secret")
        store = PostgresStore(host="127.0.0.1", database="test",
                              user="ivtpu", password="secret",
                              port=server.port, connect_test=True)
        assert store._pgwire  # the pure-Python driver is the path under test
    tables = (st.TICKERS, st.INTERPOLATED, st.MINUTE_CANDLES,
              st.RECONSTRUCTED)
    for t in tables:
        store.drop(t)
    yield store
    for t in tables:
        store.drop(t)
    if server is not None:
        server.close()


def test_upsert_overwrites(live_store):
    from iv_engine.pipeline import storage as st
    df = pd.DataFrame({
        "symbol": ["a"], "timestamp": [pd.Timestamp("2023-01-01")],
        "open": [1.0], "high": [2.0], "low": [0.5], "close": [1.5],
        "volume": [3.0]})
    live_store.write(st.MINUTE_CANDLES, df,
                     upsert_keys=["symbol", "timestamp"])
    df2 = df.assign(close=9.0)  # high must still dominate? no: high=2<9
    df2["high"] = 10.0
    live_store.write(st.MINUTE_CANDLES, df2,
                     upsert_keys=["symbol", "timestamp"])
    out = live_store.read(st.MINUTE_CANDLES)
    assert len(out) == 1
    assert float(out["close"].iloc[0]) == 9.0


def test_check_constraint_rejects_bad_ohlc(live_store):
    from iv_engine.pipeline import storage as st
    bad = pd.DataFrame({
        "symbol": ["a"], "timestamp": [pd.Timestamp("2023-01-01")],
        "open": [1.0], "high": [0.1], "low": [0.5], "close": [1.5],
        "volume": [3.0]})  # high < low violates valid_ohlc
    with pytest.raises(Exception):
        live_store.write(st.MINUTE_CANDLES, bad,
                         upsert_keys=["symbol", "timestamp"])


@pytest.mark.slow
def test_read_iter_streams_chunks(live_store):
    from iv_engine.pipeline import storage as st
    n = 5000
    df = pd.DataFrame({
        "symbol": np.repeat(["a", "b"], n // 2),
        "timestamp": pd.date_range("2023-01-01", periods=n, freq="1min"),
        "open": 1.0, "high": 2.0, "low": 0.5, "close": 1.5, "volume": 1.0})
    live_store.write(st.MINUTE_CANDLES, df,
                     upsert_keys=["symbol", "timestamp"])
    chunks = list(live_store.read_iter(st.MINUTE_CANDLES, chunk_rows=1000))
    assert len(chunks) >= 5
    assert sum(len(c) for c in chunks) == n


@pytest.mark.slow
def test_pipeline_end_to_end_on_postgres(live_store, tmp_path):
    from iv_engine.config import get_config
    from iv_engine.pipeline import PipelineRunner
    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.sample_data import (
        generate_sample_tickers)

    cfg = get_config("testing")
    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    cfg.monitoring.log_dir = str(tmp_path / "logs")
    cfg.interpolation.min_data_points = 5
    live_store.write(st.TICKERS,
                     generate_sample_tickers(num_symbols=2, hours=6))
    runner = PipelineRunner(cfg, store=live_store)
    res = runner.run_all()
    assert res["task1"]["by_status"].get("completed") == 2
    assert live_store.count(st.RECONSTRUCTED) > 0


def test_operational_features(live_store):
    """User-level operational surface (reference
    user_optimized_connection.py): session tuning, permission probing,
    opportunistic CONCURRENTLY index creation, table census report."""
    from iv_engine.pipeline import storage as st

    conn = live_store._connect()
    try:
        applied = live_store.tune_session(conn)
        assert set(k for k, _ in live_store.SESSION_TUNING) == set(applied)
    finally:
        conn.close()

    perms = live_store.probe_permissions()
    assert set(perms) == {"create_table", "pg_stat_access",
                          "database_size"}
    assert perms["create_table"] in (True, False)

    df = pd.DataFrame({
        "symbol": ["a"], "timestamp": [pd.Timestamp("2023-01-01")],
        "open": [1.0], "high": [2.0], "low": [0.5], "close": [1.5],
        "volume": [3.0]})
    live_store.write(st.MINUTE_CANDLES, df,
                     upsert_keys=["symbol", "timestamp"])
    n_idx = live_store.create_indexes(st.MINUTE_CANDLES,
                                      concurrently=True)
    assert n_idx >= 1

    report = live_store.table_report()
    entry = next(e for e in report if e["table"] == st.MINUTE_CANDLES)
    assert entry["rows"] == 1
    assert "from" in entry and "2023-01-01" in entry["from"]


def test_table_report_skips_foreign_tables(live_store, monkeypatch):
    """A shared public schema may contain third-party tables with names
    _ident rejects (or without SELECT permission): the census skips
    them instead of aborting (regression: round-3 review)."""
    from iv_engine.pipeline import storage as st

    df = pd.DataFrame({
        "symbol": ["a"], "timestamp": [pd.Timestamp("2023-01-01")],
        "open": [1.0], "high": [2.0], "low": [0.5], "close": [1.5],
        "volume": [3.0]})
    live_store.write(st.MINUTE_CANDLES, df,
                     upsert_keys=["symbol", "timestamp"])
    real = live_store.tables()
    monkeypatch.setattr(live_store, "tables",
                        lambda: ["my-weird table", "no_such_table"] + real)
    report = live_store.table_report()
    names = [e["table"] for e in report]
    assert st.MINUTE_CANDLES in names
    assert "my-weird table" not in names and "no_such_table" not in names


def test_upsert_all_key_columns_do_nothing(live_store):
    """Every column an upsert key -> DO NOTHING (an empty DO UPDATE SET
    list is a syntax error; round-4 review). Uses a bespoke all-key
    table so NOT NULL columns of the pipeline tables don't interfere."""
    import pandas as pd

    with live_store._connect() as conn, conn.cursor() as cur:
        cur.execute('DROP TABLE IF EXISTS "allkeys"')
        cur.execute('CREATE TABLE "allkeys" ("symbol" VARCHAR(50), '
                    '"tag" BIGINT, '
                    'CONSTRAINT allkeys_uniq UNIQUE ("symbol", "tag"))')
        conn.commit()
    df = pd.DataFrame({"symbol": ["a", "b"], "tag": [1, 2]})
    n1 = live_store.write("allkeys", df, upsert_keys=["symbol", "tag"])
    n2 = live_store.write("allkeys", df, upsert_keys=["symbol", "tag"])
    assert n1 == 2 and n2 == 2  # no syntax error, idempotent
    assert live_store.count("allkeys") == 2
    live_store.drop("allkeys")
