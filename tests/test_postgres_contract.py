"""PostgresStore contract tests against a stub psycopg2.

No server or driver exists in this image (ROADMAP #2); the stub records
every SQL statement and parameter batch so the adapter's queries, upsert
clauses and DDL flow are verified end-to-end at the call boundary.
"""

import sys
import types

import pandas as pd
import pytest


class _Cursor:
    def __init__(self, conn):
        self.conn = conn

    def execute(self, sql, params=None):
        self.conn.executed.append((" ".join(sql.split()), params))

    def fetchall(self):
        return self.conn.fetch_rows

    def fetchone(self):
        return self.conn.fetch_rows[0]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Conn:
    def __init__(self, registry):
        self.executed = registry["executed"]
        self.fetch_rows = registry["fetch_rows"]
        self.committed = registry  # shares 'commits' counter

    def cursor(self):
        return _Cursor(self)

    def commit(self):
        self.committed["commits"] += 1

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture
def pg(monkeypatch):
    registry = {"executed": [], "fetch_rows": [], "commits": 0,
                "value_batches": []}

    fake = types.ModuleType("psycopg2")
    fake.connect = lambda **kw: _Conn(registry)
    extras = types.ModuleType("psycopg2.extras")

    def execute_values(cur, sql, rows, template=None, page_size=100):
        registry["executed"].append((" ".join(sql.split()), None))
        registry["value_batches"].append(list(rows))

    extras.execute_values = execute_values
    fake.extras = extras
    monkeypatch.setitem(sys.modules, "psycopg2", fake)
    monkeypatch.setitem(sys.modules, "psycopg2.extras", extras)
    return registry


def test_write_emits_upsert(pg):
    from iv_engine.pipeline.storage import PostgresStore
    store = PostgresStore("h", "db", "u", "p")
    df = pd.DataFrame({"symbol": ["a", "b"],
                       "timestamp": pd.date_range("2023-01-01", periods=2,
                                                  freq="1min"),
                       "open": [1.0, 2.0]})
    n = store.write("minute_candles", df,
                    upsert_keys=["symbol", "timestamp"])
    assert n == 2
    sql = pg["executed"][-1][0]
    assert 'INSERT INTO "minute_candles"' in sql
    assert 'ON CONFLICT ("symbol", "timestamp") DO UPDATE' in sql
    assert '"open" = EXCLUDED."open"' in sql
    assert '"symbol" = EXCLUDED' not in sql  # keys never updated
    assert len(pg["value_batches"][-1]) == 2


def test_write_applies_ddl_first(pg):
    """First write per table runs the pipeline DDL (reference lazy table
    creation, main.py:46-163); later writes skip it."""
    from iv_engine.pipeline.storage import PostgresStore
    store = PostgresStore("h", "db", "u", "p")
    df = pd.DataFrame({"symbol": ["a"],
                       "timestamp": [pd.Timestamp("2023-01-01")],
                       "open": [1.0]})
    store.write("minute_candles", df, upsert_keys=["symbol", "timestamp"])
    ddl = [sql for sql, _ in pg["executed"] if "CREATE TABLE" in sql]
    assert len(ddl) == 1 and "minute_candles" in ddl[0]
    assert "valid_ohlc" in ddl[0]
    store.write("minute_candles", df, upsert_keys=["symbol", "timestamp"])
    ddl = [sql for sql, _ in pg["executed"] if "CREATE TABLE" in sql]
    assert len(ddl) == 1  # not re-run


def test_identifiers_are_validated():
    from iv_engine.pipeline.storage import _ident
    assert _ident("minute_candles") == '"minute_candles"'
    with pytest.raises(ValueError):
        _ident("bad; DROP TABLE x")
    with pytest.raises(ValueError):
        _ident('evil"name')


def test_list_symbols_and_count(pg):
    from iv_engine.pipeline.storage import PostgresStore
    store = PostgresStore("h", "db", "u", "p")
    pg["fetch_rows"][:] = [("a",), ("b",)]
    assert store.list_symbols("trading_tickers") == ["a", "b"]
    assert 'SELECT DISTINCT symbol FROM "trading_tickers"' in \
        pg["executed"][-1][0]
    pg["fetch_rows"][:] = [(42,)]
    assert store.count("trading_tickers") == 42


def test_create_tables_runs_all_ddl(pg):
    from iv_engine.pipeline.storage import PostgresStore
    from iv_engine.pipeline.schema import create_tables
    store = PostgresStore("h", "db", "u", "p")
    stmts = create_tables(store)
    assert len(stmts) == 4
    executed = " ".join(sql for sql, _ in pg["executed"])
    for table in ("trading_tickers", "interpolated_trading_tickers",
                  "minute_candles", "reconstructed_candles"):
        assert f"CREATE TABLE IF NOT EXISTS {table}" in executed
    assert "valid_ohlc" in executed
    assert pg["commits"] >= 1


def test_drop_table(pg):
    from iv_engine.pipeline.storage import PostgresStore
    store = PostgresStore("h", "db", "u", "p")
    store.drop("minute_candles")
    assert 'DROP TABLE IF EXISTS "minute_candles"' in pg["executed"][-1][0]


def test_tune_session_failed_set_does_not_poison_rest():
    """One rejected SET must not abort the transaction and cascade
    failures onto the remaining settings (regression: round-3 review —
    psycopg2 non-autocommit connections abort the tx on first error).
    Each SET commits on success and rolls back on failure."""
    from iv_engine.pipeline.storage import PostgresStore

    class FakeCursor:
        def __init__(self, conn):
            self.conn = conn

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def execute(self, sql):
            if self.conn.aborted:
                raise RuntimeError("current transaction is aborted")
            if "enable_nestloop" in sql:
                self.conn.aborted = True   # tx now poisoned until rollback
                raise RuntimeError("permission denied")

    class FakeConn:
        autocommit = False

        def __init__(self):
            self.aborted = False
            self.commits = 0
            self.rollbacks = 0

        def cursor(self):
            return FakeCursor(self)

        def commit(self):
            self.commits += 1

        def rollback(self):
            self.aborted = False
            self.rollbacks += 1

    conn = FakeConn()
    store = PostgresStore.__new__(PostgresStore)  # no real connection
    applied = store.tune_session(conn)
    assert applied["enable_nestloop"] is False
    others = {k: v for k, v in applied.items() if k != "enable_nestloop"}
    assert all(others.values()), applied       # rest still applied
    assert conn.rollbacks >= 1 and conn.commits == len(others)
