"""Storage adapters — the off-hot-path replacement for the reference's
PostgreSQL data plane.

The reference round-tripped every stage through Postgres tables
(``trading_tickers`` -> ``interpolated_trading_tickers`` ->
``minute_candles`` -> ``reconstructed_candles``; SURVEY.md §1) via three
DB-manager variants (src/database/connection.py, optimized_connection.py,
user_optimized_connection.py). Here storage is an edge concern: adapters
feed/drain pandas frames at pipeline boundaries while all stage-to-stage
handoff stays on device.

Adapters share one duck-typed interface:
  * ``list_symbols(table)``
  * ``read(table, symbols=None)`` -> DataFrame
  * ``write(table, df, upsert_keys=None)``  (upsert semantics mirror the
    reference's ON CONFLICT DO UPDATE inserts, ohlcv_converter.py:428-437)
  * ``count(table)``, ``tables()``, ``drop(table)``

Backends: in-memory (tests), Parquet datasets (default), and Postgres
(drop-in for reference deployments; gated on psycopg2 being installed).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

# canonical table names, matching the reference schema
TICKERS = "trading_tickers"
INTERPOLATED = "interpolated_trading_tickers"
MINUTE_CANDLES = "minute_candles"
RECONSTRUCTED = "reconstructed_candles"


def _upsert(existing: pd.DataFrame, incoming: pd.DataFrame,
            keys: List[str]) -> pd.DataFrame:
    """Last-write-wins upsert on key columns."""
    merged = pd.concat([existing, incoming], ignore_index=True)
    return merged.drop_duplicates(subset=keys, keep="last").reset_index(drop=True)


class MemoryStore:
    """Dict-of-DataFrames store (test fixture / ephemeral runs)."""

    def __init__(self):
        self._tables: Dict[str, pd.DataFrame] = {}

    def tables(self) -> List[str]:
        return sorted(self._tables)

    def list_symbols(self, table: str) -> List[str]:
        df = self._tables.get(table)
        if df is None or df.empty or "symbol" not in df.columns:
            return []
        return sorted(df["symbol"].unique().tolist())

    def read(self, table: str, symbols: Optional[List[str]] = None,
             columns: Optional[List[str]] = None) -> pd.DataFrame:
        df = self._tables.get(table, pd.DataFrame())
        if symbols is not None and not df.empty:
            df = df[df["symbol"].isin(symbols)]
        if columns is not None and not df.empty:
            df = df[[c for c in columns if c in df.columns]]
        return df.reset_index(drop=True).copy()

    def write(self, table: str, df: pd.DataFrame,
              upsert_keys: Optional[List[str]] = None) -> int:
        if df is None or df.empty:
            return 0
        if table in self._tables and upsert_keys:
            self._tables[table] = _upsert(self._tables[table], df, upsert_keys)
        elif table in self._tables:
            self._tables[table] = pd.concat(
                [self._tables[table], df], ignore_index=True)
        else:
            self._tables[table] = df.reset_index(drop=True).copy()
        return len(df)

    def count(self, table: str) -> int:
        return len(self._tables.get(table, ()))

    def drop(self, table: str) -> None:
        self._tables.pop(table, None)


class ParquetStore:
    """Append-only parquet dataset per table under ``root``.

    Each ``write`` lands a new ``part-<ns>-<pid>.parquet`` (O(batch),
    never a table rewrite — the reference's execute_values inserts had
    the same property, and the (timestamp, pid) name stays
    collision-free across concurrent --shard writer processes); upsert
    semantics are realised at *read* time by dropping
    duplicate keys keeping the newest part, with automatic background
    compaction once a table accumulates ``compact_after`` parts. A
    ``_meta.json`` sidecar remembers the table's upsert keys.
    """

    def __init__(self, root: str, compact_after: int = 0):
        """``compact_after > 0`` auto-compacts a table once it accumulates
        that many parts. Off by default: a mid-run compaction rewrites the
        whole table (measured ~minutes at 14M rows) while reads stay fast
        for dozens of parts; run ``compact()`` as maintenance instead."""
        self.root = root
        self.compact_after = compact_after
        os.makedirs(root, exist_ok=True)

    def _dir(self, table: str) -> str:
        return os.path.join(self.root, table)

    def _parts(self, table: str) -> List[str]:
        d = self._dir(table)
        if not os.path.isdir(d):
            return []
        return sorted(os.path.join(d, f) for f in os.listdir(d)
                      if f.endswith(".parquet"))

    def _keys(self, table: str) -> Optional[List[str]]:
        meta = os.path.join(self._dir(table), "_meta.json")
        if os.path.exists(meta):
            import json
            with open(meta) as f:
                return json.load(f).get("upsert_keys")
        return None

    def tables(self) -> List[str]:
        return sorted(
            t for t in os.listdir(self.root)
            if os.path.isdir(self._dir(t)) and self._parts(t)
        )

    def _read_raw(self, table: str, columns=None, filters=None) -> pd.DataFrame:
        parts = self._parts(table)
        if not parts:
            return pd.DataFrame()
        frames = [pd.read_parquet(p, columns=columns, filters=filters)
                  for p in parts]
        return pd.concat(frames, ignore_index=True)

    def list_symbols(self, table: str) -> List[str]:
        df = self._read_raw(table, columns=["symbol"])
        if df.empty:
            return []
        return sorted(df["symbol"].unique().tolist())

    def read(self, table: str, symbols: Optional[List[str]] = None,
             columns: Optional[List[str]] = None) -> pd.DataFrame:
        """``columns`` prunes at the parquet-reader level (never loads the
        other columns); upsert-key columns are read regardless so the
        dedup stays correct, then pruned from the result."""
        filters = [("symbol", "in", symbols)] if symbols is not None else None
        keys = self._keys(table)
        read_cols = columns
        if columns is not None and keys:
            read_cols = list(dict.fromkeys(list(columns) + keys))
        df = self._read_raw(table, columns=read_cols, filters=filters)
        if keys and not df.empty:
            df = df.drop_duplicates(subset=keys, keep="last")
        if columns is not None and not df.empty:
            df = df[[c for c in columns if c in df.columns]]
        return df.reset_index(drop=True)

    def write(self, table: str, df: pd.DataFrame,
              upsert_keys: Optional[List[str]] = None) -> int:
        if df is None or df.empty:
            return 0
        d = self._dir(table)
        os.makedirs(d, exist_ok=True)
        if upsert_keys:
            import json
            with open(os.path.join(d, "_meta.json"), "w") as f:
                json.dump({"upsert_keys": upsert_keys}, f)
        parts = self._parts(table)
        # part names are (timestamp_ns, pid)-unique, NOT a sequential
        # counter derived from listing the directory: concurrent --shard
        # processes sharing one store both computed the same next number
        # and the second os.replace silently clobbered the first shard's
        # rows (round-4 review). Lexicographic order still reflects
        # write order (zero-padded ns), which read-time upsert dedup
        # (keep='last') depends on; compact()'s "part-000000" output
        # sorts before every ns-named part, as it must.
        name = f"part-{time.time_ns():020d}-{os.getpid():07d}"
        tmp = os.path.join(d, f".{name}.tmp")
        df.to_parquet(tmp, index=False)
        os.replace(tmp, os.path.join(d, f"{name}.parquet"))
        if self.compact_after and len(parts) + 1 >= self.compact_after:
            self.compact(table)
        return len(df)

    def compact(self, table: str) -> None:
        """Merge all parts into one (applying upsert dedup).

        Crash-safe ordering: the compacted file is INSTALLED first,
        then the old parts are removed — the old order (remove, then
        replace) lost the whole table if the process died in between
        (round-4 review). "part-000000" sorts before every ns-named
        part, so during the brief overlap window read-time keep-last
        dedup still prefers the original parts (same values); only a
        keyless append table would transiently double rows mid-crash,
        and re-running compact() heals that too.
        """
        parts = self._parts(table)
        if len(parts) <= 1:
            return
        df = self.read(table)
        d = self._dir(table)
        tmp = os.path.join(d, f".compact-{os.getpid()}.tmp")
        df.to_parquet(tmp, index=False)
        target = os.path.join(d, "part-000000.parquet")
        os.replace(tmp, target)
        for p in parts:
            if p != target:
                os.remove(p)

    def count(self, table: str, exact: bool = False) -> int:
        """Row count from part metadata (fast). With upserted duplicates
        across parts this can overcount; pass ``exact=True`` to pay for
        the dedup'd read (the audits in check_results read full frames
        anyway, so the census paths keep the fast default)."""
        import pyarrow.parquet as pq
        parts = self._parts(table)
        if not parts:
            return 0
        if exact and len(parts) > 1 and self._keys(table):
            return len(self.read(table))
        return sum(pq.ParquetFile(p).metadata.num_rows for p in parts)

    def drop(self, table: str) -> None:
        d = self._dir(table)
        if os.path.isdir(d):
            for f in os.listdir(d):
                os.remove(os.path.join(d, f))
            os.rmdir(d)


def _ident(name: str) -> str:
    """Validate-and-quote a SQL identifier. Table/column names come from
    our own schema constants or DataFrame columns, but quoting costs
    nothing and closes the injection/reserved-word hole of naked
    f-string interpolation."""
    if not name or not all(c.isalnum() or c == "_" for c in name):
        raise ValueError(f"invalid SQL identifier: {name!r}")
    return f'"{name}"'


class PostgresStore:
    """Drop-in adapter for reference deployments (same tables/queries as
    src/database/connection.py). Uses psycopg2 when available and falls
    back to the bundled pure-Python wire driver
    (``pipeline.pgwire`` — startup/SCRAM auth, simple-query protocol,
    DECLARE/FETCH streaming) otherwise, so the adapter runs with zero
    native dependencies.

    * identifiers are validated and quoted (``_ident``);
    * the pipeline DDL (pipeline/schema.py — same constraints as the
      reference's SchemaManager) is applied on first write per table;
    * ``read_iter`` streams with a server-side named cursor (the
      reference's streaming reads, optimized_connection.py:113-129).
    """

    def __init__(self, host, database, user, password, port=5432,
                 connect_test: bool = False):
        try:
            import psycopg2  # noqa: F401 — prefer the C driver
            import psycopg2.extras
            self._connect_fn = lambda: psycopg2.connect(
                host=host, database=database, user=user,
                password=password, port=port)
            self._execute_values = psycopg2.extras.execute_values
            self._pgwire = False
        except ImportError:
            from iv_engine.pipeline import pgwire
            self._connect_fn = lambda: pgwire.connect(
                host=host, database=database, user=user,
                password=password, port=port)
            self._execute_values = pgwire.execute_values
            self._pgwire = True
        self._ensured: set = set()
        if connect_test:  # reference connection self-test (connection.py:18-27)
            with self._connect() as conn, conn.cursor() as cur:
                cur.execute("SELECT version()")
                cur.fetchone()

    def _connect(self):
        return self._connect_fn()

    def ensure_schema(self, table: str) -> None:
        """Idempotently apply the pipeline DDL for a known table."""
        if table in self._ensured:
            return
        from iv_engine.pipeline.schema import DDL
        ddl = DDL.get(table)
        if ddl is not None:
            with self._connect() as conn, conn.cursor() as cur:
                cur.execute(ddl)
                conn.commit()
        self._ensured.add(table)

    def tables(self) -> List[str]:
        q = ("SELECT tablename FROM pg_tables WHERE schemaname='public' "
             "ORDER BY tablename")
        with self._connect() as conn, conn.cursor() as cur:
            cur.execute(q)
            return [r[0] for r in cur.fetchall()]

    def list_symbols(self, table: str) -> List[str]:
        with self._connect() as conn, conn.cursor() as cur:
            cur.execute(f"SELECT DISTINCT symbol FROM {_ident(table)} "
                        f"ORDER BY symbol")
            return [r[0] for r in cur.fetchall()]

    def read(self, table: str, symbols: Optional[List[str]] = None,
             columns: Optional[List[str]] = None) -> pd.DataFrame:
        col_sql = (", ".join(_ident(c) for c in columns)
                   if columns else "*")
        q = f"SELECT {col_sql} FROM {_ident(table)}"
        params = None
        if symbols is not None:
            q += " WHERE symbol = ANY(%s)"
            params = (list(symbols),)
        with self._connect() as conn:
            if self._pgwire:
                with conn.cursor() as cur:
                    cur.execute(q, params)
                    cols = [d[0] for d in cur.description]
                    return pd.DataFrame(cur.fetchall(), columns=cols)
            return pd.read_sql(q, conn, params=params)

    def read_iter(self, table: str, symbols: Optional[List[str]] = None,
                  chunk_rows: int = 100_000):
        """Stream a table in chunks via a server-side named cursor, so a
        32M+-row table never materialises in host RAM at once."""
        q = f"SELECT * FROM {_ident(table)}"
        params = None
        if symbols is not None:
            q += " WHERE symbol = ANY(%s)"
            params = (list(symbols),)
        q += " ORDER BY symbol"
        with self._connect() as conn:
            with conn.cursor(name="ivtpu_stream") as cur:
                cur.itersize = chunk_rows
                cur.execute(q, params)
                cols = None
                while True:
                    rows = cur.fetchmany(chunk_rows)
                    if not rows:
                        break
                    if cols is None:
                        cols = [d[0] for d in cur.description]
                    yield pd.DataFrame(rows, columns=cols)

    def write(self, table: str, df: pd.DataFrame,
              upsert_keys: Optional[List[str]] = None) -> int:
        if df is None or df.empty:
            return 0
        self.ensure_schema(table)
        cols = list(df.columns)
        conflict = ""
        if upsert_keys:
            updates = ", ".join(
                f"{_ident(c)} = EXCLUDED.{_ident(c)}"
                for c in cols if c not in upsert_keys)
            keys = ", ".join(_ident(k) for k in upsert_keys)
            # every column a key -> empty SET list is a syntax error;
            # the correct idempotent upsert is DO NOTHING
            conflict = (f" ON CONFLICT ({keys}) DO UPDATE SET {updates}"
                        if updates else
                        f" ON CONFLICT ({keys}) DO NOTHING")
        col_list = ", ".join(_ident(c) for c in cols)
        q = (f"INSERT INTO {_ident(table)} ({col_list}) "
             f"VALUES %s{conflict}")
        # unwrap numpy scalars (np.float32/int64/bool_) and NaT to
        # Python natives: psycopg2 cannot adapt them ("can't adapt type
        # 'numpy.float32'") and the default processing dtype IS float32,
        # so every real-psycopg2 deployment hit it on the first INSERT
        # (round-4 review; the pure-Python pgwire fallback already
        # unwrapped via .item())
        rows = [tuple(None if v is pd.NaT
                      else v.item() if isinstance(v, np.generic) else v
                      for v in r)
                for r in df.itertuples(index=False)]
        with self._connect() as conn, conn.cursor() as cur:
            self._execute_values(cur, q, rows, page_size=1000)
            conn.commit()
        return len(rows)

    def count(self, table: str) -> int:
        with self._connect() as conn, conn.cursor() as cur:
            cur.execute(f"SELECT COUNT(*) FROM {_ident(table)}")
            return cur.fetchone()[0]

    def drop(self, table: str) -> None:
        with self._connect() as conn, conn.cursor() as cur:
            cur.execute(f"DROP TABLE IF EXISTS {_ident(table)}")
            conn.commit()
        self._ensured.discard(table)

    # -- operational features (reference user_optimized_connection.py) --

    #: session-level tuning for shared servers where postgresql.conf is
    #: out of reach (reference user_optimized_connection.py:65-97)
    SESSION_TUNING = (
        ("work_mem", "'128MB'"),
        ("maintenance_work_mem", "'256MB'"),
        ("effective_cache_size", "'4GB'"),
        ("random_page_cost", "1.1"),      # SSD cost model
        ("enable_nestloop", "off"),
    )

    def tune_session(self, conn) -> dict:
        """Apply conservative session-level SETs on ``conn`` (no server
        admin needed). Returns {setting: applied_bool} — settings a
        shared server rejects are reported, not fatal (reference
        user_optimized_connection.py:65-97 behavior)."""
        applied = {}
        for name, value in self.SESSION_TUNING:
            try:
                with conn.cursor() as cur:
                    cur.execute(f"SET {name} = {value}")
                # commit per SET: a session-level SET inside a
                # transaction is reverted on rollback, and one rejected
                # SET must not abort the tx and poison the rest
                if not getattr(conn, "autocommit", False):
                    conn.commit()
                applied[name] = True
            except Exception:
                try:
                    conn.rollback()
                except Exception:
                    pass
                applied[name] = False
        return applied

    def probe_permissions(self) -> dict:
        """Probe what this role may do on the server: index creation,
        statistics access, database-size introspection (reference
        permission probing, user_optimized_connection.py:178-222)."""
        out = {}
        with self._connect() as conn:
            def attempt(key, sql, cleanup=None):
                try:
                    with conn.cursor() as cur:
                        cur.execute(sql)
                        if cleanup:
                            cur.execute(cleanup)
                    conn.commit()
                    out[key] = True
                except Exception:
                    try:
                        conn.rollback()
                    except Exception:
                        pass
                    out[key] = False

            # IF NOT EXISTS keeps the probe idempotent: a prior probe
            # that crashed between create and drop would otherwise make
            # every later probe report create_table=False despite the
            # permission existing (and the leftover would never be
            # cleaned up) — round-3 advisor finding
            attempt("create_table",
                    'CREATE TABLE IF NOT EXISTS "ivtpu_probe" '
                    '("x" INTEGER)',
                    'DROP TABLE IF EXISTS "ivtpu_probe"')
            attempt("pg_stat_access",
                    "SELECT COUNT(*) FROM pg_stat_user_tables")
            attempt("database_size",
                    "SELECT pg_database_size(current_database())")
        return out

    def create_indexes(self, table: str, concurrently: bool = True) -> int:
        """Create the pipeline's indexes for ``table``, opportunistically
        CONCURRENTLY so production tables stay writable during the build
        (reference user_optimized_connection.py:224-265). Returns the
        number of index statements issued; permission errors on
        individual indexes are non-fatal."""
        from iv_engine.pipeline.schema import DDL
        ddl = DDL.get(table)
        if ddl is None:
            return 0
        stmts = [s.strip() for s in ddl.split(";")
                 if "CREATE INDEX" in s.upper()]
        issued = 0
        conn = self._connect()
        try:
            if concurrently and hasattr(conn, "autocommit"):
                conn.autocommit = True  # CONCURRENTLY refuses txn blocks
            for s in stmts:
                if concurrently:
                    s = s.replace("CREATE INDEX IF NOT EXISTS",
                                  "CREATE INDEX CONCURRENTLY IF NOT "
                                  "EXISTS")
                try:
                    with conn.cursor() as cur:
                        cur.execute(s)
                    if not getattr(conn, "autocommit", False):
                        conn.commit()
                    issued += 1
                except Exception:
                    try:
                        conn.rollback()
                    except Exception:
                        pass
        finally:
            conn.close()
        return issued

    def table_report(self) -> List[dict]:
        """Census of the pipeline tables: row counts plus the date range
        where a time column exists (reference table census report,
        user_optimized_connection.py:267-304)."""
        report = []
        with self._connect() as conn:
            for table in self.tables():
                entry = {"table": table}
                # shared public schemas contain foreign tables: names
                # _ident rejects, or tables this role cannot SELECT —
                # skip those rather than abort the whole census
                try:
                    with conn.cursor() as cur:
                        cur.execute(
                            f"SELECT COUNT(*) FROM {_ident(table)}")
                        entry["rows"] = cur.fetchone()[0]
                except Exception:
                    try:
                        conn.rollback()
                    except Exception:
                        pass
                    continue
                for col in ("date", "timestamp"):
                    try:
                        with conn.cursor() as cur:
                            cur.execute(
                                f"SELECT MIN({_ident(col)}), "
                                f"MAX({_ident(col)}) "
                                f"FROM {_ident(table)}")
                            lo, hi = cur.fetchone()
                        if lo is not None:
                            entry["from"], entry["to"] = str(lo), str(hi)
                            break
                    except Exception:
                        try:
                            conn.rollback()
                        except Exception:
                            pass
                report.append(entry)
        return report


def get_store(cfg) -> "MemoryStore | ParquetStore | PostgresStore":
    """Build the configured storage adapter (cfg: StorageConfig)."""
    if cfg.backend == "memory":
        return MemoryStore()
    if cfg.backend == "parquet":
        return ParquetStore(cfg.root)
    if cfg.backend == "postgres":
        return PostgresStore(cfg.pg_host, cfg.pg_database, cfg.pg_user,
                             cfg.pg_password, cfg.pg_port)
    raise ValueError(f"unknown storage backend: {cfg.backend!r}")
