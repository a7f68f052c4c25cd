"""Wire-driver unit tests: pgwire against the loopback v3 mock server
(real bytes, every auth mode) plus pure rendering/decoding units."""

import datetime as dt

import numpy as np
import pytest

from iv_engine.pipeline import pgwire
from tests.pg_mock_server import MockPgServer


@pytest.mark.parametrize("auth", ["trust", "cleartext", "md5",
                                  "scram-sha-256"])
def test_auth_modes(auth):
    with MockPgServer(auth=auth, user="u", password="pw") as srv:
        conn = pgwire.connect("127.0.0.1", "db", "u", "pw",
                              port=srv.port)
        with conn.cursor() as cur:
            cur.execute("SELECT version()")
            assert "PostgreSQL" in cur.fetchone()[0]
        # the 30 s timeout guards only connect+auth: long statements
        # (CREATE INDEX CONCURRENTLY, big COUNTs) must never hit a
        # mid-read socket.timeout (round-3 review)
        assert conn._sock.gettimeout() is None
        conn.close()


@pytest.mark.parametrize("auth", ["cleartext", "md5", "scram-sha-256"])
def test_wrong_password_rejected(auth):
    with MockPgServer(auth=auth, user="u", password="pw") as srv:
        with pytest.raises((pgwire.PgError, pgwire.InterfaceError)):
            pgwire.connect("127.0.0.1", "db", "u", "WRONG",
                           port=srv.port)


def test_roundtrip_types_and_params():
    with MockPgServer(auth="trust") as srv:
        conn = pgwire.connect("127.0.0.1", "db", "ivtpu", "secret",
                              port=srv.port)
        cur = conn.cursor()
        cur.execute('CREATE TABLE "t" ("sym" VARCHAR(50), "x" '
                    'DOUBLE PRECISION, "n" BIGINT, "ok" BOOLEAN)')
        cur.execute('INSERT INTO "t" ("sym", "x", "n", "ok") VALUES '
                    "(%s, %s, %s, %s)",
                    ("o'brien", 1.5, np.int64(7), True))
        cur.execute('INSERT INTO "t" ("sym", "x", "n", "ok") VALUES '
                    "(%s, %s, %s, %s)", (None, float("nan"), -3, False))
        cur.execute('SELECT "sym", "x", "n", "ok" FROM "t"')
        rows = cur.fetchall()
        assert rows[0] == ("o'brien", 1.5, 7, True)
        assert rows[1][0] is None and np.isnan(rows[1][1])
        assert rows[1][2:] == (-3, False)
        conn.close()


def test_any_array_filter_and_named_cursor():
    with MockPgServer(auth="trust") as srv:
        conn = pgwire.connect("127.0.0.1", "db", "ivtpu", "secret",
                              port=srv.port)
        cur = conn.cursor()
        cur.execute('CREATE TABLE "t" ("symbol" VARCHAR(50), "v" BIGINT)')
        pgwire.execute_values(
            cur, 'INSERT INTO "t" ("symbol", "v") VALUES %s',
            [(f"s{i % 5}", i) for i in range(100)], page_size=30)
        cur.execute('SELECT "symbol", "v" FROM "t" WHERE symbol = '
                    "ANY(%s)", (["s1", "s3"],))
        rows = cur.fetchall()
        assert len(rows) == 40
        assert {r[0] for r in rows} == {"s1", "s3"}
        # server-side streaming via DECLARE/FETCH
        with conn.cursor(name="stream") as named:
            named.itersize = 7
            named.execute('SELECT "symbol", "v" FROM "t"')
            chunks = []
            while True:
                chunk = named.fetchmany(7)
                if not chunk:
                    break
                chunks.append(chunk)
        assert sum(len(c) for c in chunks) == 100
        assert all(len(c) == 7 for c in chunks[:-1])
        conn.close()


def test_error_response_raises_and_connection_survives():
    with MockPgServer(auth="trust") as srv:
        conn = pgwire.connect("127.0.0.1", "db", "ivtpu", "secret",
                              port=srv.port)
        cur = conn.cursor()
        with pytest.raises(pgwire.PgError):
            cur.execute('SELECT * FROM "missing"')
        cur.execute("SELECT version()")  # still usable after error
        assert cur.fetchone() is not None
        conn.close()


def test_render_literal_units():
    rl = pgwire.render_literal
    assert rl(None) == "NULL"
    assert rl(True) == "TRUE"
    assert rl(3) == "3"
    assert rl(1.5) == "1.5"
    assert rl(float("inf")) == "'Infinity'"
    assert rl("a'b") == "'a''b'"
    assert rl(dt.datetime(2023, 1, 2, 3, 4, 5)) == "'2023-01-02 03:04:05'"
    assert rl([1, 2]) == "ARRAY[1, 2]"
    assert rl(np.float32(2.0)) == "2.0"
    with pytest.raises(pgwire.InterfaceError):
        rl("bad\x00byte")
    with pytest.raises(pgwire.InterfaceError):
        pgwire.render_query("SELECT %s", (1, 2))


def test_render_query_percent_escape():
    """psycopg2 convention: %% is a literal percent (LIKE patterns) and
    never counts as a placeholder (regression: round-3 review)."""
    rq = pgwire.render_query
    assert rq("SELECT 1", None) == "SELECT 1"
    assert (rq("SELECT * FROM t WHERE s LIKE '%%btc%%' AND v = %s", (5,))
            == "SELECT * FROM t WHERE s LIKE '%btc%' AND v = 5")
    assert rq("SELECT '100%%'", ()) == "SELECT '100%'"
    assert (rq("%s LIKE '%%a%%' AND %s", ("x", 2))
            == "'x' LIKE '%a%' AND 2")
    with pytest.raises(pgwire.InterfaceError):
        rq("SELECT '%%' WHERE a = %s", (1, 2))


def test_review_fixes_literal_and_decoder_units():
    """Round-3 review findings, unit-level: empty arrays render as the
    castable '{}' (ARRAY[] is untyped and the server rejects it);
    'infinity' dates fall back to the raw string instead of aborting
    mid-DataRow and desyncing the wire; numeric decodes to exact
    Decimal (psycopg2 parity); '+00' timestamptz offsets parse on
    Python 3.10's stricter fromisoformat."""
    from decimal import Decimal

    assert pgwire.render_literal([]) == "'{}'"
    assert pgwire.decode_value(1082, "infinity") == "infinity"
    assert pgwire.decode_value(1082, "2023-03-20") == dt.date(2023, 3, 20)
    assert pgwire.decode_value(1700, "0.123456789012345678901") == \
        Decimal("0.123456789012345678901")
    ts = pgwire.decode_value(1184, "2026-08-18 00:00:00+00")
    assert ts == dt.datetime(2026, 8, 18,
                             tzinfo=dt.timezone.utc)


def test_execute_values_placeholder_respects_percent_escape():
    """A %s inside an escaped LIKE 'a%%s' pattern must not be mistaken
    for the VALUES placeholder, and %% collapses to % exactly once
    (execute_values bypasses render_query)."""
    captured = {}

    class FakeCur:
        def execute(self, sql):
            captured["sql"] = sql

    pgwire.execute_values(
        FakeCur(),
        "INSERT INTO t SELECT 1 WHERE name LIKE 'a%%s' OR x IN VALUES %s",
        [(1, 2)])
    assert captured["sql"] == (
        "INSERT INTO t SELECT 1 WHERE name LIKE 'a%s' OR x IN "
        "VALUES (1, 2)")


def test_fetchmany_zero_returns_empty():
    with MockPgServer(auth="trust") as srv:
        conn = pgwire.connect("127.0.0.1", "db", "u", "",
                              port=srv.port)
        with conn.cursor() as cur:
            cur.execute("SELECT 1")
            assert cur.fetchmany(0) == []
            assert cur.fetchmany(1) == [(1,)]
        conn.close()


def test_implicit_transaction_and_rollback():
    """Plain cursors open an implicit transaction (psycopg2 parity):
    rollback() after an execute must actually send ROLLBACK — under the
    old autocommit behavior commit/rollback were silent no-ops."""
    with MockPgServer(auth="trust") as srv:
        conn = pgwire.connect("127.0.0.1", "db", "u", "",
                              port=srv.port)
        cur = conn.cursor()
        cur.execute("SELECT 1")
        assert conn._in_tx            # BEGIN was sent
        conn.rollback()
        assert not conn._in_tx
        # autocommit mode skips the implicit BEGIN
        conn.autocommit = True
        cur.execute("SELECT 1")
        assert not conn._in_tx
        conn.close()


def test_multi_statement_returns_last_result_set():
    """psycopg2 parity: a multi-statement simple query returns only the
    LAST statement's rows — prior rows used to stay concatenated under
    the last description (round-4 review)."""
    with MockPgServer(auth="trust") as srv:
        conn = pgwire.connect("127.0.0.1", "db", "ivtpu", "secret",
                              port=srv.port)
        with conn.cursor() as cur:
            cur.execute('CREATE TABLE "t1" ("a" BIGINT); '
                        'CREATE TABLE "t2" ("b" BIGINT)')
            cur.execute('INSERT INTO "t1" ("a") VALUES (1), (2); '
                        'INSERT INTO "t2" ("b") VALUES (7)')
            cur.execute('SELECT "a" FROM "t1"; SELECT "b" FROM "t2"')
            rows = cur.fetchall()
            assert rows == [(7,)], rows
            assert cur.description[0][0] == "b"
        conn.close()


def test_quote_ident():
    """Cursor names are identifiers: embedded double quotes must be
    doubled, not end the identifier early (round-4 review)."""
    assert pgwire._quote_ident("plain") == '"plain"'
    assert pgwire._quote_ident('a"b') == '"a""b"'
    assert pgwire._quote_ident('x"; DROP TABLE t; --') \
        == '"x""; DROP TABLE t; --"'
    with pytest.raises(pgwire.InterfaceError):
        pgwire._quote_ident("a\x00b")
