"""Minimal pure-Python PostgreSQL wire-protocol (v3) driver.

Why this exists: the reference's entire storage layer runs on psycopg2
(/root/reference/src/database/connection.py:10-71,
optimized_connection.py:13-297), but this image ships neither psycopg2
nor pg8000 nor a PostgreSQL server, and nothing can be installed — so a
C-driver dependency would leave the Postgres adapter permanently
unexecuted. This module implements the slice of the v3 protocol the
:class:`~iv_engine.pipeline.storage.PostgresStore` needs,
with zero dependencies beyond the standard library:

  * startup + authentication: trust, cleartext, MD5, SCRAM-SHA-256
    (RFC 5802/7677, no channel binding);
  * the simple-query protocol (Q / RowDescription / DataRow /
    CommandComplete / ErrorResponse / ReadyForQuery);
  * a DB-API-flavoured Connection/Cursor with ``%s`` parameters rendered
    client-side as SQL literals (the approach pg8000 used for years);
  * server-side streaming via DECLARE/FETCH/CLOSE cursors (what psycopg2
    named cursors compile to on the wire);
  * an ``execute_values``-compatible batch-insert helper.

It is exercised end-to-end against a loopback server speaking the real
byte protocol in tests/test_pgwire.py and tests/test_postgres_live.py,
and against a live server whenever ``IVTPU_PG_TEST_DSN`` is set.
"""

from __future__ import annotations

import base64
import datetime as _dt
import hashlib
import hmac
import math
import os
import socket
import struct
from typing import Any, Iterable, List, Optional, Sequence, Tuple


class PgError(Exception):
    """Server-reported error (severity, code, message)."""

    def __init__(self, fields: dict):
        self.fields = fields
        super().__init__(
            f"{fields.get('S', 'ERROR')} {fields.get('C', '')}: "
            f"{fields.get('M', 'unknown error')}")


class InterfaceError(Exception):
    """Client-side protocol/usage error."""


# --------------------------------------------------------------------------
# literal rendering (client-side parameters)
# --------------------------------------------------------------------------

def _quote_string(s: str) -> str:
    if "\x00" in s:
        raise InterfaceError("NUL byte in string literal")
    # standard_conforming_strings=on is the server default since 9.1:
    # only single quotes need doubling; E'' strings are avoided entirely
    return "'" + s.replace("'", "''") + "'"


def _quote_ident(name: str) -> str:
    """Quote a SQL identifier (cursor names): embedded double quotes are
    doubled, the same discipline _quote_string applies to literals — an
    unescaped name could end the identifier early and inject statements
    into DECLARE/FETCH/CLOSE (round-4 review)."""
    if "\x00" in name:
        raise InterfaceError("NUL byte in identifier")
    return '"' + name.replace('"', '""') + '"'


def render_literal(v: Any) -> str:
    """Render one Python value as a PostgreSQL literal."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if hasattr(v, "item") and type(v).__module__ == "numpy":
        return render_literal(v.item())
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return "'NaN'"
        if math.isinf(v):
            return "'Infinity'" if v > 0 else "'-Infinity'"
        return repr(v)
    if isinstance(v, _dt.datetime):
        return _quote_string(v.isoformat(sep=" "))
    if isinstance(v, _dt.date):
        return _quote_string(v.isoformat())
    if isinstance(v, (list, tuple)):
        if not v:
            # ARRAY[] is untyped and the server rejects it (42P18);
            # psycopg2 adapts [] to the castable string literal '{}'
            return "'{}'"
        return "ARRAY[" + ", ".join(render_literal(x) for x in v) + "]"
    if isinstance(v, bytes):
        return "'\\x" + v.hex() + "'::bytea"
    s = str(v)  # str, pd.Timestamp, Decimal, ...
    return _quote_string(s)


def render_query(query: str, params: Optional[Sequence[Any]]) -> str:
    """Substitute ``%s`` placeholders with safely rendered literals.

    Follows psycopg2's escaping convention: ``%%`` is a literal percent
    sign (e.g. ``LIKE '%%btc%%'``) and never counts as a placeholder.
    """
    if params is None:
        return query
    # split on %% first so literal percents are never parsed as %s
    out_segments = []
    n_placeholders = 0
    for seg in query.split("%%"):
        parts = seg.split("%s")
        n_placeholders += len(parts) - 1
        out_segments.append(parts)
    if n_placeholders != len(params):
        raise InterfaceError(
            f"query has {n_placeholders} placeholders, "
            f"{len(params)} parameters given")
    it = iter(params)
    rendered = []
    for parts in out_segments:
        out = [parts[0]]
        for part in parts[1:]:
            out.append(render_literal(next(it)))
            out.append(part)
        rendered.append("".join(out))
    return "%".join(rendered)


# --------------------------------------------------------------------------
# text-format value decoding
# --------------------------------------------------------------------------

def _parse_ts(s: str):
    try:
        # Postgres sends timestamptz offsets as '+00' (no minutes);
        # Python < 3.11's fromisoformat rejects that form — normalise
        if len(s) > 3 and s[-3] in "+-" and s[-2:].isdigit():
            s = s + ":00"
        return _dt.datetime.fromisoformat(s)
    except ValueError:
        return s  # 'infinity', BC dates, ... — hand back the raw text


def _parse_date(s: str):
    try:
        return _dt.date.fromisoformat(s)
    except ValueError:
        # 'infinity'/'-infinity'/BC dates are VALID Postgres values; a
        # raised ValueError here would abort mid-DataRow and desync the
        # wire protocol (the next query would read this one's leftovers)
        return s


def _parse_numeric(s: str):
    from decimal import Decimal, InvalidOperation
    try:
        return Decimal(s)  # psycopg2 parity: numeric is exact
    except InvalidOperation:
        return s


_DECODERS = {
    16: lambda s: s == "t",                      # bool
    20: int, 21: int, 23: int, 26: int,          # int8/2/4, oid
    700: float, 701: float,                      # float4/8
    1700: _parse_numeric,                        # numeric -> Decimal
    1114: _parse_ts, 1184: _parse_ts,            # timestamp[tz]
    1082: _parse_date,                           # date
}


def decode_value(oid: int, text: Optional[str]):
    if text is None:
        return None
    dec = _DECODERS.get(oid)
    return dec(text) if dec else text


# --------------------------------------------------------------------------
# wire helpers
# --------------------------------------------------------------------------

def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise InterfaceError("connection closed by server")
        buf += chunk
    return buf


def _read_message(sock: socket.socket) -> Tuple[bytes, bytes]:
    head = _recv_exact(sock, 5)
    tag = head[:1]
    (length,) = struct.unpack("!I", head[1:5])
    return tag, _recv_exact(sock, length - 4)


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _parse_error_fields(body: bytes) -> dict:
    fields = {}
    for part in body.split(b"\x00"):
        if part:
            fields[chr(part[0])] = part[1:].decode("utf-8", "replace")
    return fields


# --------------------------------------------------------------------------
# SCRAM-SHA-256 client (RFC 5802/7677, gs2 header "n,," — no channel
# binding, which matches libpq over non-SSL sockets)
# --------------------------------------------------------------------------

class _ScramClient:
    def __init__(self, user: str, password: str):
        self.password = password.encode()
        self.nonce = base64.b64encode(os.urandom(18)).decode()
        # per RFC 5802 the server uses the authentication identity from
        # the startup message; the n= attribute may be empty
        self.client_first_bare = f"n=,r={self.nonce}"

    def first_message(self) -> bytes:
        return ("n,," + self.client_first_bare).encode()

    def final_message(self, server_first: bytes) -> bytes:
        attrs = dict(p.split("=", 1)
                     for p in server_first.decode().split(","))
        self.server_first = server_first.decode()
        r, s, i = attrs["r"], attrs["s"], int(attrs["i"])
        if not r.startswith(self.nonce):
            raise InterfaceError("SCRAM server nonce mismatch")
        salted = hashlib.pbkdf2_hmac("sha256", self.password,
                                     base64.b64decode(s), i)
        client_key = hmac.new(salted, b"Client Key",
                              hashlib.sha256).digest()
        stored = hashlib.sha256(client_key).digest()
        self.without_proof = f"c={base64.b64encode(b'n,,').decode()},r={r}"
        auth_msg = ",".join([self.client_first_bare, self.server_first,
                             self.without_proof]).encode()
        sig = hmac.new(stored, auth_msg, hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(client_key, sig))
        server_key = hmac.new(salted, b"Server Key",
                              hashlib.sha256).digest()
        self.server_sig = base64.b64encode(
            hmac.new(server_key, auth_msg, hashlib.sha256).digest()
        ).decode()
        return (self.without_proof
                + ",p=" + base64.b64encode(proof).decode()).encode()

    def verify_final(self, server_final: bytes) -> None:
        attrs = dict(p.split("=", 1)
                     for p in server_final.decode().split(","))
        if attrs.get("v") != self.server_sig:
            raise InterfaceError("SCRAM server signature mismatch")


# --------------------------------------------------------------------------
# connection / cursor
# --------------------------------------------------------------------------

class Cursor:
    """Simple-query cursor. ``name`` emulates psycopg2 named cursors via
    DECLARE/FETCH (server-side streaming); set ``itersize`` before
    ``execute`` to size the FETCH batches."""

    def __init__(self, conn: "Connection", name: Optional[str] = None):
        self._conn = conn
        self._name = name
        self.itersize = 10_000
        self.description: Optional[List[tuple]] = None
        self._rows: List[tuple] = []
        self._pos = 0
        self.rowcount = -1
        self._declared = False

    # -- context manager ----------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        if self._declared:
            try:
                self._conn._simple_query(f'CLOSE {_quote_ident(self._name)}')
            except (PgError, InterfaceError, OSError):
                # a dead connection during unwinding must not replace
                # the informative original exception
                pass
            self._declared = False

    # -- execution ----------------------------------------------------
    def execute(self, query: str, params: Optional[Sequence] = None):
        sql = render_query(query, params)
        if self._name is not None:
            self._conn._ensure_tx()
            self._conn._simple_query(
                f'DECLARE {_quote_ident(self._name)} NO SCROLL CURSOR FOR {sql}')
            self._declared = True
            self.description = None
            self._rows, self._pos = [], 0
            return self
        # psycopg2 parity: open an implicit transaction so a page-3
        # failure in a multi-statement write rolls back pages 1-2 too
        # (autocommit left each page committed; commit/rollback were
        # silent no-ops)
        if not self._conn.autocommit:
            self._conn._ensure_tx()
        desc, rows, tag = self._conn._simple_query(sql)
        self.description = desc
        self._rows, self._pos = rows, 0
        self.rowcount = _rowcount_from_tag(tag, rows)
        return self

    def _fetch_from_portal(self, n: int) -> List[tuple]:
        desc, rows, _ = self._conn._simple_query(
            f'FETCH FORWARD {int(n)} FROM {_quote_ident(self._name)}')
        if desc is not None and self.description is None:
            self.description = desc
        return rows

    def fetchone(self):
        row = self.fetchmany(1)
        return row[0] if row else None

    def fetchmany(self, n: Optional[int] = None) -> List[tuple]:
        # DB-API: 'at most n rows' — fetchmany(0) returns [] (the falsy
        # fallback used to silently fetch a full itersize batch)
        n = self.itersize if n is None else int(n)
        if n <= 0:
            return []
        if self._name is not None:
            return self._fetch_from_portal(n)
        out = self._rows[self._pos:self._pos + n]
        self._pos += len(out)
        return out

    def fetchall(self) -> List[tuple]:
        if self._name is not None:
            out: List[tuple] = []
            while True:
                chunk = self._fetch_from_portal(self.itersize)
                if not chunk:
                    return out
                out.extend(chunk)
        out = self._rows[self._pos:]
        self._pos = len(self._rows)
        return out

    def __iter__(self):
        while True:
            rows = self.fetchmany(self.itersize)
            if not rows:
                return
            yield from rows


def _rowcount_from_tag(tag: Optional[str], rows: list) -> int:
    if tag:
        parts = tag.split()
        if parts and parts[-1].isdigit():
            return int(parts[-1])
    return len(rows)


class Connection:
    """One socket, simple-query protocol, explicit transactions."""

    def __init__(self, host: str, database: str, user: str,
                 password: str = "", port: int = 5432,
                 timeout: float = 30.0):
        self.user = user
        if host.startswith("/"):  # unix-domain socket directory
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(timeout)
            self._sock.connect(os.path.join(host, f".s.PGSQL.{port}"))
        else:
            self._sock = socket.create_connection((host, port),
                                                  timeout=timeout)
            # TCP-only: setting it on an AF_UNIX socket raises
            # EOPNOTSUPP, which made every unix-socket connect fail
            self._sock.setsockopt(socket.IPPROTO_TCP,
                                  socket.TCP_NODELAY, 1)
        self.parameters: dict = {}
        self._in_tx = False
        # psycopg2 parity: statements run inside an implicit transaction
        # (commit()/rollback() are meaningful); set True for statements
        # that refuse transaction blocks (CREATE INDEX CONCURRENTLY —
        # storage.py flips this exactly there)
        self.autocommit = False
        self.closed = False
        self._startup(database, user, password)
        # _quote_string renders literals assuming doubled-quote-only
        # escaping; with standard_conforming_strings=off (legacy servers
        # / misconfiguration) backslashes in client-rendered strings
        # change meaning — an escaping/injection hazard. The server
        # reports the setting via ParameterStatus during startup; fix
        # the session rather than refuse (one SET, reported back as a
        # new ParameterStatus that _simple_query records).
        if self.parameters.get("standard_conforming_strings") == "off":
            self._simple_query("SET standard_conforming_strings = on")
            if self.parameters.get(
                    "standard_conforming_strings") == "off":
                self.close()
                raise InterfaceError(
                    "server rejects standard_conforming_strings=on; "
                    "client-side literal quoting would be unsafe")
        # the timeout guards only connection establishment + auth
        # (psycopg2 semantics): long statements — CREATE INDEX
        # CONCURRENTLY, COUNT(*) over 32M-row tables — must not hit a
        # mid-read socket.timeout, which would desynchronise the wire
        self._sock.settimeout(None)

    # -- protocol -----------------------------------------------------
    def _startup(self, database: str, user: str, password: str):
        body = struct.pack("!I", 196608)  # protocol 3.0
        body += _cstr("user") + _cstr(user)
        body += _cstr("database") + _cstr(database)
        body += _cstr("client_encoding") + _cstr("UTF8")
        body += b"\x00"
        self._sock.sendall(struct.pack("!I", len(body) + 4) + body)
        scram: Optional[_ScramClient] = None
        while True:
            tag, payload = _read_message(self._sock)
            if tag == b"R":
                (code,) = struct.unpack("!I", payload[:4])
                if code == 0:          # AuthenticationOk
                    continue
                if code == 3:          # cleartext
                    self._sock.sendall(_msg(b"p", _cstr(password)))
                elif code == 5:        # MD5
                    salt = payload[4:8]
                    inner = hashlib.md5(
                        password.encode() + user.encode()).hexdigest()
                    h = "md5" + hashlib.md5(
                        inner.encode() + salt).hexdigest()
                    self._sock.sendall(_msg(b"p", _cstr(h)))
                elif code == 10:       # SASL: mechanism list
                    mechs = [m for m in payload[4:].split(b"\x00") if m]
                    if b"SCRAM-SHA-256" not in mechs:
                        raise InterfaceError(
                            f"unsupported SASL mechanisms: {mechs}")
                    scram = _ScramClient(user, password)
                    first = scram.first_message()
                    self._sock.sendall(_msg(
                        b"p", _cstr("SCRAM-SHA-256")
                        + struct.pack("!I", len(first)) + first))
                elif code == 11:       # SASL continue
                    assert scram is not None
                    self._sock.sendall(
                        _msg(b"p", scram.final_message(payload[4:])))
                elif code == 12:       # SASL final
                    assert scram is not None
                    scram.verify_final(payload[4:])
                else:
                    raise InterfaceError(f"unsupported auth code {code}")
            elif tag == b"S":          # ParameterStatus
                k, v = payload.split(b"\x00")[:2]
                self.parameters[k.decode()] = v.decode()
            elif tag == b"K":          # BackendKeyData
                self._backend_key = struct.unpack("!II", payload)
            elif tag == b"Z":          # ReadyForQuery
                return
            elif tag == b"E":
                raise PgError(_parse_error_fields(payload))
            else:  # NoticeResponse and anything else: ignore
                continue

    def _simple_query(self, sql: str):
        """Send one simple query; returns (description, rows, cmd_tag)."""
        if self.closed:
            raise InterfaceError("connection is closed")
        self._sock.sendall(_msg(b"Q", _cstr(sql)))
        desc = None
        oids: List[int] = []
        rows: List[tuple] = []
        tag_txt = None
        error: Optional[PgError] = None
        while True:
            tag, payload = _read_message(self._sock)
            if tag == b"T":            # RowDescription
                (nf,) = struct.unpack("!H", payload[:2])
                off = 2
                # a new result set starts: drop the previous statement's
                # rows too (psycopg2 parity — a multi-statement simple
                # query returns only the LAST result set; keeping prior
                # rows mixed differently-shaped tuples under the last
                # statement's description, round-4 review)
                desc, oids, rows = [], [], []
                for _ in range(nf):
                    end = payload.index(b"\x00", off)
                    name = payload[off:end].decode()
                    off = end + 1
                    (_tbl, _att, oid, _len, _mod,
                     _fmt) = struct.unpack("!IhIhih", payload[off:off + 18])
                    off += 18
                    desc.append((name, oid, None, None, None, None, None))
                    oids.append(oid)
            elif tag == b"D":          # DataRow
                (nf,) = struct.unpack("!H", payload[:2])
                off = 2
                vals = []
                for i in range(nf):
                    (ln,) = struct.unpack("!i", payload[off:off + 4])
                    off += 4
                    if ln == -1:
                        vals.append(None)
                    else:
                        vals.append(decode_value(
                            oids[i], payload[off:off + ln].decode()))
                        off += ln
                rows.append(tuple(vals))
            elif tag == b"C":          # CommandComplete
                tag_txt = payload.rstrip(b"\x00").decode()
            elif tag == b"E":
                error = PgError(_parse_error_fields(payload))
            elif tag in (b"G", b"H", b"W"):  # Copy{In,Out,Both}Response
                # COPY is unsupported; silently ignoring CopyInResponse
                # deadlocked the connection (server waits for CopyData,
                # client waits for ReadyForQuery). Refuse the COPY so
                # the server errors and returns to ReadyForQuery, then
                # surface the refusal.
                if tag == b"G":
                    self._sock.sendall(
                        _msg(b"f", _cstr("COPY not supported by pgwire")))
                if error is None:
                    error = InterfaceError(
                        "COPY is not supported by this driver")
            elif tag == b"S":          # ParameterStatus (SET, reloads)
                k, v = payload.split(b"\x00")[:2]
                self.parameters[k.decode()] = v.decode()
            elif tag == b"Z":          # ReadyForQuery
                self._in_tx = payload[:1] in (b"T", b"E")
                if error is not None:
                    raise error
                return desc, rows, tag_txt
            # I (EmptyQueryResponse), N (notice): ignore

    # -- DB-API surface ----------------------------------------------
    def cursor(self, name: Optional[str] = None) -> Cursor:
        return Cursor(self, name)

    def _ensure_tx(self):
        if not self._in_tx:
            self._simple_query("BEGIN")

    def commit(self):
        if self._in_tx:
            self._simple_query("COMMIT")

    def rollback(self):
        if self._in_tx:
            self._simple_query("ROLLBACK")

    def close(self):
        if not self.closed:
            try:
                self._sock.sendall(_msg(b"X", b""))  # Terminate
            except OSError:
                pass
            self._sock.close()
            self.closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.commit()
        else:
            try:
                self.rollback()
            except Exception:
                pass


def connect(host: str, database: str, user: str, password: str = "",
            port: int = 5432, **kw) -> Connection:
    """DB-API-style constructor (keyword-compatible with psycopg2's
    common subset)."""
    return Connection(host, database, user, password, port, **kw)


def execute_values(cur: Cursor, query: str, rows: Iterable[Sequence],
                   page_size: int = 1000) -> None:
    """psycopg2.extras.execute_values equivalent: expand the ``VALUES %s``
    placeholder into literal row tuples, paged.

    The placeholder is located with the same ``%%``-is-a-literal rule as
    :func:`render_query` (a naive str.replace matched the '%s' inside an
    escaped ``LIKE 'a%%s'`` pattern first and corrupted the query), and
    since ``execute`` is called without params — so ``render_query``
    never runs — the ``%%`` collapse happens here.
    """
    import re
    m = re.search(r"(?<!%)(?:%%)*(%s)", query)
    if m is None:
        raise InterfaceError("query must contain a VALUES %s placeholder")
    pre = query[:m.start(1)].replace("%%", "%")
    post = query[m.end(1):].replace("%%", "%")
    rows = list(rows)
    for start in range(0, len(rows), page_size):
        page = rows[start:start + page_size]
        values = ", ".join(
            "(" + ", ".join(render_literal(v) for v in r) + ")"
            for r in page)
        cur.execute(pre + values + post)
