"""In-process PostgreSQL mock server for exercising the pure-Python wire
driver (iv_engine.pipeline.pgwire) against REAL protocol
bytes over a loopback socket.

This image has no psycopg2, no pg8000 and no PostgreSQL server, and
nothing can be installed — so this fixture is the strongest available
execution evidence for the Postgres adapter: the driver's startup, SASL
SCRAM-SHA-256 / MD5 / cleartext auth, literal rendering, simple-query
framing, DECLARE/FETCH streaming and type decoding all run against the
actual v3 byte protocol, and the store's generated SQL runs against a
tiny in-memory engine implementing exactly the statement shapes
PostgresStore emits (CREATE TABLE / INSERT ... ON CONFLICT / SELECT /
COUNT / DISTINCT / DROP / cursors). A live server (IVTPU_PG_TEST_DSN)
still runs the same tests unmodified.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import re
import socket
import struct
import threading
from typing import List, Optional


def _cstr(s: str) -> bytes:
    return s.encode() + b"\x00"


def _msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


# --------------------------------------------------------------------------
# mini SQL engine (the statement shapes PostgresStore emits, nothing more)
# --------------------------------------------------------------------------

_CONSTRAINT_WORDS = {"primary", "unique", "check", "constraint", "foreign"}


def _split_top(s: str, sep: str = ",") -> List[str]:
    out, depth, cur, quote = [], 0, [], False
    for ch in s:
        if quote:
            cur.append(ch)
            if ch == "'":
                quote = False
            continue
        if ch == "'":
            quote = True
            cur.append(ch)
        elif ch == "(":
            depth += 1
            cur.append(ch)
        elif ch == ")":
            depth -= 1
            cur.append(ch)
        elif ch == sep and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return out


def _parse_literal(tok: str):
    t = tok.strip()
    u = t.upper()
    if u == "NULL":
        return None
    if u == "TRUE":
        return True
    if u == "FALSE":
        return False
    if t.startswith("'"):
        body = t[1:-1].replace("''", "'")
        if body in ("NaN", "Infinity", "-Infinity"):
            return float(body.replace("Infinity", "inf"))
        return body
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        return t


def _unquote_ident(s: str) -> str:
    s = s.strip()
    return s[1:-1].replace('""', '"') if s.startswith('"') else s.lower()


class MiniEngine:
    """Executes the store's SQL against in-memory tables."""

    def __init__(self):
        self.tables: dict = {}

    # returns (columns or None, rows, command_tag)
    def execute(self, sql: str):
        s = sql.strip().rstrip(";").strip()
        low = s.lower()
        if not s or low in ("begin", "commit", "rollback"):
            return None, [], low.upper() or "EMPTY"
        if low.startswith("set "):
            return None, [], "SET"
        if low.startswith("create index"):
            return None, [], "CREATE INDEX"
        if low.startswith("create table"):
            return self._create(s)
        if low.startswith("drop table"):
            m = re.match(r"drop table (?:if exists )?(.+)", low)
            name = _unquote_ident(s[m.start(1):].strip())
            self.tables.pop(name, None)
            return None, [], "DROP TABLE"
        if low.startswith("insert into"):
            return self._insert(s)
        if low.startswith("select"):
            return self._select(s)
        raise ValueError(f"mock engine: unsupported SQL: {s[:120]}")

    def _create(self, s: str):
        m = re.match(r"create table (?:if not exists )?(\S+)\s*\((.*)\)\s*$",
                     s, re.I | re.S)
        name = _unquote_ident(m.group(1))
        if name in self.tables:
            return None, [], "CREATE TABLE"
        cols = []
        checks = set()
        for item in _split_top(m.group(2)):
            first = item.split()[0]
            if first.lower() in _CONSTRAINT_WORDS:
                # record the reference's two named CHECKs so inserts can
                # enforce them like a real server (candle_schema.py:41-48)
                if "valid_ohlc" in item:
                    checks.add("valid_ohlc")
                if "positive_volume" in item:
                    checks.add("positive_volume")
                continue
            cols.append(_unquote_ident(first))
        self.tables[name] = {"columns": cols, "rows": [],
                             "checks": checks}
        return None, [], "CREATE TABLE"

    def _insert(self, s: str):
        m = re.match(
            r"insert into (\S+)\s*\((.*?)\)\s*values\s*(.*?)\s*"
            r"(on conflict\s*\((.*?)\)\s*do (update set .*|nothing))?$",
            s, re.I | re.S)
        if m is None:
            raise ValueError(f"mock engine: bad INSERT: {s[:120]}")
        name = _unquote_ident(m.group(1))
        tbl = self.tables[name]
        cols = [_unquote_ident(c) for c in _split_top(m.group(2))]
        rows_sql = _split_top(m.group(3))
        keys = ([_unquote_ident(k) for k in _split_top(m.group(5))]
                if m.group(5) else None)
        do_nothing = bool(m.group(6)) and m.group(6).lower() == "nothing"
        n = 0
        for row_sql in rows_sql:
            inner = row_sql.strip()
            assert inner.startswith("(") and inner.endswith(")")
            vals = [_parse_literal(v) for v in _split_top(inner[1:-1])]
            rec = dict(zip(cols, vals))
            self._enforce_checks(tbl, rec, name)
            if keys:
                match = next(
                    (r for r in tbl["rows"]
                     if all(r.get(k) == rec.get(k) for k in keys)), None)
                if match is not None:
                    if not do_nothing:
                        match.update(rec)
                    n += 1
                    continue
            tbl["rows"].append(rec)
            n += 1
        return None, [], f"INSERT 0 {n}"

    @staticmethod
    def _enforce_checks(tbl, rec, name):
        checks = tbl.get("checks", set())
        if "valid_ohlc" in checks:
            o, h, l, c = (rec.get(k) for k in
                          ("open", "high", "low", "close"))
            if None not in (o, h, l, c) and not (
                    h >= l and h >= o and h >= c and l <= o and l <= c):
                raise ValueError(
                    f'new row for relation "{name}" violates check '
                    f'constraint "valid_ohlc"')
        if "positive_volume" in checks:
            v = rec.get("volume")
            if v is not None and v < 0:
                raise ValueError(
                    f'new row for relation "{name}" violates check '
                    f'constraint "positive_volume"')

    def _select(self, s: str):
        low = s.lower()
        if low == "select 1":  # connectivity ping
            return ["?column?"], [(1,)], "SELECT 1"
        if low == "select version()":
            return ["version"], [("PostgreSQL 16.0 (ivtpu mock)",)], \
                "SELECT 1"
        if "from pg_tables" in low:
            rows = [(t,) for t in sorted(self.tables)]
            return ["tablename"], rows, f"SELECT {len(rows)}"
        if "from pg_stat_user_tables" in low:
            return ["count"], [(len(self.tables),)], "SELECT 1"
        if "pg_database_size" in low:
            size = sum(len(t["rows"]) * 100 for t in self.tables.values())
            return ["pg_database_size"], [(8192 + size,)], "SELECT 1"
        m = re.match(
            r"select\s+(.*?)\s+from\s+(\S+)"
            r"(?:\s+where\s+(.*?))?(?:\s+order by\s+(.*?))?$",
            s, re.I | re.S)
        if m is None:
            raise ValueError(f"mock engine: bad SELECT: {s[:120]}")
        proj, name = m.group(1).strip(), _unquote_ident(m.group(2))
        where, order = m.group(3), m.group(4)
        tbl = self.tables.get(name)
        if tbl is None:
            raise ValueError(f'relation "{name}" does not exist')
        rows = list(tbl["rows"])
        if where:
            wm = re.match(r"(\S+)\s*=\s*any\s*\(\s*array\[(.*)\]\s*\)",
                          where.strip(), re.I | re.S)
            col = _unquote_ident(wm.group(1))
            allowed = {_parse_literal(v)
                       for v in _split_top(wm.group(2))}
            rows = [r for r in rows if r.get(col) in allowed]
        distinct = False
        if proj.lower().startswith("distinct "):
            distinct = True
            proj = proj[len("distinct "):]
        if proj.strip().lower() == "count(*)":
            return ["count"], [(len(rows),)], "SELECT 1"
        mm = re.match(r"min\((\S+?)\)\s*,\s*max\((\S+?)\)\s*$",
                      proj.strip(), re.I)
        if mm:
            c1, c2 = (_unquote_ident(g) for g in mm.groups())
            v1 = [r[c1] for r in rows if r.get(c1) is not None]
            v2 = [r[c2] for r in rows if r.get(c2) is not None]
            return (["min", "max"],
                    [(min(v1) if v1 else None, max(v2) if v2 else None)],
                    "SELECT 1")
        if proj.strip() == "*":
            cols = tbl["columns"]
        else:
            cols = [_unquote_ident(c) for c in _split_top(proj)]
        out = [tuple(r.get(c) for c in cols) for r in rows]
        if distinct:
            seen, ded = set(), []
            for r in out:
                if r not in seen:
                    seen.add(r)
                    ded.append(r)
            out = ded
        if order:
            key = _unquote_ident(order.split()[0])
            idx = cols.index(key) if key in cols else 0
            out.sort(key=lambda r: (r[idx] is None, r[idx]))
        return cols, out, f"SELECT {len(out)}"


def _oid_of(v) -> int:
    if isinstance(v, bool):
        return 16
    if isinstance(v, int):
        return 20
    if isinstance(v, float):
        return 701
    return 25


def _encode_text(v) -> str:
    if isinstance(v, bool):
        return "t" if v else "f"
    return str(v)


# --------------------------------------------------------------------------
# the server
# --------------------------------------------------------------------------

class MockPgServer:
    """Loopback v3-protocol server; one thread per connection.

    auth: 'trust' | 'cleartext' | 'md5' | 'scram-sha-256'
    """

    def __init__(self, auth: str = "scram-sha-256", user: str = "ivtpu",
                 password: str = "secret"):
        self.auth = auth
        self.user = user
        self.password = password
        self.engine = MiniEngine()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def close(self):
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- accept loop --------------------------------------------------
    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _recv_exact(self, sock, n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client gone")
            buf += chunk
        return buf

    def _handle(self, sock: socket.socket):
        try:
            (length,) = struct.unpack("!I", self._recv_exact(sock, 4))
            body = self._recv_exact(sock, length - 4)
            (proto,) = struct.unpack("!I", body[:4])
            if proto != 196608:
                sock.close()  # no SSL negotiation support needed
                return
            if not self._authenticate(sock):
                return
            for k, v in (("server_version", "16.0"),
                         ("client_encoding", "UTF8"),
                         ("standard_conforming_strings", "on")):
                sock.sendall(_msg(b"S", _cstr(k) + _cstr(v)))
            sock.sendall(_msg(b"K", struct.pack("!II", os.getpid(), 7)))
            sock.sendall(_msg(b"Z", b"I"))
            portals: dict = {}
            state = {"tx": False}  # transaction status for ReadyForQuery
            while True:
                tag = self._recv_exact(sock, 1)
                (ln,) = struct.unpack("!I", self._recv_exact(sock, 4))
                payload = self._recv_exact(sock, ln - 4)
                if tag == b"X":
                    sock.close()
                    return
                if tag != b"Q":
                    continue
                sql = payload.rstrip(b"\x00").decode()
                self._run_query(sock, sql, portals, state)
        except (ConnectionError, OSError):
            pass

    # -- auth ---------------------------------------------------------
    def _authenticate(self, sock) -> bool:
        def read_pw():
            t = self._recv_exact(sock, 1)
            (ln,) = struct.unpack("!I", self._recv_exact(sock, 4))
            body = self._recv_exact(sock, ln - 4)
            assert t == b"p"
            return body

        if self.auth == "trust":
            pass
        elif self.auth == "cleartext":
            sock.sendall(_msg(b"R", struct.pack("!I", 3)))
            if read_pw().rstrip(b"\x00").decode() != self.password:
                return self._auth_fail(sock)
        elif self.auth == "md5":
            salt = os.urandom(4)
            sock.sendall(_msg(b"R", struct.pack("!I", 5) + salt))
            inner = hashlib.md5(
                (self.password + self.user).encode()).hexdigest()
            want = "md5" + hashlib.md5(inner.encode() + salt).hexdigest()
            if read_pw().rstrip(b"\x00").decode() != want:
                return self._auth_fail(sock)
        elif self.auth == "scram-sha-256":
            sock.sendall(_msg(b"R", struct.pack("!I", 10)
                              + _cstr("SCRAM-SHA-256") + b"\x00"))
            body = read_pw()
            end = body.index(b"\x00")
            assert body[:end] == b"SCRAM-SHA-256"
            (flen,) = struct.unpack("!I", body[end + 1:end + 5])
            client_first = body[end + 5:end + 5 + flen].decode()
            bare = client_first.split(",", 2)[2]
            cnonce = dict(p.split("=", 1)
                          for p in bare.split(","))["r"]
            snonce = cnonce + base64.b64encode(os.urandom(12)).decode()
            salt = os.urandom(16)
            iters = 4096
            server_first = (f"r={snonce},"
                            f"s={base64.b64encode(salt).decode()},"
                            f"i={iters}")
            sock.sendall(_msg(b"R", struct.pack("!I", 11)
                              + server_first.encode()))
            final = read_pw().decode()
            attrs = dict(p.split("=", 1) for p in final.split(","))
            salted = hashlib.pbkdf2_hmac(
                "sha256", self.password.encode(), salt, iters)
            client_key = hmac.new(salted, b"Client Key",
                                  hashlib.sha256).digest()
            stored = hashlib.sha256(client_key).digest()
            without_proof = final[:final.rindex(",p=")]
            auth_msg = ",".join([bare, server_first,
                                 without_proof]).encode()
            sig = hmac.new(stored, auth_msg, hashlib.sha256).digest()
            want = bytes(a ^ b for a, b in zip(client_key, sig))
            if base64.b64decode(attrs["p"]) != want:
                return self._auth_fail(sock)
            server_key = hmac.new(salted, b"Server Key",
                                  hashlib.sha256).digest()
            v = base64.b64encode(hmac.new(server_key, auth_msg,
                                          hashlib.sha256).digest())
            sock.sendall(_msg(b"R", struct.pack("!I", 12) + b"v=" + v))
        sock.sendall(_msg(b"R", struct.pack("!I", 0)))
        return True

    def _auth_fail(self, sock) -> bool:
        sock.sendall(_msg(b"E", b"SFATAL\x00C28P01\x00"
                          b"Mpassword authentication failed\x00\x00"))
        sock.close()
        return False

    # -- query handling ----------------------------------------------
    def _run_query(self, sock, sql: str, portals: dict,
                   state: dict | None = None):
        state = state if state is not None else {"tx": False}
        try:
            for stmt in [p for p in _split_top(sql, ";") if p.strip()]:
                low = stmt.strip().lower()
                # transaction tracking: the real server reports status
                # T inside a transaction block in ReadyForQuery — pgwire
                # derives _in_tx from it, so the mock must track it too
                if low == "begin":
                    state["tx"] = True
                    self._complete(sock, None, [], "BEGIN")
                    continue
                if low in ("commit", "rollback"):
                    state["tx"] = False
                    self._complete(sock, None, [], low.upper())
                    continue
                m = re.match(
                    r'declare\s+"?([\w ]+?)"?\s+no scroll cursor for\s+(.*)',
                    stmt.strip(), re.I | re.S)
                if m:
                    cols, rows, _ = self.engine.execute(m.group(2))
                    portals[m.group(1)] = {"cols": cols, "rows": rows,
                                           "pos": 0}
                    self._complete(sock, None, [], "DECLARE CURSOR")
                    continue
                m = re.match(r'fetch forward (\d+) from\s+"?([\w ]+?)"?\s*$',
                             low)
                if m:
                    p = portals[m.group(2)]
                    n = int(m.group(1))
                    chunk = p["rows"][p["pos"]:p["pos"] + n]
                    p["pos"] += len(chunk)
                    self._complete(sock, p["cols"], chunk,
                                   f"FETCH {len(chunk)}")
                    continue
                m = re.match(r'close\s+"?([\w ]+?)"?\s*$', low)
                if m:
                    portals.pop(m.group(1), None)
                    self._complete(sock, None, [], "CLOSE CURSOR")
                    continue
                cols, rows, tag = self.engine.execute(stmt)
                self._complete(sock, cols, rows, tag)
        except Exception as e:  # engine error -> ErrorResponse
            sock.sendall(_msg(b"E", b"SERROR\x00C42601\x00M"
                              + str(e).encode() + b"\x00\x00"))
            state["tx"] = False  # simplification: no failed-tx state
        sock.sendall(_msg(b"Z", b"T" if state["tx"] else b"I"))

    def _complete(self, sock, cols, rows, tag):
        if cols is not None:
            oids = []
            for i in range(len(cols)):
                sample = next((r[i] for r in rows if r[i] is not None),
                              "")
                oids.append(_oid_of(sample))
            body = struct.pack("!H", len(cols))
            for name, oid in zip(cols, oids):
                body += _cstr(name) + struct.pack(
                    "!IhIhih", 0, 0, oid, -1, -1, 0)
            sock.sendall(_msg(b"T", body))
            for r in rows:
                body = struct.pack("!H", len(r))
                for v in r:
                    if v is None:
                        body += struct.pack("!i", -1)
                    else:
                        enc = _encode_text(v).encode()
                        body += struct.pack("!i", len(enc)) + enc
                sock.sendall(_msg(b"D", body))
        sock.sendall(_msg(b"C", _cstr(tag)))
