"""Arrow Flight transport for the streaming serving daemon.

The JSONL/TCP server (``pipeline/serve.py``) completes the reference's
operator surface; this module adds the production transport the ROADMAP
left as a nice-to-have: gRPC + Arrow columnar batches, so tick ingest
is zero-copy-decoded straight into the NumPy arrays the device ring
wants (no per-row JSON parsing), and refit results come back as a
RecordBatch table instead of per-underlying JSON dicts.

Protocol (same single-writer :class:`StreamingSession` behind it, same
serialisation lock — COMPONENTS.md §5.2):

* ``do_put`` with any descriptor: a stream of RecordBatches with
  columns ``underlying: utf8 | dictionary``, ``minute: int32``,
  ``price: float32/64``, ``size: float32/64`` — buffered and flushed
  to the session ring in one padded batch per flush.
* ``do_get(Ticket(b"refit"))``: flush + refit; returns a table
  ``underlying, realized_vol, atm_iv, butterfly_ok, calendar_ok``.
* ``do_get(Ticket(b"surfaces"))``: flush + refit; returns the full
  IV grids as ``underlying, expiry, iv: fixed_size_list<float32>[m]``
  (one row per (underlying, expiry) slice).
* ``do_action``: ``flush`` / ``stats`` (JSON payload back) / ``stop``.

Reference analogue: none — the reference's only "serving" is Postgres
polling (SURVEY.md §5.8); this is the device-native replacement's wire
tier. Requires ``pyarrow`` (already a parquet dependency); the module
import-guards so environments without Flight still serve JSONL.
"""

from __future__ import annotations

import json
import threading
from typing import List, Optional

import numpy as np

try:  # pyarrow.flight ships with the pyarrow the parquet tier uses
    import pyarrow as pa
    import pyarrow.flight as fl
    HAVE_FLIGHT = True
except Exception:  # pragma: no cover - exercised via import guard test
    pa = None
    fl = None
    HAVE_FLIGHT = False


# the tick columns do_put requires (validated at the put boundary so a
# malformed batch errors on the OFFENDING client, not on whichever
# client later triggers the flush)
TICK_COLUMNS = ("underlying", "minute", "price", "size")
TICK_SCHEMA_DOC = ("underlying: utf8, minute: int32, price: float, "
                   "size: float")


def _require_flight():
    if not HAVE_FLIGHT:
        raise RuntimeError(
            "pyarrow.flight is unavailable — install pyarrow with Flight "
            "support or use the JSONL server (pipeline/serve.py)")


class FlightStreamServer(fl.FlightServerBase if HAVE_FLIGHT else object):
    """Arrow Flight front-end over one :class:`StreamingSession`."""

    def __init__(self, session, host: str = "127.0.0.1", port: int = 0):
        _require_flight()
        super().__init__(f"grpc+tcp://{host}:{port}")
        # the location must use the RESOLVED port: with the default
        # port=0 the constructor-time string ends in ':0', which no
        # client can connect to (list_flights advertised it)
        self._location = f"grpc+tcp://{host}:{self.port}"
        self.session = session
        self._lock = threading.Lock()
        self._buffer: List = []           # pending (und, minute, price, size)
        self._buffered_rows = 0           # running count: summing the
        #                                   list per chunk was O(n^2)
        #                                   under the lock at 1-row
        #                                   batches
        self._ingested = 0

    # -- ingest --------------------------------------------------------
    def do_put(self, context, descriptor, reader, writer):
        for chunk in reader:
            batch = chunk.data
            if batch is None:             # metadata-only chunk
                continue
            # validate at the boundary: one schema-mismatched or
            # column-missing batch must error on THIS client — buffered
            # unvalidated, it either poisoned every later flush (the
            # bad batch stayed in the buffer after from_batches raised)
            # or silently discarded every other client's ticks
            missing = [c for c in TICK_COLUMNS
                       if c not in batch.schema.names]
            if missing:
                raise fl.FlightServerError(
                    f"tick batch is missing columns {missing}; "
                    f"expected {TICK_SCHEMA_DOC}")
            # types too: a wrong-typed batch (e.g. utf8 minute) would
            # otherwise buffer fine and only fail inside _flush_locked —
            # possibly during ANOTHER client's put/get, the exact
            # cross-client failure this boundary exists to prevent
            for col in ("minute", "price", "size"):
                typ = batch.schema.field(col).type
                if not (pa.types.is_integer(typ)
                        or pa.types.is_floating(typ)):
                    raise fl.FlightServerError(
                        f"tick column {col!r} has non-numeric type "
                        f"{typ}; expected {TICK_SCHEMA_DOC}")
            with self._lock:
                if self._buffer and not batch.schema.equals(
                        self._buffer[0].schema):
                    # differently-typed batches (float32 vs float64
                    # price) cannot share one Table; flush the old
                    # schema's buffer first instead of failing later
                    self._flush_locked()
                self._buffer.append(batch)
                self._buffered_rows += batch.num_rows
                # flush at ~the JSONL server's default batching depth
                if self._buffered_rows >= 10_000:
                    self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._buffer:
            return 0
        import pandas as pd
        tbl = pa.Table.from_batches(self._buffer)
        self._buffer = []
        self._buffered_rows = 0
        df = pd.DataFrame({
            "underlying": tbl.column("underlying").to_numpy(
                zero_copy_only=False),
            "minute": tbl.column("minute").to_numpy(zero_copy_only=False),
            "price": tbl.column("price").to_numpy(zero_copy_only=False),
            "size": tbl.column("size").to_numpy(zero_copy_only=False),
        })
        n = self.session.ingest_ticks(df)
        self._ingested += n
        return n

    # -- results -------------------------------------------------------
    def do_get(self, context, ticket):
        kind = ticket.ticket.decode(errors="replace")
        # validate BEFORE flushing and refitting: an unknown ticket used
        # to cost a full device refit under the server lock before the
        # else branch raised
        if kind not in ("refit", "surfaces"):
            raise fl.FlightServerError(f"unknown ticket {kind!r}")
        with self._lock:
            self._flush_locked()
            out = self.session.refit()
            unds = self.session.underlyings
            if kind == "refit":
                m = out.iv_grid.shape[-1]
                table = pa.table({
                    "underlying": pa.array(unds),
                    "realized_vol": pa.array(
                        np.asarray(out.realized_vol, np.float64)),
                    "atm_iv": pa.array(np.asarray(
                        out.iv_grid[:, 0, m // 2], np.float64)),
                    "butterfly_ok": pa.array(
                        np.asarray(out.butterfly_ok, bool)),
                    "calendar_ok": pa.array(
                        np.asarray(out.calendar_ok, bool)),
                })
            elif kind == "surfaces":
                iv = np.asarray(out.iv_grid, np.float32)  # (B, E, m)
                B, E, m = iv.shape
                table = pa.table({
                    "underlying": pa.array(
                        [u for u in unds for _ in range(E)]),
                    "expiry": pa.array(
                        np.tile(np.arange(E, dtype=np.int32), B)),
                    "iv": pa.FixedSizeListArray.from_arrays(
                        pa.array(iv.reshape(-1)), m),
                })
        return fl.RecordBatchStream(table)

    # -- control -------------------------------------------------------
    def do_action(self, context, action):
        if action.type == "flush":
            with self._lock:
                n = self._flush_locked()
                # total read INSIDE the lock: a concurrent auto-flush
                # between release and read made the reply a snapshot
                # that never existed
                body = {"ok": True, "ingested": n,
                        "total": self._ingested}
        elif action.type == "stats":
            with self._lock:
                self._flush_locked()
                body = {"ok": True, **self.session.stats(),
                        "server_ingested": self._ingested}
        elif action.type == "stop":
            with self._lock:
                self._flush_locked()
            body = {"ok": True}
            threading.Thread(target=self.shutdown, daemon=True).start()
        else:
            raise fl.FlightServerError(f"unknown action {action.type!r}")
        yield fl.Result(json.dumps(body).encode())

    def list_actions(self, context):
        return [("flush", "flush buffered ticks to the device ring"),
                ("stats", "session statistics (JSON)"),
                ("stop", "flush and shut the server down")]

    def list_flights(self, context, criteria):
        for name in ("refit", "surfaces"):
            desc = fl.FlightDescriptor.for_path(name)
            yield fl.FlightInfo(pa.schema([]), desc,
                                [fl.FlightEndpoint(name, [self._location])])


# ---------------------------------------------------------------------
# client helpers (tests + operator tooling)
# ---------------------------------------------------------------------

def put_ticks(client, underlying, minute, price, size) -> None:
    """Upload one columnar tick batch over an open FlightClient."""
    _require_flight()
    batch = pa.record_batch({
        "underlying": pa.array(underlying),
        "minute": pa.array(np.asarray(minute, np.int32)),
        "price": pa.array(np.asarray(price, np.float32)),
        "size": pa.array(np.asarray(size, np.float32)),
    })
    writer, _ = client.do_put(
        fl.FlightDescriptor.for_path("ticks"), batch.schema)
    writer.write_batch(batch)
    writer.close()


def action_json(client, name: str) -> dict:
    """Run a named action and decode its JSON reply."""
    _require_flight()
    results = list(client.do_action(fl.Action(name, b"")))
    return json.loads(results[0].body.to_pybytes())


def run_serve_flight(config, store, port: int = 8815,
                     n_underlyings: int = 64,
                     blocking: bool = True) -> "FlightStreamServer":
    """CLI entry (``--task serve --serve-transport flight``): same
    session bootstrap as the JSONL server, Flight transport in front."""
    _require_flight()
    from iv_engine.pipeline.serve import build_session
    session, unds = build_session(config, store,
                                  n_underlyings=n_underlyings)
    server = FlightStreamServer(session, port=port)
    print(f"serving {len(unds)} underlyings on grpc+tcp://127.0.0.1:"
          f"{server.port} (Arrow Flight; do_action('stop') to exit)",
          flush=True)
    if blocking:
        server.serve()
    return server
