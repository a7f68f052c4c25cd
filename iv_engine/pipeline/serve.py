"""Streaming serving daemon: a line-protocol tick feed in front of
:class:`~iv_engine.pipeline.stream_service.StreamingSession`.

Completes the serving story (ROADMAP #7): clients stream JSON lines over
TCP (localhost) — ticks buffer host-side and flush to the device tick
ring in batches; ``refit`` returns the fused candle->realized-vol->surface
result for every underlying as JSON.

Protocol (newline-delimited JSON, one object per line):
  {"underlying": "btc", "minute": 123, "price": 25001.5, "size": 0.2}
  {"cmd": "flush"}                  -> {"ok": true, "ingested": N}
  {"cmd": "refit"}                  -> {"ok": true, "realized_vol": {...},
                                        "butterfly_ok": {...}, "atm_iv": {...}}
  {"cmd": "stats"}                  -> {"ok": true, ...session stats}
  {"cmd": "stop"}                   -> {"ok": true} and server shutdown

Single-writer by design (one device session); multiple clients may
connect, requests are serialised by a lock — the same structural
race-freedom argument as the pipeline (COMPONENTS.md §5.2).
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

import numpy as np


class StreamServer:
    def __init__(self, session, host: str = "127.0.0.1", port: int = 0,
                 flush_every: int = 10_000):
        """``port=0`` picks a free port (see ``.port`` after start)."""
        self.session = session
        self.flush_every = flush_every
        self._buffer: list = []
        self._lock = threading.Lock()
        self._ingested = 0
        self._rejected = 0

        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                for raw in self.rfile:
                    try:
                        msg = json.loads(raw)
                    except json.JSONDecodeError:
                        self._reply({"ok": False, "error": "bad json"})
                        continue
                    if not isinstance(msg, dict):
                        # valid JSON scalar/array ('5\n') used to
                        # TypeError on '"cmd" in msg' and kill the
                        # handler thread with no reply (round-4 review)
                        self._reply({"ok": False,
                                     "error": "message must be an object"})
                        continue
                    if "cmd" in msg:
                        reply = outer._command(msg["cmd"])
                        self._reply(reply)
                        if msg["cmd"] == "stop":
                            threading.Thread(
                                target=outer._server.shutdown,
                                daemon=True).start()
                            return
                    else:
                        outer._tick(msg)

            def _reply(self, obj):
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    _TICK_FIELDS = ("minute", "price", "size")

    def _tick(self, msg: dict) -> None:
        # boundary validation (same reasoning as the Flight transport's
        # do_put): a malformed tick must not buffer fine and then blow
        # up a LATER flush — possibly triggered by another client's
        # command. Ticks get no reply by protocol, so rejects are
        # counted and surfaced in flush/stats replies.
        if not isinstance(msg.get("underlying"), str) or not all(
                isinstance(msg.get(f), (int, float))
                and not isinstance(msg.get(f), bool)
                for f in self._TICK_FIELDS):
            with self._lock:
                self._rejected += 1
            return
        with self._lock:
            self._buffer.append(msg)
            if len(self._buffer) >= self.flush_every:
                self._flush_locked()

    def _flush_locked(self) -> int:
        if not self._buffer:
            return 0
        import pandas as pd
        df = pd.DataFrame(self._buffer)
        n = self.session.ingest_ticks(df)
        # clear ONLY after a successful ingest: clearing first lost
        # every buffered client's ticks when ingest raised (round-4
        # review). ingest_ticks is all-or-nothing (one device update).
        self._buffer = []
        self._ingested += n
        return n

    def _command(self, cmd: str) -> dict:
        try:
            return self._command_locked(cmd)
        except Exception as e:  # noqa: BLE001 — reply, don't kill the thread
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _command_locked(self, cmd: str) -> dict:
        with self._lock:
            if cmd == "flush":
                return {"ok": True, "ingested": self._flush_locked(),
                        "total": self._ingested,
                        "rejected": self._rejected}
            if cmd == "stats":
                self._flush_locked()
                return {"ok": True, **self.session.stats(),
                        "server_ingested": self._ingested,
                        "rejected": self._rejected}
            if cmd == "refit":
                self._flush_locked()
                out = self.session.refit()
                unds = self.session.underlyings
                rv = np.asarray(out.realized_vol)
                bok = np.asarray(out.butterfly_ok)
                m = out.iv_grid.shape[-1]
                atm = np.asarray(out.iv_grid[:, 0, m // 2])
                return {
                    "ok": True,
                    "realized_vol": {u: round(float(rv[i]), 6)
                                     for i, u in enumerate(unds)},
                    "butterfly_ok": {u: bool(bok[i])
                                     for i, u in enumerate(unds)},
                    "atm_iv": {u: round(float(atm[i]), 6)
                               for i, u in enumerate(unds)},
                }
            if cmd == "stop":
                self._flush_locked()
                return {"ok": True}
            return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        """Blocking serve (CLI mode); returns after a 'stop' command."""
        self._server.serve_forever()
        self._server.server_close()


def send_lines(host: str, port: int, lines) -> list:
    """Test/client helper: send JSON objects, return JSON replies (only
    commands produce replies)."""
    replies = []
    with socket.create_connection((host, port)) as sock:
        f = sock.makefile("rwb")
        for obj in lines:
            f.write((json.dumps(obj) + "\n").encode())
            f.flush()
            if "cmd" in obj:
                replies.append(json.loads(f.readline()))
    return replies


def build_session(config, store, n_underlyings: int = 64):
    """Build the serving :class:`StreamingSession` from the store's
    fitted chains when available (surface_task.build_chains over
    interpolated data), else a synthetic universe. Shared by the JSONL
    and Arrow Flight transports. Returns ``(session, underlyings)``."""
    import jax.numpy as jnp

    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.surface_task import (build_chains,
                                                 pack_chain_group)

    chains = []
    df = store.read(st.INTERPOLATED)
    if not df.empty:
        chains = build_chains(df)
    if chains:
        by_und = {}
        for c in chains:
            by_und.setdefault(c["underlying"], []).append(c)
        unds = sorted(by_und)
        E = max(len(v) for v in by_und.values())
        n = max(len(c["k"]) for c in chains)
        group = [(u, sorted(by_und[u], key=lambda c: c["T"]))
                 for u in unds]
        k, iv, T, _, _ = pack_chain_group(group, E, n, dtype=np.float32)
    else:
        unds = [f"u{i:04d}" for i in range(n_underlyings)]
        E, n = 4, 12
        k = np.broadcast_to(np.linspace(-0.8, 0.8, n, dtype=np.float32),
                            (len(unds), E, n)).copy()
        T = np.broadcast_to(np.linspace(0.1, 1.0, E, dtype=np.float32),
                            (len(unds), E)).copy()
        iv = (0.5 + 0.05 * k * k).astype(np.float32)

    from iv_engine.parallel.mesh import pipeline_mesh
    from iv_engine.pipeline.stream_service import StreamingSession
    session = StreamingSession(unds, jnp.asarray(k), jnp.asarray(iv),
                               jnp.asarray(T),
                               n_grid=config.surface.grid_strikes,
                               mesh=pipeline_mesh(
                                   config.processing.mesh_shape,
                                   config.processing.mesh_axis_names))
    return session, unds


def run_serve(config, store, port: int = 8787,
              n_underlyings: int = 64,
              blocking: bool = True) -> "StreamServer":
    """CLI entry: serve the session over newline-delimited JSON on
    localhost:port (blocking unless told otherwise)."""
    session, unds = build_session(config, store,
                                  n_underlyings=n_underlyings)
    server = StreamServer(session, port=port)
    print(f"serving {len(unds)} underlyings on 127.0.0.1:{server.port} "
          f"(JSONL protocol; send {{\"cmd\": \"stop\"}} to exit)",
          flush=True)
    if blocking:
        server.serve_forever()
    else:
        server.start()
    return server
