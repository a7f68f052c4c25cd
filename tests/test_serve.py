"""Streaming serving daemon: socket protocol end-to-end."""

import numpy as np
import pytest

from iv_engine.pipeline.serve import StreamServer, send_lines
from iv_engine.pipeline.stream_service import StreamingSession


@pytest.fixture
def server(rng):
    import jax.numpy as jnp
    unds = ["btc", "eth"]
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, 10), (2, 3, 10))
    T = jnp.broadcast_to(jnp.array([0.1, 0.5, 1.0]), (2, 3))
    iv = 0.5 + 0.05 * k**2
    sess = StreamingSession(unds, k, iv, T, window_minutes=128,
                            tick_capacity=1024, n_grid=10)
    srv = StreamServer(sess, flush_every=50)
    srv.start()
    yield srv
    srv.stop()


def _ticks(rng, und, n, lo=0, hi=128):
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)
    minutes = np.sort(rng.integers(lo, hi, n))
    prices = 100 * np.exp(np.cumsum(rng.normal(0, per_min, n)))
    return [{"underlying": und, "minute": int(m), "price": float(p),
             "size": 1.0} for m, p in zip(minutes, prices)]


@pytest.mark.slow
def test_ingest_flush_refit(server, rng):
    lines = _ticks(rng, "btc", 300) + _ticks(rng, "eth", 300)
    replies = send_lines("127.0.0.1", server.port,
                         lines + [{"cmd": "flush"}, {"cmd": "refit"},
                                  {"cmd": "stats"}])
    flush, refit, stats = replies
    assert flush["ok"] and flush["total"] == 600
    assert refit["ok"]
    assert set(refit["realized_vol"]) == {"btc", "eth"}
    assert 0.05 < refit["realized_vol"]["btc"] < 2.0
    assert refit["butterfly_ok"]["btc"] and refit["butterfly_ok"]["eth"]
    assert 0.4 < refit["atm_iv"]["btc"] < 0.7
    assert stats["ticks_seen"] == 600


def test_bad_json_and_unknown_cmd(server):
    import socket
    with socket.create_connection(("127.0.0.1", server.port)) as sock:
        f = sock.makefile("rwb")
        f.write(b"not json\n")
        f.flush()
        import json
        assert json.loads(f.readline())["ok"] is False
        f.write(b'{"cmd": "nonsense"}\n')
        f.flush()
        reply = json.loads(f.readline())
        assert reply["ok"] is False and "unknown" in reply["error"]


def test_non_dict_json_and_malformed_ticks(server, rng):
    """Round-4 review regressions: a JSON scalar line ('5') must get an
    error reply instead of killing the handler thread with a TypeError,
    and a tick missing required numeric fields must be rejected at the
    boundary (counted in replies) instead of buffering and blowing up a
    later flush — which used to discard every other client's ticks."""
    import json
    import socket
    with socket.create_connection(("127.0.0.1", server.port)) as sock:
        f = sock.makefile("rwb")
        f.write(b"5\n")
        f.flush()
        reply = json.loads(f.readline())
        assert reply["ok"] is False and "object" in reply["error"]
        # connection still alive: a command round-trips
        f.write(b'{"cmd": "stats"}\n')
        f.flush()
        assert json.loads(f.readline())["ok"] is True

    good = _ticks(rng, "btc", 10)
    bad = [{"underlying": "btc", "minute": "noon", "price": 1.0,
            "size": 1.0},
           {"underlying": 7, "minute": 1, "price": 1.0, "size": 1.0},
           {"underlying": "btc", "price": 1.0, "size": 1.0}]
    replies = send_lines("127.0.0.1", server.port,
                         good + bad + [{"cmd": "flush"}])
    assert replies[0]["ok"] and replies[0]["ingested"] == 10
    assert replies[0]["rejected"] == 3


def test_auto_flush_threshold(server, rng):
    """120 ticks with flush_every=50 auto-ingest 100 before the final
    command; stats on the SAME connection (ordering across connections is
    not guaranteed) accounts for all 120."""
    replies = send_lines("127.0.0.1", server.port,
                         _ticks(rng, "btc", 120) + [{"cmd": "stats"}])
    assert replies[0]["ticks_seen"] == 120
    assert replies[0]["server_ingested"] == 120


@pytest.mark.slow
def test_run_serve_from_store(rng):
    """run_serve builds the universe from fitted chains and serves; a
    client streams ticks and refits over the socket."""
    from iv_engine.config import get_config
    from iv_engine.pipeline import MemoryStore, PipelineRunner
    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.sample_data import (
        generate_sample_tickers)
    from iv_engine.pipeline.serve import run_serve

    cfg = get_config("testing")
    cfg.surface.grid_strikes = 10
    cfg.interpolation.min_data_points = 5
    store = MemoryStore()
    store.write(st.TICKERS, generate_sample_tickers(num_symbols=60, hours=8))
    import tempfile
    cfg.checkpoint.manifest_dir = tempfile.mkdtemp()
    PipelineRunner(cfg, store=store).run_task1()

    server = run_serve(cfg, store, port=0, blocking=False)
    try:
        # the universe came from the store's interpolated chains
        assert server.session.underlyings == ["btc"]
        ticks = _ticks(rng, "btc", 200)
        replies = send_lines("127.0.0.1", server.port,
                             ticks + [{"cmd": "refit"}])
        assert replies[0]["ok"]
        assert "btc" in replies[0]["atm_iv"]
        assert replies[0]["atm_iv"]["btc"] > 0
    finally:
        server.stop()
