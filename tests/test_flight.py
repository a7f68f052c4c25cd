"""Arrow Flight serving transport: columnar ingest + refit end-to-end.

Same StreamingSession as the JSONL server (tests/test_serve.py); here
ticks travel as RecordBatches over gRPC and results come back as Arrow
tables."""

import numpy as np
import pytest

from iv_engine.pipeline import flight_service as fs
from iv_engine.pipeline.stream_service import StreamingSession

pytestmark = pytest.mark.skipif(
    not fs.HAVE_FLIGHT, reason="pyarrow.flight unavailable")


@pytest.fixture
def server():
    import jax.numpy as jnp
    unds = ["btc", "eth"]
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, 10), (2, 3, 10))
    T = jnp.broadcast_to(jnp.array([0.1, 0.5, 1.0]), (2, 3))
    iv = 0.5 + 0.05 * k**2
    sess = StreamingSession(unds, k, iv, T, window_minutes=128,
                            tick_capacity=1024, n_grid=10)
    srv = fs.FlightStreamServer(sess, port=0)
    yield srv
    srv.shutdown()


def _tick_cols(rng, und, n, lo=0, hi=128):
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)
    minutes = np.sort(rng.integers(lo, hi, n))
    prices = 100 * np.exp(np.cumsum(rng.normal(0, per_min, n)))
    return ([und] * n, minutes, prices, np.ones(n, np.float32))


@pytest.mark.slow
def test_flight_put_refit_surfaces(server, rng):
    import pyarrow.flight as fl
    client = fl.connect(f"grpc+tcp://127.0.0.1:{server.port}")

    u1, m1, p1, s1 = _tick_cols(rng, "btc", 300)
    u2, m2, p2, s2 = _tick_cols(rng, "eth", 300)
    fs.put_ticks(client, u1 + u2, np.concatenate([m1, m2]),
                 np.concatenate([p1, p2]), np.concatenate([s1, s2]))

    flushed = fs.action_json(client, "flush")
    assert flushed["ok"] and flushed["total"] == 600
    stats = fs.action_json(client, "stats")
    assert stats["ticks_seen"] == 600

    table = client.do_get(fl.Ticket(b"refit")).read_all()
    row = {c: table.column(c).to_pylist() for c in table.column_names}
    assert row["underlying"] == ["btc", "eth"]
    assert 0.05 < row["realized_vol"][0] < 2.0
    assert all(row["butterfly_ok"]) and all(row["calendar_ok"])
    assert 0.4 < row["atm_iv"][0] < 0.7

    surf = client.do_get(fl.Ticket(b"surfaces")).read_all()
    assert surf.num_rows == 2 * 3                      # B underlyings x E
    iv0 = np.asarray(surf.column("iv").to_pylist()[0], np.float32)
    assert iv0.shape == (10,) and np.isfinite(iv0).all() and (iv0 > 0).all()

    with pytest.raises(fl.FlightServerError):
        client.do_get(fl.Ticket(b"nonsense")).read_all()
    with pytest.raises(fl.FlightServerError):
        list(client.do_action(fl.Action("nonsense", b"")))
    client.close()


def test_flight_matches_jsonl_transport(server, rng):
    """The two transports are fronts over the same session semantics:
    identical ticks give identical refit numbers."""
    import pyarrow.flight as fl

    from iv_engine.pipeline.serve import StreamServer, send_lines

    u, m, p, s = _tick_cols(rng, "btc", 200)

    client = fl.connect(f"grpc+tcp://127.0.0.1:{server.port}")
    fs.put_ticks(client, u, m, p, s)
    fs.action_json(client, "flush")
    table = client.do_get(fl.Ticket(b"refit")).read_all()
    flight_rv = table.column("realized_vol").to_pylist()[0]
    client.close()

    import jax.numpy as jnp
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, 10), (2, 3, 10))
    T = jnp.broadcast_to(jnp.array([0.1, 0.5, 1.0]), (2, 3))
    sess2 = StreamingSession(["btc", "eth"], k, 0.5 + 0.05 * k**2, T,
                             window_minutes=128, tick_capacity=1024,
                             n_grid=10)
    srv2 = StreamServer(sess2)
    srv2.start()
    try:
        lines = [{"underlying": uu, "minute": int(mm), "price": float(pp),
                  "size": 1.0} for uu, mm, pp in zip(u, m, p)]
        (reply,) = send_lines("127.0.0.1", srv2.port,
                              lines + [{"cmd": "refit"}])
    finally:
        srv2.stop()
    assert np.isclose(reply["realized_vol"]["btc"], flight_rv, atol=1e-6)


@pytest.mark.slow
def test_flight_robustness_review_fixes(server, rng):
    """Round-3 review findings: mixed-schema batches must not poison
    the buffer (float32 then float64 price), a column-missing batch
    errors on the OFFENDING put, unknown tickets fail fast, and
    list_flights advertises the RESOLVED port (not ':0')."""
    import pyarrow as pa
    import pyarrow.flight as fl
    client = fl.connect(f"grpc+tcp://127.0.0.1:{server.port}")

    u, m, p, s = _tick_cols(rng, "btc", 50)
    fs.put_ticks(client, u, m, p, s)                   # float32 price
    batch64 = pa.record_batch({
        "underlying": pa.array(["eth"] * 50),
        "minute": pa.array(np.arange(50, dtype=np.int32)),
        "price": pa.array(np.full(50, 100.0)),         # float64 price
        "size": pa.array(np.ones(50)),
    })
    writer, _ = client.do_put(fl.FlightDescriptor.for_path("ticks"),
                              batch64.schema)
    writer.write_batch(batch64)
    writer.close()
    flushed = fs.action_json(client, "flush")          # must not raise
    assert flushed["ok"] and flushed["total"] == 100

    # missing 'size' errors on THIS put, buffer stays clean
    bad = pa.record_batch({
        "underlying": pa.array(["btc"]),
        "minute": pa.array(np.array([1], np.int32)),
        "price": pa.array(np.array([100.0], np.float32)),
    })
    with pytest.raises(fl.FlightError, match="missing columns"):
        w, _ = client.do_put(fl.FlightDescriptor.for_path("ticks"),
                             bad.schema)
        w.write_batch(bad)
        w.close()
    assert fs.action_json(client, "stats")["ok"]       # server healthy

    # unknown ticket fails fast (no refit under the lock first)
    with pytest.raises(fl.FlightError, match="unknown ticket"):
        client.do_get(fl.Ticket(b"refits")).read_all()

    # advertised endpoints carry the real bound port
    infos = list(client.list_flights())
    locs = [str(loc) for info in infos for ep in info.endpoints
            for loc in ep.locations]
    assert locs and all(str(server.port) in loc for loc in locs)
    client.close()
