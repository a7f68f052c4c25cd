"""Streaming session: incremental tick ingestion + windowed refits."""

import numpy as np
import pandas as pd
import pytest

from iv_engine.pipeline.stream_service import StreamingSession


def _chains(B, E=4, n=10):
    import jax.numpy as jnp
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E), (B, E))
    iv = 0.5 + 0.05 * k**2
    return k, iv, T


def _tick_frame(rng, unds, minute_lo, minute_hi, n, sigma_annual=0.5):
    per_min = sigma_annual / np.sqrt(365.25 * 24 * 60)
    frames = []
    for u in unds:
        minutes = np.sort(rng.integers(minute_lo, minute_hi, n))
        path = 100 * np.exp(np.cumsum(rng.normal(0, per_min, n)))
        frames.append(pd.DataFrame({
            "underlying": u, "minute": minutes,
            "price": path, "size": rng.uniform(0, 5, n)}))
    return pd.concat(frames, ignore_index=True)


@pytest.fixture
def session(rng):
    unds = ["btc", "eth", "sol"]
    k, iv, T = _chains(3)
    return StreamingSession(unds, k, iv, T, window_minutes=256,
                            tick_capacity=4096, n_grid=16)


@pytest.mark.slow
def test_ingest_and_refit(session, rng):
    n = session.ingest_ticks(_tick_frame(rng, session.underlyings, 0, 256,
                                         1500))
    assert n == 4500
    out = session.refit()
    assert out.iv_grid.shape == (3, 4, 16)
    assert np.isfinite(np.asarray(out.realized_vol)).all()
    assert np.asarray(out.butterfly_ok).all()
    s = session.stats()
    assert s["ticks_seen"] == 4500 and s["underlyings"] == 3


def test_window_slides_with_time(session, rng):
    session.ingest_ticks(_tick_frame(rng, ["btc"], 0, 100, 500))
    out_now = session.refit(now_minute=100)
    # a refit far in the future sees no ticks in window -> realized vol 0
    out_later = session.refit(now_minute=10_000)
    assert float(np.asarray(out_later.realized_vol)[0]) == 0.0
    assert float(np.asarray(out_now.realized_vol)[0]) > 0.0


def test_unknown_underlyings_dropped(session, rng):
    df = _tick_frame(rng, ["doge"], 0, 50, 100)
    assert session.ingest_ticks(df) == 0


def test_incremental_ingest_accumulates(session, rng):
    for lo in (0, 64, 128, 192):
        session.ingest_ticks(_tick_frame(rng, session.underlyings,
                                         lo, lo + 64, 200))
    out = session.refit(now_minute=255)
    # all four chunks are inside the 256-minute window
    c1 = np.asarray(out.candles_1m.valid).sum()
    assert c1 > 3 * 200  # plenty of populated minute bars across 3 unds


@pytest.mark.slow
def test_stream_replay(rng):
    from iv_engine.config import get_config
    from iv_engine.pipeline.stream_service import run_stream_replay
    cfg = get_config("testing")
    cfg.surface.grid_strikes = 12
    rep = run_stream_replay(cfg, n_underlyings=8, window_minutes=128,
                            chunks=4, ticks_per_chunk=100)
    assert rep["ticks_ingested"] == 8 * 4 * 100
    assert rep["butterfly_ok"] == 8
    assert 0.1 < rep["realized_vol_mean"] < 1.5


@pytest.mark.slow
def test_session_handles_out_of_order_ticks(rng):
    """Late ticks (earlier minutes arriving after newer ones) must land
    in their own buckets — the refit sorts the window before
    aggregation (code-review finding: the sorted-path aggregation would
    otherwise silently re-bucket them into the running-max bucket)."""
    import jax.numpy as jnp
    import pandas as pd
    from iv_engine.pipeline.stream_service import StreamingSession

    B, E, n = 2, 3, 10
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E), (B, E))
    iv = 0.4 + 0.05 * k * k
    unds = ["a", "b"]

    def run(order):
        sess = StreamingSession(unds, k, iv, T, window_minutes=64,
                                tick_capacity=256, n_grid=9)
        frames = []
        for u in unds:
            minutes = np.arange(0, 60)
            prices = 100 + 0.1 * minutes
            mm, pp = minutes[order], prices[order]
            frames.append(pd.DataFrame({
                "underlying": u, "minute": mm, "price": pp,
                "size": np.ones_like(pp)}))
        sess.ingest_ticks(pd.concat(frames, ignore_index=True))
        return sess.refit(now_minute=63)

    fwd = run(np.arange(60))
    perm = rng.permutation(60)  # fully shuffled arrival
    shuf = run(perm)
    # bucket contents are order-independent up to within-minute ties
    # (one tick per minute here, so candles must match exactly)
    np.testing.assert_array_equal(np.asarray(fwd.candles_1m.valid),
                                  np.asarray(shuf.candles_1m.valid))
    np.testing.assert_allclose(np.asarray(fwd.candles_1m.close),
                               np.asarray(shuf.candles_1m.close))
    np.testing.assert_allclose(np.asarray(fwd.realized_vol),
                               np.asarray(shuf.realized_vol))


def test_session_mesh_parity(rng):
    """A StreamingSession with its rings/chains sharded over the mesh
    produces bitwise the refit of an unsharded session on the same
    ticks (round 4: the serving path rides the pipeline mesh too)."""
    import jax
    from iv_engine.parallel.mesh import pipeline_mesh

    B = 16
    unds = [f"u{i}" for i in range(B)]
    k, iv, T = _chains(B)
    ticks = _tick_frame(rng, unds, 0, 200, 64)
    outs = {}
    for mesh in (None, pipeline_mesh((8,))):
        sess = StreamingSession(unds, k, iv, T, window_minutes=256,
                                tick_capacity=1024, n_grid=16, mesh=mesh)
        if mesh is not None:
            assert len(sess.ring.data.sharding.device_set) == 8
        sess.ingest_ticks(ticks)
        outs[mesh is None] = jax.tree.map(np.asarray, sess.refit())
    for a, b in zip(jax.tree.leaves(outs[True]),
                    jax.tree.leaves(outs[False])):
        np.testing.assert_array_equal(a, b)
