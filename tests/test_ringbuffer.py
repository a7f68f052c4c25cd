"""Device-resident ring buffer: wraparound, chronological reads, candle
aggregation off the window."""

import jax.numpy as jnp
import numpy as np

from iv_engine.pipeline.ringbuffer import (
    make_ring,
    push,
    window,
    window_candles,
)


def test_push_and_window_before_wrap(rng):
    B, C, L, K = 2, 3, 16, 5
    ring = make_ring(B, C, L)
    rows = jnp.asarray(rng.normal(size=(B, C, K)).astype(np.float32))
    ring = push(ring, rows, jnp.ones((B, K), bool))
    data, valid = window(ring)
    np.testing.assert_array_equal(np.asarray(valid[:, :K]), True)
    np.testing.assert_array_equal(np.asarray(valid[:, K:]), False)
    np.testing.assert_allclose(np.asarray(data[:, :, :K]),
                               np.asarray(rows))


def test_wraparound_keeps_chronological_order(rng):
    B, C, L, K = 1, 1, 8, 3
    ring = make_ring(B, C, L)
    chunks = [np.full((B, C, K), float(i), np.float32) for i in range(4)]
    for ch in chunks:
        ring = push(ring, jnp.asarray(ch), jnp.ones((B, K), bool))
    # pushed 12 rows into an 8-slot ring: window = rows 4..11
    data, valid = window(ring)
    assert bool(valid.all())
    expected = np.concatenate([np.full(K, float(i)) for i in range(4)])[-8:]
    np.testing.assert_allclose(np.asarray(data[0, 0]), expected)


def test_window_candles(rng):
    B, C, L = 2, 5, 30
    ring = make_ring(B, C, L)
    close = 100 + rng.normal(size=(B, L)).astype(np.float32)
    rows = np.stack([close, close + 1, close - 1, close,
                     np.abs(close) * 0 + 2.0], axis=1)
    ring = push(ring, jnp.asarray(rows), jnp.ones((B, L), bool))
    candles = window_candles(ring, jnp.int32(0), bucket_minutes=5,
                             num_segments=7, min_count=5)
    assert int(candles.valid.sum()) == 2 * 6  # 30 minutes -> 6 full buckets
    np.testing.assert_allclose(np.asarray(candles.volume)[:, :6], 10.0)
    np.testing.assert_allclose(
        np.asarray(candles.open[0, 0]), rows[0, 0, 0])
    np.testing.assert_allclose(
        np.asarray(candles.close[0, 0]), rows[0, 3, 4])


def test_donation_streaming_loop(rng):
    """Many pushes in a loop — exercises the donated-buffer update path."""
    B, C, L, K = 4, 5, 64, 8
    ring = make_ring(B, C, L)
    total = 0
    for i in range(20):
        rows = jnp.asarray(rng.normal(size=(B, C, K)).astype(np.float32))
        ring = push(ring, rows, jnp.ones((B, K), bool))
        total += K
    np.testing.assert_array_equal(np.asarray(ring.count), total)
    np.testing.assert_array_equal(np.asarray(ring.cursor), total % L)
    _, valid = window(ring)
    assert bool(valid.all())


def test_push_larger_than_capacity(rng):
    B, C, L = 2, 3, 8
    ring = make_ring(B, C, L)
    K = 20
    rows = np.arange(B * C * K, dtype=np.float32).reshape(B, C, K)
    import jax.numpy as jnp
    ring = push(ring, jnp.asarray(rows), jnp.ones((B, K), bool))
    np.testing.assert_array_equal(np.asarray(ring.count), K)
    data, valid = window(ring)
    assert bool(valid.all())
    # window holds the NEWEST 8 rows in order
    np.testing.assert_allclose(np.asarray(data[0, 0]), rows[0, 0, -8:])


def test_sparse_stream_keeps_history_under_padded_pushes(rng):
    """Padded multi-stream pushes must not erode a sparse stream's window:
    stream 1 gets 1 real tick per push while stream 0 gets 8, and after
    many pushes stream 1 still holds its full history (ADVICE r1: the old
    shared cursor overwrote sparse streams' valid slots with padding)."""
    B, C, L, K = 2, 1, 32, 8
    ring = make_ring(B, C, L)
    for i in range(4):
        rows = np.zeros((B, C, K), np.float32)
        valid = np.zeros((B, K), bool)
        rows[0, 0] = np.arange(K) + 100 * i
        valid[0] = True
        rows[1, 0, 0] = float(i)   # one real tick, rest is padding
        valid[1, 0] = True
        ring = push(ring, jnp.asarray(rows), jnp.asarray(valid))
    data, valid = window(ring)
    # stream 1 pushed 4 ticks total; all 4 must be present, in order
    assert int(valid[1].sum()) == 4
    np.testing.assert_allclose(np.asarray(data[1, 0, :4]),
                               np.arange(4, dtype=np.float32))
    # stream 0's 32 ticks fill its ring exactly
    assert int(valid[0].sum()) == 32
    np.testing.assert_array_equal(np.asarray(ring.count), [32, 4])
    np.testing.assert_array_equal(np.asarray(ring.cursor), [0, 4])


def test_ragged_push_compacts_mid_block_padding(rng):
    """Validity holes inside a push block are compacted away — ticks keep
    their relative order and land contiguously at the stream's cursor."""
    B, C, L, K = 1, 2, 16, 6
    ring = make_ring(B, C, L)
    rows = np.zeros((B, C, K), np.float32)
    rows[0, 0] = [1, -9, 2, -9, 3, -9]
    rows[0, 1] = [10, -9, 20, -9, 30, -9]
    valid = np.asarray([[True, False, True, False, True, False]])
    ring = push(ring, jnp.asarray(rows), jnp.asarray(valid))
    data, v = window(ring)
    assert int(v.sum()) == 3
    np.testing.assert_allclose(np.asarray(data[0, 0, :3]), [1, 2, 3])
    np.testing.assert_allclose(np.asarray(data[0, 1, :3]), [10, 20, 30])


def test_window_candles_wrapped_and_ragged_counts(rng):
    """Per-stream window-start minutes: t0 is each stream's FIRST-push
    minute and the window start derives from count, so a wrapped ring
    and a partially-filled ring in one batch both label their slots
    correctly (round-4 review: one scalar window-start shifted every
    stream whose ring wrapped a different amount)."""
    B, C, L = 2, 5, 30
    ring = make_ring(B, C, L)
    # stream 0: 40 pushes (wraps; window = minutes 10..39)
    # stream 1: 30 pushes (no wrap; window = minutes 0..29)
    for i in range(40):
        rows = np.zeros((B, C, 1), np.float32)
        valid = np.zeros((B, 1), bool)
        rows[0, :, 0] = [100.0 + i, 101.0 + i, 99.0 + i, 100.0 + i, 2.0]
        valid[0, 0] = True
        if i < 30:
            rows[1, :, 0] = [200.0 + i, 201.0 + i, 199.0 + i,
                             200.0 + i, 3.0]
            valid[1, 0] = True
        ring = push(ring, jnp.asarray(rows), jnp.asarray(valid))
    candles = window_candles(ring, jnp.int32(0), bucket_minutes=5,
                             num_segments=9, min_count=5)
    # stream 0's first bucket = minutes 10..14 -> open 110, close 114
    np.testing.assert_allclose(np.asarray(candles.open[0, 0]), 110.0)
    np.testing.assert_allclose(np.asarray(candles.close[0, 0]), 114.0)
    # stream 1's first bucket = minutes 0..4 -> open 200, close 204
    np.testing.assert_allclose(np.asarray(candles.open[1, 0]), 200.0)
    np.testing.assert_allclose(np.asarray(candles.close[1, 0]), 204.0)
    assert int(candles.valid[0].sum()) == 6
    assert int(candles.valid[1].sum()) == 6
