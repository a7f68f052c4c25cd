"""Device-resident ring buffers for streaming market-data windows.

North-star requirement (BASELINE.json): "segment-reduction kernels
writing device-resident ring buffers, eliminating the data_bridge/
database round-trips on the hot path". The reference's hot path wrote
every intermediate row to PostgreSQL (SURVEY.md §3.5); here the rolling
window of candles lives in device memory and is updated in place — ``push`` is a
jit with donated buffers, so XLA reuses the same memory every step and
the host only ever sees the aggregates it asks for.

Layout: (B, C, L) ring with a **per-stream** cursor. Ingest blocks are
padded to the per-call max tick count, so streams receive ragged valid
runs; each stream compacts its valid ticks and advances its own cursor
by its own count — a sparse stream's older ticks are never overwritten
by another stream's padding (ADVICE r1). Reads return each stream's
window in its own chronological order.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class RingState(NamedTuple):
    data: jax.Array     # (B, C, L) rolling window
    valid: jax.Array    # (B, L) slot has real data
    cursor: jax.Array   # (B,) int32 — next write slot per stream
    count: jax.Array    # (B,) int32 — total ticks ever pushed per stream


def make_ring(batch: int, channels: int, length: int,
              dtype=jnp.float32) -> RingState:
    return RingState(
        data=jnp.full((batch, channels, length), jnp.nan, dtype),
        valid=jnp.zeros((batch, length), bool),
        cursor=jnp.zeros((batch,), jnp.int32),
        count=jnp.zeros((batch,), jnp.int32),
    )


def _push_row(data, valid, cursor, count, rows, rows_valid):
    """One stream's push: compact the valid ticks of (C, K) ``rows`` to a
    prefix, keep the newest <= L, scatter at this stream's cursor."""
    C, L = data.shape
    K = rows.shape[-1]
    n = jnp.sum(rows_valid.astype(jnp.int32))
    # order-preserving compaction: valid tick j lands at rank cumsum-1;
    # padding scatters out of bounds and is dropped
    rank = jnp.cumsum(rows_valid.astype(jnp.int32)) - 1
    tgt = jnp.where(rows_valid, rank, K)
    staged = jnp.zeros_like(rows).at[:, tgt].set(rows, mode="drop")
    # only the newest L compacted ticks can survive; truncating keeps the
    # scatter free of duplicate slot writes (whose order is unspecified)
    out_k = min(K, L)
    drop = jnp.maximum(n - out_k, 0)
    take = jnp.arange(out_k) + drop
    gathered = staged[:, jnp.clip(take, 0, max(K - 1, 0))]
    g_valid = jnp.arange(out_k) < (n - drop)
    idx = (cursor + jnp.arange(out_k)) % L
    data = data.at[:, idx].set(
        jnp.where(g_valid[None, :], gathered, data[:, idx]))
    valid = valid.at[idx].set(jnp.where(g_valid, True, valid[idx]))
    return data, valid, (cursor + n - drop) % L, count + n


@partial(jax.jit, donate_argnums=(0,))
def push(state: RingState, rows: jax.Array,
         rows_valid: jax.Array) -> RingState:
    """Append ``rows`` (B, C, K) with validity (B, K), each stream at its
    own cursor, wrapping modulo L.

    The state is donated: XLA updates the device buffers in place, so a
    streaming loop allocates nothing per step.
    """
    data, valid, cursor, count = jax.vmap(_push_row)(
        state.data, state.valid, state.cursor, state.count,
        rows, rows_valid)
    return RingState(data=data, valid=valid, cursor=cursor, count=count)


def _window_row(data, valid, cursor, count):
    L = valid.shape[-1]
    start = jnp.where(count >= L, cursor, 0)
    idx = (start + jnp.arange(L)) % L
    return data[:, idx], valid[idx]


@jax.jit
def window(state: RingState):
    """Each stream's ring contents in chronological order: (data, valid)
    with the oldest slot first. Slots never written stay NaN/False."""
    return jax.vmap(_window_row)(state.data, state.valid,
                                 state.cursor, state.count)


@partial(jax.jit, static_argnames=("bucket_minutes", "num_segments",
                                   "min_count"))
def window_candles(state: RingState, t0_minute: jax.Array,
                   bucket_minutes: int = 5, *, num_segments: int,
                   min_count: int = 5):
    """Aggregate the ring's chronological window straight into candles —
    the read side of the streaming chain, no host round trip.

    Channels convention: C >= 5 with [open, high, low, close, volume].

    PRECONDITION (dense convention): each stream pushes exactly ONE
    slot per consecutive minute. ``t0_minute`` is the epoch minute of
    each stream's FIRST push — scalar or per-stream ``(B,)`` — and each
    stream's window-start minute is derived as ``t0 + max(count - L,
    0)``, so wrapped rings and streams with differing push counts label
    their slots correctly (round-4 review: a single scalar window-start
    minute mislabeled every stream whose ring had wrapped a different
    amount). The ring stores no timestamps, so SPARSE tick streams
    cannot use this helper — use :func:`window` plus an explicit minute
    channel instead (the ``pipeline.stream_service`` pattern).
    """
    from iv_engine.ops.segment_ohlcv import aggregate_ohlcv

    data, valid = window(state)
    B, _, L = data.shape
    t0 = jnp.broadcast_to(jnp.asarray(t0_minute), (B,))
    start = t0 + jnp.maximum(state.count - L, 0)
    minutes = start[:, None] + jnp.arange(L)[None, :]
    base_bucket = start // bucket_minutes
    return jax.vmap(
        lambda m, o, h, l, c, v, ok, bb: aggregate_ohlcv(
            m, o, h, l, c, v, ok, jnp.int32(bucket_minutes),
            bb, num_segments=num_segments, min_count=min_count,
            assume_sorted=True)  # minutes is an arange over the window
    )(minutes, data[:, 0], data[:, 1], data[:, 2], data[:, 3],
      data[:, 4], valid, base_bucket)
