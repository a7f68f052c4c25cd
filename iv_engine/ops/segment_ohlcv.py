"""Candle aggregation as segment reductions — the Task-2 compute core.

Device-native replacement for the reference's pandas groupby aggregation
(src/candle_reconstruction/core.py:36-106): 1-minute OHLCV bars are
bucketed by ``floor(timestamp / target_frequency)`` and reduced with
open=first / high=max / low=min / close=last / volume=sum, then buckets
with fewer than ``min_count`` source bars are dropped
(core.py:85-89 — "incomplete bucket" filter).

Design: instead of a hash-based groupby, timestamps are integer minutes so
the bucket id is pure arithmetic, and the reduction is ``jax.ops.segment_*``
over a static number of segments — one fused XLA computation per column,
vmappable over symbols. ``first``/``last`` are segment-argmin/argmax over
the in-bucket time index, realised as segment_min/max over an encoded
(time, position) key to stay gather-light.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Candles(NamedTuple):
    """A batch of candles on a dense bucket grid (device-resident)."""

    open: jax.Array
    high: jax.Array
    low: jax.Array
    close: jax.Array
    volume: jax.Array
    count: jax.Array  # source bars per bucket
    valid: jax.Array  # bool — bucket complete & non-empty


@partial(jax.jit, static_argnames=("num_segments", "min_count",
                                   "assume_sorted"))
def aggregate_ohlcv(minutes: jax.Array, o: jax.Array, h: jax.Array,
                    l: jax.Array, c: jax.Array, v: jax.Array,
                    valid: jax.Array, bucket_minutes: jax.Array,
                    base_bucket: jax.Array, *, num_segments: int,
                    min_count: int, assume_sorted: bool = False) -> Candles:
    """Aggregate 1-minute bars into ``bucket_minutes``-minute candles.

    Args:
      minutes: ``(L,)`` int — bar timestamps in epoch minutes. Valid rows
        MUST be time-sorted (the open/close = first/last-in-bucket rule
        relies on row order); invalid rows may carry anything.
      o/h/l/c/v: ``(L,)`` float — OHLCV columns.
      valid: ``(L,)`` bool — padding / missing-bar mask.
      bucket_minutes: scalar int — target frequency (e.g. 5).
      base_bucket: scalar int — bucket id of the first output slot
        (``floor(first_minute / bucket_minutes)``), so output slot ``j``
        covers epoch bucket ``base_bucket + j``.
      num_segments: static output length.
      min_count: static incomplete-bucket threshold (reference
        ``frequency_minutes``, core.py:88).
      assume_sorted: use the scatter-free segmented-scan path. XLA
        lowers ``segment_*`` to scatters, whose cost depends on the
        backend's handling of repeated indices (every real candle bucket
        repeats); with sorted rows the same reductions are cumulative
        scans plus boundary gathers: all dense ops, no scatter, and a
        deterministic summation order. Invalid rows are
        re-indexed to the running max of the valid segment ids (their
        values are already neutral), so the mode only requires what the
        first/last rule requires anyway: valid rows time-sorted.

    Returns:
      :class:`Candles` with arrays of shape ``(num_segments,)``.
    """
    seg = (minutes // bucket_minutes - base_bucket).astype(jnp.int32)
    in_range = (seg >= 0) & (seg < num_segments)
    ok = valid & in_range
    if assume_sorted:
        return _aggregate_sorted(seg, o, h, l, c, v, ok,
                                 num_segments=num_segments,
                                 min_count=min_count)
    seg = jnp.where(ok, seg, num_segments)  # park invalid in overflow slot
    ns = num_segments + 1

    big = jnp.asarray(jnp.finfo(h.dtype).max, h.dtype)
    high = jax.ops.segment_max(jnp.where(ok, h, -big), seg, num_segments=ns)
    low = jax.ops.segment_min(jnp.where(ok, l, big), seg, num_segments=ns)
    volume = jax.ops.segment_sum(jnp.where(ok, v, 0.0), seg, num_segments=ns)
    count = jax.ops.segment_sum(ok.astype(jnp.int32), seg, num_segments=ns)

    # first/last via in-bucket row order: rows are time-sorted, so the
    # first/last row position in a bucket is the first/last bar. Using the
    # row position (not the minute offset) keeps this correct when several
    # rows share a timestamp (e.g. multiple ticks within one minute).
    offset = jax.lax.broadcasted_iota(jnp.int32, (minutes.shape[-1], 1),
                                      0).squeeze(-1)
    bigi = jnp.iinfo(jnp.int32).max
    first_off = jax.ops.segment_min(jnp.where(ok, offset, bigi), seg,
                                    num_segments=ns)
    last_off = jax.ops.segment_max(jnp.where(ok, offset, -1), seg,
                                   num_segments=ns)
    is_first = ok & (offset == first_off[seg])
    is_last = ok & (offset == last_off[seg])
    open_ = jax.ops.segment_sum(jnp.where(is_first, o, 0.0), seg,
                                num_segments=ns)
    close = jax.ops.segment_sum(jnp.where(is_last, c, 0.0), seg,
                                num_segments=ns)

    nonempty = count[:num_segments] > 0
    complete = count[:num_segments] >= min_count
    valid_out = nonempty & complete
    nan = jnp.asarray(jnp.nan, h.dtype)
    fix = lambda a: jnp.where(nonempty, a[:num_segments], nan)
    return Candles(
        open=fix(open_),
        high=fix(high),
        low=fix(low),
        close=fix(close),
        volume=jnp.where(nonempty, volume[:num_segments], 0.0),
        count=count[:num_segments],
        valid=valid_out,
    )


def _sparse_table(vals: jax.Array, op, neutral):
    """Binary-lifting range-reduce table: ``T[k][i] = op(vals[i:i+2^k])``.
    log2(L) dense shift+op levels — a tiny XLA graph with no scatter and
    no scan (``associative_scan`` traced 45s+ for this shape)."""
    L = vals.shape[-1]
    fill = jnp.full((1,), neutral, vals.dtype)
    tables = [vals]
    k = 0
    while (1 << (k + 1)) <= L:
        prev = tables[-1]
        sh = 1 << k
        shifted = jnp.concatenate(
            [prev[sh:], jnp.broadcast_to(fill, (sh,))])
        tables.append(op(prev, shifted))
        k += 1
    return jnp.stack(tables)  # (K, L)


def _range_reduce(table: jax.Array, op, b: jax.Array, e: jax.Array):
    """op over [b, e) per query via two overlapping power-of-2 blocks.
    ``b``/``e`` int32 arrays with e > b (guard empty ranges outside)."""
    L = table.shape[-1]
    span = jnp.maximum(e - b, 1)
    k = 31 - jax.lax.clz(span)          # floor(log2(span))
    left = table[k, jnp.clip(b, 0, L - 1)]
    right = table[k, jnp.clip(e - (1 << k), 0, L - 1)]
    return op(left, right)


def _aggregate_sorted(seg: jax.Array, o, h, l, c, v, ok, *,
                      num_segments: int, min_count: int) -> Candles:
    """Scatter-free aggregation for time-sorted rows.

    Segment runs are contiguous; each bucket's row range comes from ONE
    fused compare-reduce — e[j] = count(seg <= j) and the run start is
    e[j-1] (a binary search per bucket is a long dependent loop where
    the compare-reduce is one fused pass). Sums are cumsum differences;
    max/min/first/last are sparse-table range reductions — dense ops +
    gathers, in a fixed summation order (deterministic tables).

    Precision note (volume): a bucket sum computed as the difference of
    two f32 window-prefix values carries absolute error ~ eps * (window
    running total), NOT eps * (bucket total) — at L=4096 rows of O(1)
    sizes that is ~1e-3 absolute, which is a large RELATIVE error on
    near-empty buckets late in the window (measured 0.14 rel on a
    1.7e-3-volume bucket vs the f64 oracle). The segment-reduction path
    (``assume_sorted=False``, the streaming step's) sums each bucket
    directly and matches the f64 oracle to f32 eps; this path's volume
    is accurate to ~eps * sum(|v|) per row, asserted in
    tests/test_segment_ohlcv.py::test_volume_accuracy_vs_f64_oracle.
    """
    L = seg.shape[-1]
    ns = num_segments
    # nondecreasing in-range ids even through garbage padding rows:
    # invalid rows adopt the running max (their values are neutral)
    seg = jnp.clip(seg, 0, ns - 1)
    seg = jnp.maximum(jax.lax.cummax(jnp.where(ok, seg, -1)), 0)

    ids = jnp.arange(ns, dtype=seg.dtype)
    # NOTE: the (L, ns) compare materialises only if XLA fails to fuse it
    # into the reduction — measured fused (33 ms vs searchsorted's 160 ms
    # at (1024, 4096) x 512). If a backend regression ever un-fuses it,
    # the O(L + ns) fallback is cumsum(bincount(seg)) via
    # segment_sum(ok, seg) + cumsum — kept out of the default path only
    # because segment_sum lowers to scatter, the op this mode exists to
    # avoid.
    e = jnp.sum(seg[:, None] <= ids[None, :], axis=0, dtype=jnp.int32)
    b = jnp.concatenate([jnp.zeros((1,), jnp.int32), e[:-1]])

    # sums via cumsum differences over [b, e)
    def seg_sum(vals):
        cs = jnp.cumsum(vals)
        take = lambda i: jnp.where(i > 0, cs[jnp.clip(i - 1, 0, L - 1)], 0)
        return take(e) - take(b)

    count = seg_sum(ok.astype(jnp.int32))
    volume = seg_sum(jnp.where(ok, v, 0.0))

    big = jnp.asarray(jnp.finfo(h.dtype).max, h.dtype)
    t_high = _sparse_table(jnp.where(ok, h, -big), jnp.maximum, -big)
    t_low = _sparse_table(jnp.where(ok, l, big), jnp.minimum, big)
    high = _range_reduce(t_high, jnp.maximum, b, e)
    low = _range_reduce(t_low, jnp.minimum, b, e)

    # first/last valid row per segment -> open/close via gather
    offset = jax.lax.broadcasted_iota(jnp.int32, (L, 1), 0).squeeze(-1)
    bigi = jnp.iinfo(jnp.int32).max
    t_first = _sparse_table(jnp.where(ok, offset, bigi), jnp.minimum, bigi)
    t_last = _sparse_table(jnp.where(ok, offset, -1), jnp.maximum, -1)
    first_off = _range_reduce(t_first, jnp.minimum, b, e)
    last_off = _range_reduce(t_last, jnp.maximum, b, e)
    open_ = o[jnp.clip(first_off, 0, L - 1)]
    close = c[jnp.clip(last_off, 0, L - 1)]

    nonempty = count > 0
    valid_out = nonempty & (count >= min_count)
    nan = jnp.asarray(jnp.nan, h.dtype)
    fix = lambda a: jnp.where(nonempty, a, nan)
    return Candles(
        open=fix(open_),
        high=fix(high),
        low=fix(low),
        close=fix(close),
        volume=jnp.where(nonempty, volume, 0.0),
        count=count,
        valid=valid_out,
    )


@jax.jit
def validate_ohlcv(o, h, l, c, v, valid):
    """Vectorised OHLC-integrity check (reference
    ``CandleReconstructor.validate_candle_data``, core.py:108-144, and the
    DB CHECK constraints at candle_schema.py:41-48).

    Returns (all_ok: bool scalar, per-bar ok mask). Padding rows pass.
    """
    finite = jnp.isfinite(o) & jnp.isfinite(h) & jnp.isfinite(l) & jnp.isfinite(c)
    rel = (h >= l) & (h >= o) & (h >= c) & (l <= o) & (l <= c)
    vol_ok = v >= 0
    ok = (~valid) | (finite & rel & vol_ok)
    return jnp.all(ok), ok


def reconstruction_stats(count_in: jax.Array, candles: Candles,
                         volume_in: jax.Array):
    """Compression / volume-preservation stats (reference
    ``get_reconstruction_stats``, core.py:146-171), as jit-friendly scalars."""
    n_out = jnp.sum(candles.valid)
    n_in = count_in
    vol_out = jnp.sum(jnp.where(candles.valid, candles.volume, 0.0))
    vol_in = volume_in
    return {
        "original_candles": n_in,
        "reconstructed_candles": n_out,
        "compression_ratio": jnp.where(n_out > 0, n_in / n_out, 0.0),
        "total_volume_original": vol_in,
        "total_volume_reconstructed": vol_out,
        "volume_preservation": jnp.where(
            vol_in > 0, jnp.abs(1.0 - vol_out / vol_in), 1.0
        ),
    }
