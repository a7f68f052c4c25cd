"""Candle aggregation parity vs the reference's pandas groupby
(src/candle_reconstruction/core.py:36-106)."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from iv_engine.ops.segment_ohlcv import (
    aggregate_ohlcv,
    reconstruction_stats,
    validate_ohlcv,
)


def _pandas_oracle(df, freq_minutes, min_count):
    """The exact groupby the reference runs (core.py:70-89)."""
    data = df.sort_values("timestamp").copy()
    data["time_group"] = data["timestamp"].dt.floor(f"{freq_minutes}min")
    agg = data.groupby("time_group").agg(
        open=("open", "first"), high=("high", "max"), low=("low", "min"),
        close=("close", "last"), volume=("volume", "sum"),
    ).reset_index()
    counts = data.groupby("time_group").size()
    complete = counts[counts >= min_count].index
    return agg[agg["time_group"].isin(complete)].reset_index(drop=True)


def _random_bars(rng, n_minutes, keep_frac=0.8, start_minute=7):
    minutes = start_minute + np.flatnonzero(rng.uniform(size=n_minutes) < keep_frac)
    L = len(minutes)
    close = 100 + np.cumsum(rng.normal(size=L))
    open_ = close + rng.normal(size=L) * 0.1
    high = np.maximum(open_, close) + rng.uniform(0, 0.5, L)
    low = np.minimum(open_, close) - rng.uniform(0, 0.5, L)
    volume = rng.uniform(0, 100, L)
    return minutes, open_, high, low, close, volume


@pytest.mark.parametrize("freq,min_count", [(5, 5), (5, 1), (15, 15)])
def test_matches_pandas_groupby(rng, freq, min_count):
    minutes, o, h, l, c, v = _random_bars(rng, 600)
    df = pd.DataFrame({
        "timestamp": pd.to_datetime("2023-03-20") + pd.to_timedelta(minutes, unit="m"),
        "open": o, "high": h, "low": l, "close": c, "volume": v,
    })
    expected = _pandas_oracle(df, freq, min_count)

    base_bucket = int(minutes[0]) // freq
    num_segments = int(minutes[-1]) // freq - base_bucket + 1
    got = aggregate_ohlcv(
        jnp.array(minutes), *map(jnp.array, (o, h, l, c, v)),
        jnp.ones(len(minutes), bool), jnp.int32(freq), jnp.int32(base_bucket),
        num_segments=num_segments, min_count=min_count,
    )
    valid = np.asarray(got.valid)
    sel = np.flatnonzero(valid)
    # timestamps of surviving buckets
    got_minutes = (base_bucket + sel) * freq
    exp_minutes = (
        (expected["time_group"] - pd.Timestamp("2023-03-20")).dt.total_seconds()
        // 60
    ).to_numpy()
    np.testing.assert_array_equal(got_minutes, exp_minutes)
    for col in ("open", "high", "low", "close", "volume"):
        np.testing.assert_allclose(
            np.asarray(getattr(got, col))[sel], expected[col].to_numpy(),
            atol=1e-12, err_msg=col,
        )


def test_padding_rows_ignored(rng):
    minutes, o, h, l, c, v = _random_bars(rng, 100, keep_frac=1.0, start_minute=0)
    L = len(minutes)
    pad = 37
    pad_arr = lambda a, fill: np.concatenate([a, np.full(pad, fill)])
    valid = np.concatenate([np.ones(L, bool), np.zeros(pad, bool)])
    got = aggregate_ohlcv(
        jnp.array(pad_arr(minutes, 0).astype(np.int64)),
        *[jnp.array(pad_arr(a, np.nan)) for a in (o, h, l, c)],
        jnp.array(pad_arr(v, 0.0)),
        jnp.array(valid), jnp.int32(5), jnp.int32(0),
        num_segments=20, min_count=5,
    )
    np.testing.assert_array_equal(np.asarray(got.count), np.full(20, 5))
    assert np.asarray(got.valid).all()


def test_validate_ohlcv_catches_violations():
    o = jnp.array([1.0, 1.0]); h = jnp.array([2.0, 0.5])
    l = jnp.array([0.5, 0.4]); c = jnp.array([1.5, 0.45])
    v = jnp.array([1.0, 1.0]); valid = jnp.array([True, True])
    all_ok, ok = validate_ohlcv(o, h, l, c, v, valid)
    assert not bool(all_ok)
    assert bool(ok[0]) and not bool(ok[1])
    # same rows as padding pass
    all_ok2, _ = validate_ohlcv(o, h, l, c, v, jnp.array([True, False]))
    assert bool(all_ok2)


def test_reconstruction_stats(rng):
    minutes, o, h, l, c, v = _random_bars(rng, 50, keep_frac=1.0, start_minute=0)
    got = aggregate_ohlcv(
        jnp.array(minutes), *map(jnp.array, (o, h, l, c, v)),
        jnp.ones(len(minutes), bool), jnp.int32(5), jnp.int32(0),
        num_segments=10, min_count=5,
    )
    stats = reconstruction_stats(jnp.int32(len(minutes)), got, jnp.sum(jnp.array(v)))
    assert int(stats["reconstructed_candles"]) == 10
    np.testing.assert_allclose(float(stats["compression_ratio"]), 5.0)
    np.testing.assert_allclose(float(stats["volume_preservation"]), 0.0, atol=1e-12)


@pytest.mark.parametrize("start_minute", [0, 7])
def test_assume_sorted_matches_default(rng, start_minute):
    """assume_sorted=True (sorted-scatter hints + running-max re-index
    of invalid rows) is numerically identical to the default path, even
    with garbage minutes on interleaved padding rows."""
    minutes, o, h, l, c, v = _random_bars(rng, 60, keep_frac=0.9,
                                          start_minute=start_minute)
    L = len(minutes)
    valid = rng.uniform(size=L) < 0.8
    # poison INVALID rows' minutes with unsorted garbage (incl. negative
    # and out-of-range) — the hint path must not care
    minutes = minutes.copy()
    minutes[~valid] = rng.integers(-50, 500, (~valid).sum())
    args = (jnp.array(minutes), *map(jnp.array, (o, h, l, c, v)),
            jnp.array(valid), jnp.int32(5),
            jnp.int32(start_minute // 5))
    ref = aggregate_ohlcv(*args, num_segments=14, min_count=1)
    fast = aggregate_ohlcv(*args, num_segments=14, min_count=1,
                           assume_sorted=True)
    # open/close are gathers and high/low/count are order-independent
    # reductions -> bit-exact; volume sums associate differently
    # (cumsum difference vs per-segment adds) -> allclose
    for f in ("open", "high", "low", "close", "count", "valid"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f)),
                                      np.asarray(getattr(fast, f)),
                                      err_msg=f)
    np.testing.assert_allclose(np.asarray(ref.volume),
                               np.asarray(fast.volume), rtol=1e-12)


def test_assume_sorted_all_invalid(rng):
    """Degenerate all-padding input stays empty under the hint path."""
    L = 16
    z = jnp.zeros(L)
    out = aggregate_ohlcv(jnp.zeros(L, jnp.int32), z, z, z, z, z,
                          jnp.zeros(L, bool), jnp.int32(5), jnp.int32(0),
                          num_segments=4, min_count=1, assume_sorted=True)
    assert not bool(out.valid.any())
    assert int(out.count.sum()) == 0


# ---------------------------------------------------------------------------
# The streaming step's batched aggregation (pipeline.streaming._aggregate:
# segment reductions over a leading underlying axis).


def _streaming_agg(minute, o, h, l, c, v, valid, bucket, ns, min_count):
    from iv_engine.pipeline.streaming import _aggregate
    return _aggregate(*(jnp.asarray(a) for a in (minute, o, h, l, c, v,
                                                 valid)),
                      bucket_minutes=bucket, num_segments=ns,
                      min_count=min_count)


def _bars(rng, B, L, ns, bucket, valid_frac):
    minute = np.sort(rng.integers(0, ns * bucket, (B, L)).astype(np.int32),
                     axis=-1)
    o = rng.normal(100, 1, (B, L)).astype(np.float32)
    h = o + rng.uniform(0, 1, (B, L)).astype(np.float32)
    l = o - rng.uniform(0, 1, (B, L)).astype(np.float32)
    c = o + rng.normal(0, 0.5, (B, L)).astype(np.float32)
    v = rng.uniform(0, 5, (B, L)).astype(np.float32)
    return minute, o, h, l, c, v, rng.random((B, L)) > 1 - valid_frac


def test_stream_agg_matches_sorted_path(rng):
    """The streaming aggregation == the scatter-free sorted path on every
    Candles field; volume at f32 tolerance (the sorted path's bucket sums
    are prefix-sum differences, see test_volume_accuracy_vs_f64_oracle),
    everything else exact (selections and integer counts)."""
    import jax

    B, L, ns = 4, 512, 100
    args = _bars(rng, B, L, ns, 5, 0.9)
    ref = jax.vmap(lambda m, oo, hh, ll, cc, vv, ok: aggregate_ohlcv(
        m, oo, hh, ll, cc, vv, ok, jnp.int32(5), jnp.int32(0),
        num_segments=ns, min_count=3, assume_sorted=True))(
        *(jnp.asarray(a) for a in args))
    got = _streaming_agg(*args, 5, ns, 3)
    for f in ("open", "high", "low", "close", "count", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ref, f)), np.asarray(getattr(got, f)),
            err_msg=f)
    np.testing.assert_allclose(np.asarray(got.volume),
                               np.asarray(ref.volume), rtol=1e-5,
                               atol=1e-4)


def test_stream_agg_unsorted_minmax(rng):
    """Segment reductions need NO sort for high/low/volume/count:
    shuffled rows give the per-bucket numpy reductions; open/close
    follow the row-position rule by contract."""
    B, L, ns = 2, 256, 64
    minute = rng.integers(0, ns, (B, L)).astype(np.int32)  # unsorted
    p = rng.normal(100, 1, (B, L)).astype(np.float32)
    v = rng.uniform(0, 5, (B, L)).astype(np.float32)
    got = _streaming_agg(minute, p, p, p, p, v, np.ones((B, L), bool),
                         1, ns, 1)
    for b in range(B):
        for j in (0, ns // 2, ns - 1):
            rows = np.flatnonzero(minute[b] == j)
            if len(rows) == 0:
                assert not bool(got.valid[b, j])
                continue
            assert np.isclose(float(got.high[b, j]), p[b, rows].max())
            assert np.isclose(float(got.low[b, j]), p[b, rows].min())
            assert np.isclose(float(got.volume[b, j]), v[b, rows].sum(),
                              rtol=1e-5)
            assert int(got.count[b, j]) == len(rows)
            assert np.isclose(float(got.open[b, j]), p[b, rows[0]])
            assert np.isclose(float(got.close[b, j]), p[b, rows[-1]])


def test_stream_agg_nan_in_invalid_rows(rng):
    """Invalid rows may carry anything — including NaN/Inf sizes and
    prices (the aggregate_ohlcv contract): they must not poison any
    bucket."""
    B, L, ns = 2, 128, 32
    minute = rng.integers(0, ns, (B, L)).astype(np.int32)
    p = rng.normal(100, 1, (B, L)).astype(np.float32)
    v = rng.uniform(0, 5, (B, L)).astype(np.float32)
    valid = rng.random((B, L)) > 0.3
    p_bad, v_bad = p.copy(), v.copy()
    p_bad[~valid] = np.nan
    v_bad[~valid] = np.nan
    v_bad[0, np.flatnonzero(~valid[0])[:1]] = np.inf

    got = _streaming_agg(minute, p_bad, p_bad, p_bad, p_bad, v_bad, valid,
                         1, ns, 1)
    clean = _streaming_agg(minute, p, p, p, p, v, valid, 1, ns, 1)
    nonempty = np.asarray(clean.count) > 0
    for f in ("open", "high", "low", "close", "volume"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(clean, f))
        np.testing.assert_allclose(a[nonempty], b[nonempty], rtol=1e-6,
                                   err_msg=f)
        assert np.isfinite(a[nonempty]).all(), f


def test_volume_accuracy_vs_f64_oracle(rng):
    """Bucket-volume accuracy ordering, pinned against the f64 oracle.

    The sorted path computes volume as a difference of two f32
    window-prefix values, so its ABSOLUTE error scales with the window
    running total (~eps * sum|v|) — a large RELATIVE error on near-empty
    buckets late in a long window. The streaming aggregation sums each
    bucket directly and must stay at f32 eps of the oracle; the sorted
    path must stay within its documented eps * total bound."""
    import jax

    B, L, ns = 2, 4096, 512
    minute = np.sort(rng.integers(0, ns * 5, (B, L)).astype(np.int32), -1)
    p = rng.normal(100, 1, (B, L)).astype(np.float32)
    v = rng.uniform(0, 5, (B, L)).astype(np.float32)
    # make some LATE buckets tiny: zero out most sizes in the last fifth
    tail = slice(int(0.8 * L), None)
    v[:, tail] *= (rng.random((B, L - int(0.8 * L))) > 0.95) * 1e-3
    valid = rng.random((B, L)) > 0.1
    args = (minute, p, p, p, p, v, valid)

    got = _streaming_agg(*args, 5, ns, 1)
    ref = jax.vmap(lambda m, oo, hh, ll, cc, vv, ok: aggregate_ohlcv(
        m, oo, hh, ll, cc, vv, ok, jnp.int32(5), jnp.int32(0),
        num_segments=ns, min_count=1, assume_sorted=True))(
        *(jnp.asarray(a) for a in args))

    seg = minute // 5
    oracle = np.zeros((B, ns))
    for b in range(B):
        for s in range(ns):
            rows = (seg[b] == s) & valid[b]
            oracle[b, s] = v[b][rows].astype(np.float64).sum()
    nonempty = np.asarray(got.count) > 0
    err_got = np.abs(np.asarray(got.volume) - oracle)[nonempty]
    err_ref = np.abs(np.asarray(ref.volume) - oracle)[nonempty]
    total = np.abs(v[valid]).sum() / B   # per-row window running total
    assert err_got.max() < 1e-4, err_got.max()           # direct f32 sum
    assert err_ref.max() < 4e-7 * total + 1e-5, err_ref.max()  # cumsum bound
    assert err_got.max() <= err_ref.max() + 1e-6          # ordering


def test_stream_agg_long_window_matches_numpy(rng):
    """A long window (L=8192 ticks, buckets straddling any chunking a
    backend might use) against direct numpy reductions per bucket."""
    B, L, ns = 2, 8192, 40
    minute, o, h, l, c, v, valid = _bars(rng, B, L, ns, 5, 0.8)
    got = _streaming_agg(minute, o, h, l, c, v, valid, 5, ns, 3)
    seg = minute // 5
    for b in range(B):
        for s in range(ns):
            rows = np.flatnonzero((seg[b] == s) & valid[b])
            assert int(got.count[b, s]) == len(rows)
            assert bool(got.valid[b, s]) == (len(rows) >= 3)
            if not len(rows):
                continue
            assert float(got.open[b, s]) == o[b, rows[0]]
            assert float(got.close[b, s]) == c[b, rows[-1]]
            assert float(got.high[b, s]) == h[b, rows].max()
            assert float(got.low[b, s]) == l[b, rows].min()
            np.testing.assert_allclose(
                float(got.volume[b, s]),
                v[b, rows].astype(np.float64).sum(), rtol=1e-5)
