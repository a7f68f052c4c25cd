"""Masked timeline interpolation parity vs pandas Series.interpolate.

Oracle = the same pandas calls the reference made on its merged timeline
(src/interpolation/core.py:58-68).
"""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from iv_engine.ops.interp import (
    ffill,
    masked_interp,
    scatter_observations,
)


def _random_gappy(rng, L, frac_missing=0.7, leading=0, trailing=0):
    vals = rng.normal(size=L) + 5.0
    mask = rng.uniform(size=L) < frac_missing
    vals[mask] = np.nan
    if leading:
        vals[:leading] = np.nan
    if trailing:
        vals[-trailing:] = np.nan
    # make sure at least one valid point exists
    vals[L // 2] = 1.23
    return vals


@pytest.mark.parametrize("leading,trailing", [(0, 0), (5, 0), (0, 7), (3, 4)])
def test_linear_matches_pandas(rng, leading, trailing):
    L = 500
    vals = _random_gappy(rng, L, leading=leading, trailing=trailing)
    expected = pd.Series(vals).interpolate(method="linear").to_numpy()
    got = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool)))
    np.testing.assert_allclose(got, expected, atol=1e-12, equal_nan=True)


def test_ffill_matches_pandas(rng):
    L = 300
    vals = _random_gappy(rng, L, leading=4)
    expected = pd.Series(vals).ffill().to_numpy()
    got = np.asarray(ffill(jnp.array(vals), jnp.ones(L, bool)))
    np.testing.assert_allclose(got, expected, atol=0, equal_nan=True)


def test_nearest_matches_pandas(rng):
    L = 200
    vals = _random_gappy(rng, L)
    vals[0] = 2.0  # avoid leading-NaN semantics differences
    vals[-1] = 3.0
    expected = pd.Series(vals).interpolate(method="nearest").to_numpy()
    got = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool),
                                   method="nearest"))
    np.testing.assert_allclose(got, expected, atol=0, equal_nan=True)


def test_padding_stays_nan(rng):
    L, valid_len = 64, 40
    vals = _random_gappy(rng, L)
    mask = np.arange(L) < valid_len
    got = np.asarray(masked_interp(jnp.array(vals), jnp.array(mask)))
    assert np.all(np.isnan(got[valid_len:]))


def test_max_gap_masks_wide_bridges():
    L = 100
    vals = np.full(L, np.nan)
    vals[0], vals[10], vals[90] = 1.0, 2.0, 10.0
    got = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool),
                                   max_gap_minutes=30))
    # 0..10 gap = 10 <= 30: bridged
    assert np.isfinite(got[5])
    np.testing.assert_allclose(got[5], 1.5)
    # 10..90 gap = 80 > 30: masked
    assert np.all(np.isnan(got[11:90]))
    assert got[90] == 10.0


def test_batched_columns(rng):
    C, L = 6, 400
    vals = np.stack([_random_gappy(rng, L) for _ in range(C)])
    got = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool)))
    for c in range(C):
        expected = pd.Series(vals[c]).interpolate(method="linear").to_numpy()
        np.testing.assert_allclose(got[c], expected, atol=1e-12, equal_nan=True)


def test_scatter_observations():
    pos = jnp.array([0, 3, 7, -1])
    vals = jnp.array([1.0, 2.0, 3.0, 99.0])
    valid = jnp.array([True, True, True, False])
    grid = np.asarray(scatter_observations(pos, vals, valid, 10))
    assert grid[0] == 1.0 and grid[3] == 2.0 and grid[7] == 3.0
    assert np.isnan(grid[[1, 2, 4, 5, 6, 8, 9]]).all()


def test_scatter_then_interp_matches_pandas_merge(rng):
    """End-to-end slice of the reference algorithm: hourly obs -> minute
    grid -> linear interp, vs the pandas merge+interpolate the reference
    used (core.py:42-61)."""
    hours = 12
    obs_minutes = np.arange(hours) * 60
    obs_vals = rng.normal(size=hours) + 10.0
    L = int(obs_minutes[-1]) + 1

    # pandas oracle
    timeline = pd.date_range("2023-03-20", periods=L, freq="1min")
    obs_df = pd.DataFrame({
        "date": pd.to_datetime("2023-03-20") + pd.to_timedelta(obs_minutes, unit="m"),
        "iv": obs_vals,
    })
    merged = pd.DataFrame({"date": timeline}).merge(obs_df, on="date", how="left")
    expected = merged["iv"].interpolate(method="linear").to_numpy()

    grid = scatter_observations(jnp.array(obs_minutes), jnp.array(obs_vals),
                                jnp.ones(hours, bool), L)
    got = np.asarray(masked_interp(grid, jnp.ones(L, bool)))
    np.testing.assert_allclose(got, expected, atol=1e-12)


def test_extrapolate_linear():
    L = 20
    vals = np.full(L, np.nan)
    vals[5], vals[8] = 1.0, 2.5  # slope 0.5/step
    got = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool),
                                   extrapolate=True))
    np.testing.assert_allclose(got[0], 1.0 - 5 * 0.5)
    np.testing.assert_allclose(got[4], 1.0 - 0.5)
    np.testing.assert_allclose(got[12], 2.5 + 4 * 0.5)
    # default stays pandas-parity: leading NaN, trailing hold
    dflt = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool)))
    assert np.isnan(dflt[0]) and dflt[-1] == 2.5


def test_extrapolate_single_point_is_constant():
    L = 9
    vals = np.full(L, np.nan)
    vals[4] = 3.0
    got = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool),
                                   extrapolate=True))
    np.testing.assert_allclose(got, 3.0)


def test_cubic_resample_matches_pandas(rng):
    from iv_engine.ops.interp import cubic_resample
    L, k = 300, 14
    pos = np.sort(rng.choice(L, size=k, replace=False))
    pos[0], pos[-1] = 3, L - 5  # leading/trailing NaN regions exist
    vals = rng.normal(size=k) + 10.0
    series = np.full(L, np.nan)
    series[pos] = vals
    expected = pd.Series(series).interpolate(method="cubic").to_numpy()
    got = np.asarray(cubic_resample(jnp.array(pos), jnp.array(vals), L))
    np.testing.assert_allclose(got, expected, atol=1e-8, equal_nan=True)


def test_cubic_resample_batched(rng):
    from iv_engine.ops.interp import cubic_resample
    B, L, k = 6, 200, 10
    pos = np.sort(np.stack([rng.choice(L, size=k, replace=False)
                            for _ in range(B)]), axis=-1)
    vals = rng.normal(size=(B, k)) + 5.0
    got = np.asarray(cubic_resample(jnp.array(pos), jnp.array(vals), L))
    for b in range(B):
        series = np.full(L, np.nan)
        series[pos[b]] = vals[b]
        expected = pd.Series(series).interpolate(method="cubic").to_numpy()
        np.testing.assert_allclose(got[b], expected, atol=1e-8,
                                   equal_nan=True)


@pytest.mark.parametrize("seed", range(6))
def test_linear_fuzz_vs_pandas(seed):
    """Randomised gap patterns across several seeds — broad parity net."""
    r = np.random.default_rng(seed)
    L = int(r.integers(20, 400))
    vals = r.normal(size=L)
    vals[r.uniform(size=L) < r.uniform(0.2, 0.95)] = np.nan
    if not np.isfinite(vals).any():
        vals[L // 2] = 1.0
    expected = pd.Series(vals).interpolate(method="linear").to_numpy()
    got = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool)))
    np.testing.assert_allclose(got, expected, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("seed", range(4))
def test_aggregate_fuzz_vs_pandas(seed):
    """Random timestamps/frequencies through the segment aggregation."""
    from iv_engine.ops.segment_ohlcv import aggregate_ohlcv
    r = np.random.default_rng(100 + seed)
    freq = int(r.choice([3, 5, 7, 15]))
    n = int(r.integers(50, 400))
    minutes = np.sort(r.choice(2000, size=n, replace=False)) + int(
        r.integers(0, 50))
    o = r.normal(size=n) + 50
    h = o + r.uniform(0, 1, n)
    l = o - r.uniform(0, 1, n)
    c = l + r.uniform(0, 1, n) * (h - l)
    v = r.uniform(0, 10, n)
    # pandas dt.floor anchors at the Unix epoch, so the kernel must see
    # EPOCH minutes (exactly what pipeline ingest passes) — a relative
    # anchor diverges whenever freq does not divide the origin offset
    epoch0 = int(pd.Timestamp("2024-01-01").value // 60_000_000_000)
    minutes = minutes + epoch0
    df = pd.DataFrame({
        "timestamp": pd.to_datetime(minutes * 60_000_000_000),
        "open": o, "high": h, "low": l, "close": c, "volume": v})
    data = df.copy()
    data["g"] = data["timestamp"].dt.floor(f"{freq}min")
    agg = data.groupby("g").agg(open=("open", "first"), high=("high", "max"),
                                low=("low", "min"), close=("close", "last"),
                                volume=("volume", "sum"))
    counts = data.groupby("g").size()
    agg = agg[counts >= min(freq, 3)]
    base = int(minutes[0]) // freq
    nseg = int(minutes[-1]) // freq - base + 1
    got = aggregate_ohlcv(jnp.array(minutes), *map(jnp.array, (o, h, l, c, v)),
                          jnp.ones(n, bool), jnp.int32(freq),
                          jnp.int32(base), num_segments=nseg,
                          min_count=min(freq, 3))
    sel = np.flatnonzero(np.asarray(got.valid))
    assert len(sel) == len(agg)
    for col in ("open", "high", "low", "close", "volume"):
        np.testing.assert_allclose(np.asarray(getattr(got, col))[sel],
                                   agg[col].to_numpy(), atol=1e-10,
                                   err_msg=f"seed{seed}:{col}")


def test_pack_symbols_const_cols_first_non_null():
    """The numpy-fast pack (round 4) must keep pandas groupby .first()
    semantics for const columns: the first NON-NULL value per symbol,
    not the first row's value."""
    import numpy as np
    import pandas as pd
    from iv_engine.pipeline import ingest

    dates = pd.date_range("2023-03-01", periods=12, freq="1h")
    df = pd.DataFrame({
        "symbol": ["a"] * 12 + ["b"] * 12,
        "date": list(dates) * 2,
        "iv": 0.5,
        "underlying_price": 100.0,
        # symbol a: strike NaN on the first two rows, then 24000;
        # symbol b: strike present from row 0
        "strike": [np.nan, np.nan] + [24000.0] * 10 + [26000.0] * 12,
        "callput": [None, "c"] + ["c"] * 10 + ["p"] * 12,
    })
    packed = ingest.pack_symbols(
        df, (64,), min_points=5, max_span_days=35,
        max_timeline_points=100_000, freq_minutes=60,
        max_batch=64, dtype=np.float32, compact=True)
    assert len(packed.batches) == 1
    b = packed.batches[0]
    got = dict(zip(b.symbols, b.const_cols["strike"]))
    assert got == {"a": 24000.0, "b": 26000.0}
    gotcp = dict(zip(b.symbols, b.const_cols["callput"]))
    assert gotcp == {"a": "c", "b": "p"}
    # padding slots stay None
    assert all(v is None for v in b.const_cols["strike"][len(b.symbols):])


def test_head_extrapolation_survives_max_gap():
    """extrapolate=True + max_gap together (pipeline/tasks.py passes
    both): head extrapolation must survive the gap check — the
    fabricated has_prev used to count the pre-first-observation region
    as a 'bridged' gap and NaN it whenever the first observation sat
    more than max_gap into the timeline (round-4 review). Tail behavior
    (never gap-checked) is unchanged."""
    L = 100
    vals = np.full(L, np.nan)
    vals[45], vals[50] = 10.0, 20.0  # first obs at minute 45
    got = np.asarray(masked_interp(
        jnp.array(vals), jnp.ones(L, bool), method="linear",
        max_gap_minutes=30, extrapolate=True))
    # head: extrapolated through (45, 10) and (50, 20), slope 2
    np.testing.assert_allclose(got[0], 10.0 - 45 * 2.0, rtol=1e-6)
    np.testing.assert_allclose(got[44], 10.0 - 2.0, rtol=1e-6)
    # interior bridged gap of 5 <= 30: interpolated
    np.testing.assert_allclose(got[47], 14.0, rtol=1e-6)
    # tail extrapolation unchanged
    np.testing.assert_allclose(got[60], 20.0 + 10 * 2.0, rtol=1e-6)
    # a genuinely too-wide INTERIOR gap still NaNs
    vals2 = np.full(L, np.nan)
    vals2[0], vals2[80] = 1.0, 2.0
    got2 = np.asarray(masked_interp(
        jnp.array(vals2), jnp.ones(L, bool), method="linear",
        max_gap_minutes=30, extrapolate=True))
    assert np.isnan(got2[40])


def test_scatter_observations_duplicates_keep_last():
    """Duplicate grid positions resolve deterministically to the LAST
    valid observation (XLA scatter with repeated indices is otherwise
    implementation-defined — round-4 review)."""
    pos = jnp.array([3, 5, 3, 7, 3])
    vals = jnp.array([1.0, 2.0, 3.0, 4.0, 5.0])
    valid = jnp.array([True, True, True, True, True])
    g = np.asarray(scatter_observations(pos, vals, valid, 10))
    assert g[3] == 5.0 and g[5] == 2.0 and g[7] == 4.0
    # an invalid last duplicate does not win
    valid2 = jnp.array([True, True, True, True, False])
    g2 = np.asarray(scatter_observations(pos, vals, valid2, 10))
    assert g2[3] == 3.0


def test_pack_symbols_string_dates_sort_chronologically():
    """A STRING date column sorts lexicographically ('10/...' < '9/...'),
    which used to leave obs_min unsorted — negative rel positions
    wrapped the grid scatter to the wrong end of the timeline (round-4
    review). pack_symbols now sorts on the computed ns timestamps, so a
    string-dated frame packs identically to the datetime-typed one."""
    from iv_engine.pipeline import ingest

    dates = pd.date_range("2024-09-30 10:00", periods=12, freq="3h")
    df_dt = pd.DataFrame({
        "symbol": "a", "date": dates, "iv": np.linspace(0.4, 0.5, 12),
        "underlying_price": np.linspace(100, 105, 12),
    })
    # month-first US strings: '10/1/2024 ...' sorts before '9/30/...'
    df_str = df_dt.copy()
    df_str["date"] = [
        f"{d.month}/{d.day}/{d.year} {d.strftime('%H:%M')}"
        for d in dates]
    df_str = df_str.sample(frac=1.0, random_state=3)  # scrambled input

    packs = {}
    for name, frame in (("dt", df_dt), ("str", df_str)):
        packed = ingest.pack_symbols(
            frame, (1 << 14,), min_points=5, max_span_days=35,
            max_timeline_points=100_000, freq_minutes=60,
            max_batch=64, dtype=np.float64, compact=False)
        assert not packed.skipped, packed.skipped
        packs[name] = packed.batches[0]

    a, b = packs["dt"], packs["str"]
    assert list(a.t0_minutes) == list(b.t0_minutes)
    np.testing.assert_array_equal(np.asarray(a.values),
                                  np.asarray(b.values))
    np.testing.assert_array_equal(np.asarray(a.obs_mask),
                                  np.asarray(b.obs_mask))
