"""Synthetic-OHLCV bridge — interpolated point prices -> 1-minute candles.

Device-native replacement for the reference's data bridge
(src/data_bridge/ohlcv_converter.py:138-369): the reference looped over
rows in Python, drawing from the *global* NumPy RNG per row (irreproducible
under parallelism, SURVEY.md §7.3); here all draws come from counter-based
``jax.random`` keys derived from ``(seed, series index, absolute epoch
minute)``, so results are deterministic, order-independent AND
grid-alignment-independent — a candle's draws depend only on (seed,
symbol, minute), never on where that minute lands in the packed grid.
That last property is what makes the staged and fused pipelines
byte-identical even when task 1 drops leading-invalid rows (the stored
grid then starts later than the in-memory one), and makes resumed runs
with different windows rewrite identical rows. The whole series is one
fused XLA computation.

The only sequential dependence in the reference is the trend term
(ohlcv_converter.py:224-227): the spread-simulation close obeys

    close[t] = base[t] + off[t] + 0.5 * 0.3 * (base[t] - close[t-1])

a first-order linear recurrence ``close[t] = a[t] + m * close[t-1]``,
solved here in O(log L) with ``jax.lax.associative_scan`` rather than a
Python loop. Invalid rows (NaN/non-positive price — skipped by the
reference's ``continue`` at :157-158) pass the carry through unchanged
(m=1, a=0), reproducing "previous *valid* candle" semantics.

Strategies (dispatch mirrors ohlcv_converter.py:161-169):
  * ``spread_simulation``  randomized spread + 30% trend continuation
  * ``price_midpoint``     symmetric +/- spread/2 around the point price
  * ``trend_following``    5-candle lookback trend (sequential scan)
  * ``simple_spread``      open = base, fixed 0.1% band (fallback)
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class BridgeParams(NamedTuple):
    base_spread_percent: float = 0.002
    volatility_factor: float = 1.5
    min_spread_percent: float = 0.0005
    trend_strength: float = 0.6
    base_volume: float = 50.0


def _round(x, decimals):
    # reference rounds prices to 4 dp and volume to 6 dp
    # (ohlcv_converter.py:255-259)
    f = 10.0 ** decimals
    return jnp.round(x * f) / f


def _linear_recurrence(m: jax.Array, a: jax.Array) -> jax.Array:
    """Solve x[t] = a[t] + m[t] * x[t-1] (x[-1] treated as 0) in O(log L).

    Composition of affine maps is associative:
    (m1,a1) then (m2,a2) == (m2*m1, a2 + m2*a1).
    """
    def combine(left, right):
        m1, a1 = left
        m2, a2 = right
        return m2 * m1, a2 + m2 * a1

    _, x = jax.lax.associative_scan(combine, (m, a), axis=-1)
    return x


def _per_minute_keys(stream_key, abs_minutes):
    """(L,) independent keys: one per absolute epoch minute. fold_in is
    the counter-based derivation — same (stream, minute) -> same key in
    every process, window, and grid alignment."""
    return jax.vmap(jax.random.fold_in, (None, 0))(
        stream_key, abs_minutes.astype(jnp.uint32))


def _process_volume(volume, key, base_volume, abs_minutes):
    """Reference _process_volume (ohlcv_converter.py:359-369): keep positive
    volumes, impute Exponential(base) draws for missing/non-positive."""
    ks = _per_minute_keys(key, abs_minutes)
    imputed = jax.vmap(
        lambda k: jax.random.exponential(k, (), volume.dtype))(ks) \
        * base_volume
    have = jnp.isfinite(volume) & (volume > 0)
    return jnp.where(have, volume, imputed)


@partial(jax.jit, static_argnames=("strategy",))
def synthesize_ohlcv(base_price: jax.Array, volume: jax.Array,
                     valid: jax.Array, key: jax.Array,
                     params: BridgeParams = BridgeParams(),
                     strategy: str = "spread_simulation",
                     abs_minutes: jax.Array | None = None):
    """Generate synthetic 1-minute OHLCV from interpolated point prices.

    Args:
      base_price: ``(L,)`` interpolated price series (the reference picks
        underlying/mark/index by the 80%-non-null priority rule at
        :189-207 — that column selection lives in the pipeline layer).
      volume: ``(L,)`` source volume (NaN/<=0 -> imputed).
      valid: ``(L,)`` bool mask (padding and rows the reference skipped).
      key: jax PRNG key for this series.
      params: spread/trend/volume parameters (config ``data_bridge.*``).
      strategy: one of the four reference strategies.
      abs_minutes: ``(L,)`` absolute epoch minutes of the grid rows.
        Draws are keyed on them, so a minute's candle is identical no
        matter where the grid starts (staged/fused/resume parity —
        see module docstring). Defaults to ``arange(L)`` (standalone
        use: deterministic, relative alignment).

    Returns:
      dict of ``(L,)`` arrays: open/high/low/close/volume plus ``valid``
      (rows with non-positive/NaN base price are marked invalid, matching
      the reference's skip at :157-158).
    """
    L = base_price.shape[-1]
    dtype = base_price.dtype
    ok = valid & jnp.isfinite(base_price) & (base_price > 0)
    base = jnp.where(ok, base_price, 1.0)  # keep math finite on dead rows

    if abs_minutes is None:
        abs_minutes = jnp.arange(L)
    k_vol, k1, k2, k3, k4, k5 = jax.random.split(key, 6)

    def u(k, lo, hi):
        ks = _per_minute_keys(k, abs_minutes)
        return jax.vmap(
            lambda kk: jax.random.uniform(kk, (), dtype, lo, hi))(ks)

    if strategy == "spread_simulation":
        vol_mult = u(k1, 0.5, params.volatility_factor)
        spread = base * params.base_spread_percent * vol_mult
        o_off = u(k2, -1.0, 1.0) * (spread / 3.0)
        c_off = u(k3, -1.0, 1.0) * (spread / 3.0)
        # trend_bias = 0.3 * (base - prev_close); open += 0.2*tb, close += 0.5*tb
        # close recurrence: close = base + c_off + 0.15*base - 0.15*prev_close
        first_ok = jnp.argmax(ok)  # first valid row has trend_bias = 0
        is_first = jnp.arange(L) == first_ok
        m = jnp.where(ok & ~is_first, jnp.asarray(-0.15, dtype), 1.0)
        a = jnp.where(
            ok,
            jnp.where(is_first, base + c_off, base + c_off + 0.15 * base),
            0.0,
        )
        close = _linear_recurrence(m, a)
        prev_close = jnp.concatenate(
            [close[..., :1], close[..., :-1]], axis=-1
        )
        trend_bias = jnp.where(is_first, 0.0, 0.3 * (base - prev_close))
        open_ = base + o_off + 0.2 * trend_bias
        high = jnp.maximum(open_, close) + u(k4, 0.0, 1.0) * (spread / 2.0)
        low = jnp.minimum(open_, close) - u(k5, 0.0, 1.0) * (spread / 2.0)
        # minimum-spread enforcement (ohlcv_converter.py:245-247)
        mid_oc = (open_ + close) / 2.0
        narrow = (high - low) < base * params.min_spread_percent
        half = base * (params.min_spread_percent / 2.0)
        high = jnp.where(narrow, mid_oc + half, high)
        low = jnp.where(narrow, mid_oc - half, low)
    elif strategy == "price_midpoint":
        spread = base * 0.001  # fixed 0.1% (ohlcv_converter.py:268)
        open_ = base + u(k1, -1.0, 1.0) * (spread / 4.0)
        close = base + u(k2, -1.0, 1.0) * (spread / 4.0)
        high = base + spread / 2.0
        low = base - spread / 2.0
    elif strategy == "trend_following":
        noise = jax.vmap(
            lambda kk: jax.random.normal(kk, (), dtype))(
            _per_minute_keys(k1, abs_minutes)) * (base * 0.001)
        open_, close, trend = _trend_following_scan(base, noise, ok,
                                                    params.trend_strength)
        # high/low asymmetric by trend sign (ohlcv_converter.py:312-317)
        up = trend > 0
        high = jnp.maximum(open_, close) + jnp.abs(trend) * jnp.where(up, 0.5, 0.2)
        low = jnp.minimum(open_, close) - jnp.abs(trend) * jnp.where(up, 0.2, 0.5)
    elif strategy == "simple_spread":
        spread = base * 0.001
        open_ = base
        close = base + u(k1, -1.0, 1.0) * (spread / 2.0)
        high = base + spread / 2.0
        low = base - spread / 2.0
    else:
        raise ValueError(f"unknown conversion strategy: {strategy!r}")

    vol = _process_volume(volume, k_vol,
                          jnp.asarray(params.base_volume, dtype),
                          abs_minutes)
    nan = jnp.asarray(jnp.nan, dtype)
    out = {
        "open": jnp.where(ok, _round(open_, 4), nan),
        "high": jnp.where(ok, _round(high, 4), nan),
        "low": jnp.where(ok, _round(low, 4), nan),
        "close": jnp.where(ok, _round(close, 4), nan),
        "volume": jnp.where(ok, _round(vol, 6), 0.0),
        "valid": ok,
    }
    return out


def _trend_following_scan(base, noise, ok, trend_strength):
    """Sequential 5-close-lookback trend (ohlcv_converter.py:292-309).

    The order-5 recurrence is kept as a lax.scan: each step is element-wise
    over the (vmapped) symbol batch, so the vector units stay wide.
    """
    L = base.shape[-1]

    def step(carry, inputs):
        closes = carry  # (5,) most recent closes, oldest first
        b, nz, o = inputs
        n_valid = jnp.sum(jnp.isfinite(closes))
        trend = jnp.where(
            n_valid > 1,
            (closes[-1] - _first_finite(closes)) / jnp.maximum(n_valid, 1),
            0.0,
        )
        open_ = b + trend * trend_strength + nz
        close = b + trend * trend_strength * 1.2 + nz
        new_closes = jnp.where(
            o, jnp.concatenate([closes[1:], close[None]]), closes
        )
        return new_closes, (open_, close, trend)

    init = jnp.full((5,), jnp.nan, base.dtype)
    _, (opens, closes, trends) = jax.lax.scan(step, init, (base, noise, ok))
    return opens, closes, trends


def _first_finite(x):
    idx = jnp.argmax(jnp.isfinite(x))
    return x[idx]


@jax.jit
def validate_bridge_quality(open_, high, low, close, source_price, valid,
                            max_spread_frac=0.1):
    """Vectorised quality gate (reference _validate_ohlcv_quality,
    ohlcv_converter.py:371-402): OHLC relations, spread <=
    ``max_spread_frac`` of source price (the reference hardcoded 10%),
    strictly positive prices. Returns (all_ok, per-row ok)."""
    rel = (high >= low) & (high >= open_) & (high >= close) \
        & (low <= open_) & (low <= close)
    spread_ok = (high - low) <= max_spread_frac * source_price
    positive = (open_ > 0) & (high > 0) & (low > 0) & (close > 0)
    ok = (~valid) | (rel & spread_ok & positive)
    return jnp.all(ok), ok
