"""Jitted stage kernels over packed batches — the device side of the
three pipeline stages (Task 1 / bridge / Task 2).

Each function is one fused XLA computation over a ``(B, C, L)`` bucket
batch; orchestration, storage and manifest bookkeeping live in
``pipeline.runner``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from iv_engine.ops.black_scholes import bs_greeks
from iv_engine.ops.bridge import BridgeParams, synthesize_ohlcv
from iv_engine.ops.interp import masked_interp
from iv_engine.ops.segment_ohlcv import Candles, aggregate_ohlcv
from iv_engine.pipeline.columns import ALL_COLS, INTERP_COLS

_N_INTERP = len(INTERP_COLS)
_IV, _UP, _TTM = 0, 1, 2
_RATE = ALL_COLS.index("interest_rate")
_VOLUME = ALL_COLS.index("volume")


@partial(jax.jit, static_argnames=("B", "C", "L"))
def scatter_batch(obs_vals: jax.Array, obs_row: jax.Array,
                  obs_pos: jax.Array, valid_len: jax.Array,
                  *, B: int, C: int, L: int):
    """Compact observations -> dense (B, C, L) NaN grid + masks, built on
    device. The host ships only the (N, C) observation block instead of a
    mostly-empty grid (PackedBatch compact form); padding entries carry
    the out-of-range row sentinel obs_row == B and are dropped.

    Returns (values, obs_mask, timeline_mask)."""
    # (row, pos) pairs are unique and lexicographically sorted (the
    # packer emits row-major runs; padding rows carry the max sentinel).
    # The hints matter: an unhinted scatter can lower to a serial path
    # (measured 90s vs sub-second for this exact shape on the earlier
    # accelerator).
    grid = jnp.full((B, C, L), jnp.nan, obs_vals.dtype)
    grid = grid.at[obs_row, :, obs_pos].set(
        obs_vals, mode="drop", unique_indices=True,
        indices_are_sorted=True)
    obs_mask = jnp.zeros((B, L), bool).at[obs_row, obs_pos].set(
        True, mode="drop", unique_indices=True, indices_are_sorted=True)
    timeline_mask = jnp.arange(L)[None, :] < valid_len[:, None]
    return grid, obs_mask, timeline_mask


@partial(jax.jit, static_argnames=("method", "max_gap_minutes",
                                   "compute_greeks", "extrapolate"))
def interpolate_batch(values: jax.Array, obs_mask: jax.Array,
                      timeline_mask: jax.Array,
                      strike: jax.Array, is_call: jax.Array,
                      method: str = "linear", max_gap_minutes: int = 0,
                      compute_greeks: bool = True,
                      extrapolate: bool = False,
                      obs_pos: jax.Array | None = None):
    """Task-1 kernel: fill the minute grid for a batch of symbols.

    Args:
      values: (B, C, L) with C = ALL_COLS (first 3 interpolated, rest
        forward-filled — reference core.py:58-68).
      obs_mask / timeline_mask: (B, L) bools.
      strike: (B,) strike per symbol (NaN if unknown).
      is_call: (B,) bool per symbol.

    Returns dict:
      filled (B, C, L); valid (B, L) rows that survive the reference's
      dropna (core.py:74); is_interpolated (B, L) with *fixed* semantics
      (SURVEY.md §2.1.2); greeks dict of (B, L) arrays (all-NaN when
      inputs are missing) — populating the columns the reference reserved
      but never filled (schema.py:36-41).
    """
    if method == "cubic":
        # spline through the observation grid (pandas method='cubic'
        # parity; requires uniform observation count per batch — the
        # runner sub-buckets by count). Columns must be NaN-free at the
        # observations; the runner validates and falls back to linear.
        from iv_engine.ops.interp import cubic_resample
        if obs_pos is None:
            raise ValueError("method='cubic' requires obs_pos")
        L = values.shape[-1]
        vals_at_obs = jnp.take_along_axis(
            values[:, :_N_INTERP], obs_pos[:, None, :], axis=-1)
        interp_part = cubic_resample(
            jnp.broadcast_to(obs_pos[:, None, :], vals_at_obs.shape),
            vals_at_obs, L)
        interp_part = jnp.where(timeline_mask[:, None], interp_part,
                                jnp.nan)
    else:
        interp_part = masked_interp(values[:, :_N_INTERP],
                                    timeline_mask[:, None],
                                    method=method,
                                    max_gap_minutes=max_gap_minutes,
                                    extrapolate=extrapolate)
    ffill_part = masked_interp(values[:, _N_INTERP:], timeline_mask[:, None],
                               method="ffill")
    filled = jnp.concatenate([interp_part, ffill_part], axis=1)

    valid = (timeline_mask
             & jnp.isfinite(filled[:, _IV])
             & jnp.isfinite(filled[:, _UP])
             & jnp.isfinite(filled[:, _TTM]))
    is_interpolated = valid & ~obs_mask

    out = {"filled": filled, "valid": valid,
           "is_interpolated": is_interpolated}
    if compute_greeks:
        S = filled[:, _UP]
        sigma = filled[:, _IV]
        T = filled[:, _TTM]
        r = jnp.nan_to_num(filled[:, _RATE], nan=0.0)
        K = strike[:, None]
        g = bs_greeks(S, K, jnp.maximum(T, 1e-12), r,
                      jnp.maximum(sigma, 1e-12), is_call[:, None])
        nan = jnp.asarray(jnp.nan, filled.dtype)
        ok = valid & jnp.isfinite(K) & (T > 0) & (sigma > 0)
        out["greeks"] = {name: jnp.where(ok, arr, nan)
                         for name, arr in g.items()}
    return out


@partial(jax.jit, static_argnames=("strategy",))
def bridge_batch(filled: jax.Array, valid: jax.Array, keys: jax.Array,
                 params: BridgeParams = BridgeParams(),
                 price_col: jax.Array | None = None,
                 strategy: str = "spread_simulation",
                 abs_minutes: jax.Array | None = None):
    """Bridge kernel: interpolated grids -> synthetic 1-min OHLCV grids.

    ``price_col``: (B,) int index into ALL_COLS choosing each symbol's
    price source (the reference's underlying->mark->index priority rule,
    ohlcv_converter.py:189-207, computed host-side from non-null ratios).
    Defaults to underlying_price for all symbols.

    ``abs_minutes``: (B, L) absolute epoch minutes of the grid rows —
    draws key on them so a minute's candle is grid-alignment-independent
    (staged/fused/resume byte parity; see ops.bridge module docstring).
    """
    B = filled.shape[0]
    if price_col is None:
        price_col = jnp.full((B,), _UP, jnp.int32)
    base = jnp.take_along_axis(
        filled, price_col[:, None, None].astype(jnp.int32), axis=1
    )[:, 0]
    volume = filled[:, _VOLUME]
    if abs_minutes is None:
        abs_minutes = jnp.broadcast_to(
            jnp.arange(filled.shape[-1]), valid.shape)
    return jax.vmap(
        lambda b, v, ok, key, mins: synthesize_ohlcv(
            b, v, ok, key, params=params, strategy=strategy,
            abs_minutes=mins)
    )(base, volume, valid, keys, abs_minutes)


@partial(jax.jit, static_argnames=("num_segments", "min_count"))
def candles_batch(minutes: jax.Array, ohlcv: dict, bucket_minutes: jax.Array,
                  base_bucket: jax.Array, *, num_segments: int,
                  min_count: int) -> Candles:
    """Task-2 kernel: batched 1-min -> N-min aggregation.

    minutes: (B, L) epoch minutes; ohlcv: dict of (B, L) grids (bridge
    output); base_bucket: (B,) first bucket id per symbol.
    """
    return jax.vmap(
        lambda m, o, h, l, c, v, ok, bb: aggregate_ohlcv(
            m, o, h, l, c, v, ok, bucket_minutes, bb,
            num_segments=num_segments, min_count=min_count,
            assume_sorted=True)  # timeline grids are minute aranges
    )(minutes, ohlcv["open"], ohlcv["high"], ohlcv["low"], ohlcv["close"],
      ohlcv["volume"], ohlcv["valid"], base_bucket)


def select_price_columns(values, obs_mask) -> jax.Array:
    """Host/device helper: the reference's price-source priority rule
    (ohlcv_converter.py:189-207): first of underlying/mark/index with
    >=80% non-null among observed rows, else first with any data.

    values: (B, C, L) raw (pre-fill) grids; obs_mask: (B, L).
    Returns (B,) int32 column indices into ALL_COLS.
    """
    idx_up = _UP
    idx_mark = ALL_COLS.index("mark_price")
    idx_index = ALL_COLS.index("index_price")
    n_obs = jnp.maximum(obs_mask.sum(-1), 1)

    def frac(c):
        return (jnp.isfinite(values[:, c]) & obs_mask).sum(-1) / n_obs

    f_up, f_mark, f_index = frac(idx_up), frac(idx_mark), frac(idx_index)
    cols = jnp.asarray([idx_up, idx_mark, idx_index], jnp.int32)
    fracs = jnp.stack([f_up, f_mark, f_index], axis=-1)  # (B, 3)
    good = fracs >= 0.8
    any_data = fracs > 0.0
    # first good; else first with any data; else underlying
    first_good = jnp.argmax(good, axis=-1)
    has_good = jnp.any(good, axis=-1)
    first_any = jnp.argmax(any_data, axis=-1)
    has_any = jnp.any(any_data, axis=-1)
    choice = jnp.where(has_good, first_good,
                       jnp.where(has_any, first_any, 0))
    return cols[choice]
