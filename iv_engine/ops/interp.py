"""Masked timeline interpolation — the Task-1 compute core.

Device-native replacement for the reference's per-symbol pandas resampling
(src/interpolation/core.py:16-81). The reference built a 1-minute
``pd.date_range`` timeline, left-merged hourly observations onto it, ran
``Series.interpolate`` per numeric column and ``ffill`` per categorical
column. Here the timeline is a fixed-shape padded grid (static shapes for
XLA; ragged symbols are length-bucketed), observations are scattered onto
it, and filling is pure index arithmetic:

  * ``prev_idx[i]`` = last valid slot <= i   (``lax.cummax``)
  * ``next_idx[i]`` = first valid slot >= i  (reverse ``lax.cummin``)

which makes linear/nearest/ffill interpolation a pair of gathers plus
element-wise math — one fused XLA computation over the whole
``(columns, timeline)`` block, vmappable over thousands of symbols.

Pandas-parity semantics (tested in tests/test_interp.py):
  * interior NaNs: linear by grid position (== linear in time on a uniform
    minute grid, matching ``Series.interpolate(method='linear')``);
  * leading NaNs stay NaN (pandas ``limit_direction='forward'`` default);
  * trailing NaNs hold the last valid value;
  * ``is_interpolated`` is True exactly on synthesized rows — the
    *intended* semantics; the reference computed it after ffill so it was
    always False (defect, SURVEY.md §2.1.2).

The ``max_gap_minutes`` knob masks (leaves NaN) any grid point whose
bracketing observations are further apart than the gap — the wiring the
reference's ``max_gap_hours`` config promised but never had
(SURVEY.md §2.1.5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _prev_next_valid(valid: jax.Array):
    """Indices of previous/next valid slots along the last axis.

    Returns (prev_idx, next_idx) where prev_idx[i] is the largest j<=i with
    valid[j] (or -1), next_idx[i] the smallest j>=i with valid[j] (or L).
    """
    L = valid.shape[-1]
    ax = valid.ndim - 1
    iota = jnp.arange(L)
    prev_idx = jax.lax.cummax(jnp.where(valid, iota, -1), axis=ax)
    next_idx = jax.lax.cummin(jnp.where(valid, iota, L), axis=ax, reverse=True)
    return prev_idx, next_idx


@partial(jax.jit, static_argnames=("method", "max_gap_minutes",
                                   "extrapolate"))
def masked_interp(values: jax.Array, timeline_mask: jax.Array,
                  method: str = "linear",
                  max_gap_minutes: int = 0,
                  extrapolate: bool = False) -> jax.Array:
    """Fill NaNs in ``values`` along the last (timeline) axis.

    Args:
      values: ``(..., L)`` float array; NaN marks missing samples.
      timeline_mask: ``(..., L)`` bool; False marks padding beyond the
        symbol's actual timeline (those slots stay NaN).
      method: 'linear' | 'nearest' | 'ffill'.
      max_gap_minutes: if > 0, grid points bracketed by observations more
        than this many grid steps apart are left NaN instead of bridged.
      extrapolate: if True (and method == 'linear'), extend linearly
        beyond the first/last valid samples using the two nearest valid
        points — the knob the reference declared but never honoured
        (config.py:45, SURVEY.md §2.1.5). Default False: leading gaps
        stay NaN, trailing gaps hold the last value (pandas parity).
    """
    L = values.shape[-1]
    iota = jnp.arange(L)
    valid = jnp.isfinite(values) & timeline_mask
    prev_idx, next_idx = _prev_next_valid(valid)

    has_prev = prev_idx >= 0
    has_next = next_idx < L
    # the gap check below must see REAL neighbours only: the extrapolate
    # branch fabricates has_prev for the head region, and counting that
    # as a "bridged" gap silently NaN'd head extrapolation whenever the
    # first observation sat more than max_gap into the timeline — while
    # the (never-gap-checked) tail stayed extrapolated (round-4 review)
    real_has_prev, real_has_next = has_prev, has_next
    prev_c = jnp.clip(prev_idx, 0, L - 1)
    next_c = jnp.clip(next_idx, 0, L - 1)
    zeros = jnp.where(valid, values, 0.0)
    prev_val = jnp.take_along_axis(zeros, prev_c, axis=-1)
    next_val = jnp.take_along_axis(zeros, next_c, axis=-1)

    if method == "linear":
        span = (next_idx - prev_idx).astype(values.dtype)
        w = jnp.where(span > 0, (iota - prev_idx).astype(values.dtype) / jnp.where(span > 0, span, 1.0), 0.0)
        interior = prev_val * (1.0 - w) + next_val * w
        filled = jnp.where(has_next, interior, prev_val)  # trailing: hold last
        if extrapolate:
            at = lambda a, i: jnp.take_along_axis(a, i, axis=-1)

            def _slope(i1, i2):
                v1 = at(zeros, jnp.clip(i1, 0, L - 1))
                v2 = at(zeros, jnp.clip(i2, 0, L - 1))
                ok2 = (i2 > i1) & (i2 < L) & (i1 >= 0)
                di = jnp.where(ok2, (i2 - i1).astype(values.dtype), 1.0)
                return jnp.where(ok2, (v2 - v1) / di, 0.0)

            # head: line anchored at the FIRST valid sample, sloped through
            # the second (constant when only one valid point exists)
            i1h = next_idx[..., 0:1]
            i2h = at(next_idx, jnp.clip(i1h + 1, 0, L - 1))
            sh = _slope(i1h, i2h)
            v1h = at(zeros, jnp.clip(i1h, 0, L - 1))
            head = v1h + sh * (iota - i1h).astype(values.dtype)
            # tail: anchored at the LAST valid sample
            i2t = prev_idx[..., L - 1:L]
            i1t = at(prev_idx, jnp.clip(i2t - 1, 0, L - 1))
            st_ = _slope(i1t, i2t)
            v2t = at(zeros, jnp.clip(i2t, 0, L - 1))
            tail = v2t + st_ * (iota - i2t).astype(values.dtype)
            filled = jnp.where(has_prev, filled, head)
            filled = jnp.where(has_next | ~has_prev, filled, tail)
            # fabricate validity for the extrapolated head so the final
            # where() below keeps it (tail already has has_prev)
            has_prev = has_prev | (i1h < L)
    elif method == "nearest":
        dist_prev = iota - prev_idx
        dist_next = next_idx - iota
        take_next = has_next & (~has_prev | (dist_next < dist_prev))
        filled = jnp.where(take_next, next_val, prev_val)
    elif method == "ffill":
        filled = prev_val
    else:
        raise ValueError(f"unknown interpolation method: {method!r}")

    if max_gap_minutes > 0:
        gap = next_idx - prev_idx
        bridged = ~valid & real_has_prev & real_has_next
        too_wide = bridged & (gap > max_gap_minutes)
        filled = jnp.where(too_wide, jnp.nan, filled)

    filled = jnp.where(has_prev & timeline_mask, filled, jnp.nan)
    return jnp.where(valid, values, filled)


@jax.jit
def ffill(values: jax.Array, timeline_mask: jax.Array) -> jax.Array:
    """Forward-fill along the last axis (categorical columns: the reference
    applied ffill to symbol/strike/callput/... at core.py:64-68)."""
    return masked_interp(values, timeline_mask, method="ffill")


def scatter_observations(obs_pos: jax.Array, obs_vals: jax.Array,
                         obs_valid: jax.Array, timeline_len: int) -> jax.Array:
    """Scatter ragged observations onto a dense timeline grid.

    Args:
      obs_pos: ``(K,)`` int grid positions (minutes since timeline start);
        out-of-range or invalid entries must have ``obs_valid`` False.
      obs_vals: ``(..., K)`` values per observation.
      obs_valid: ``(K,)`` bool.
      timeline_len: static grid length L.

    Returns:
      ``(..., L)`` grid with NaN where no observation landed. Matches the
      reference's exact-timestamp left-merge (core.py:54-55): observations
      not aligned to the grid are dropped by the caller (position -1).
      Duplicate positions keep the LAST valid observation
      deterministically — XLA scatter with repeated indices is
      implementation-defined, which made same-minute duplicate quotes
      nondeterministic across backends (round-4 review). (The pipeline
      itself dedups on (symbol, date) at storage-read time; this guard
      protects direct callers.)
    """
    K = obs_pos.shape[-1]
    pos = jnp.where(obs_valid, obs_pos, timeline_len)  # park invalid at L
    # winner per position = highest observation index mapping there
    order = jnp.arange(K, dtype=jnp.int32)
    winner = jnp.full((timeline_len + 1,), -1, jnp.int32) \
        .at[pos].max(order)  # scatter-max: associative, deterministic
    keep = obs_valid & (winner[pos] == order)
    # losers park at L as well — they must not write AT ALL (a loser's
    # NaN racing the winner's value at one index is the same
    # nondeterminism); everything landing at L writes NaN, which is
    # order-free, and the slice below drops it
    pos_w = jnp.where(keep, pos, timeline_len)
    grid = jnp.full(obs_vals.shape[:-1] + (timeline_len + 1,), jnp.nan,
                    dtype=obs_vals.dtype)
    grid = grid.at[..., pos_w].set(jnp.where(keep, obs_vals, jnp.nan))
    return grid[..., :timeline_len]


@partial(jax.jit, static_argnames=("timeline_len",))
def cubic_resample(obs_pos: jax.Array, obs_vals: jax.Array,
                   timeline_len: int) -> jax.Array:
    """Batched cubic-spline resampling onto a dense grid — the 'cubic'
    interpolation method (pandas ``Series.interpolate(method='cubic')``,
    i.e. a not-a-knot cubic spline through the observations; parity-tested
    in tests/test_interp.py).

    Unlike :func:`masked_interp` this takes the observations in ragged->
    dense form directly: ``obs_pos`` (..., k) strictly increasing grid
    positions and ``obs_vals`` (..., k) values, k uniform across the
    batch (length-bucket ragged symbols by observation count). Grid
    points outside [obs_pos[0], obs_pos[-1]] stay NaN (pandas keeps both
    leading and trailing NaN for spline methods).
    """
    from iv_engine.ops.cubic_spline import (
        eval_cubic_spline, fit_cubic_spline)

    x = obs_pos.astype(obs_vals.dtype)
    M = fit_cubic_spline(x, obs_vals, bc_type="not-a-knot")
    t = jnp.arange(timeline_len, dtype=obs_vals.dtype)
    t = jnp.broadcast_to(t, obs_vals.shape[:-1] + (timeline_len,))
    S = eval_cubic_spline(x, obs_vals, M, t)
    inside = (t >= x[..., 0:1]) & (t <= x[..., -1:])
    return jnp.where(inside, S, jnp.nan)
