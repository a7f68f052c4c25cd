"""Streaming fused pipeline: ticks -> candles -> surface refit, one jit.

North-star config #5 (BASELINE.json): "Streaming pipeline: tick->candle
reconstruction->refit 1k underlyings' surfaces per batch". The reference
round-tripped every stage through PostgreSQL (SURVEY.md §3.5 — its
"central performance sin"); here the full chain is a single XLA
computation over device-resident buffers: no host transfer between
stages, and the only outputs are the refit surface grids + diagnostics.

Stages (all batched over underlyings):
  1. tick -> 1-min OHLCV      (segment reduction over tick timestamps)
  2. 1-min -> 5-min OHLCV     (segment reduction, incomplete-bucket mask)
  3. realized vol from 5-min closes (annualised root-mean log-return)
  4. surface refit: the underlying's quote surface re-scaled by the
     realized/implied ratio, then cubic-spline fit + dense-grid eval +
     butterfly/calendar diagnostics.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from iv_engine.ops.segment_ohlcv import aggregate_ohlcv
from iv_engine.surface.surface import fit_eval_surface

MINUTES_PER_YEAR = 365.25 * 24 * 60


class StreamingOut(NamedTuple):
    w_grid: jax.Array          # (B, E, m) refit total variance
    iv_grid: jax.Array         # (B, E, m)
    realized_vol: jax.Array    # (B,) annualised realized vol
    butterfly_ok: jax.Array    # (B,)
    calendar_ok: jax.Array     # (B,)
    candles_1m: object         # Candles pytree (B, L1)
    candles_5m: object         # Candles pytree (B, L5)


def _aggregate(minute, o, h, l, c, v, valid, *, bucket_minutes,
               num_segments, min_count):
    """(B, L) bars -> (B, num_segments) candles. Segment reductions, not
    the sorted path: on the GPU they are 10x faster inside this step and
    sum each bucket directly (PERF.md "Streaming aggregation")."""
    return jax.vmap(
        lambda m, o_, h_, l_, c_, v_, ok: aggregate_ohlcv(
            m, o_, h_, l_, c_, v_, ok, jnp.int32(bucket_minutes),
            jnp.int32(0), num_segments=num_segments, min_count=min_count)
    )(minute, o, h, l, c, v, valid)


@partial(jax.jit, static_argnames=("n_minutes", "bucket_minutes", "n_grid",
                                   "spline_bc"))
def streaming_step(tick_minute: jax.Array, tick_price: jax.Array,
                   tick_size: jax.Array, tick_valid: jax.Array,
                   chain_k: jax.Array, chain_iv: jax.Array,
                   chain_T: jax.Array, *, n_minutes: int = 512,
                   bucket_minutes: int = 5, n_grid: int = 50,
                   spline_ops=None,
                   spline_bc: str = "not-a-knot") -> StreamingOut:
    """One streaming batch: refit every underlying's surface from ticks.

    PRECONDITION: valid tick rows must be time-sorted per underlying
    (ascending ``tick_minute``; invalid rows may sit anywhere and carry
    anything): open/close are the first/last valid row of each bucket.
    High/low/volume/count do not depend on row order.
    ``StreamingSession`` sorts its ring windows before calling; direct
    callers with unordered ticks must sort first (see
    ``stream_service._sort_window_by_minute``).

    Args:
      tick_minute: (B, L) int minutes-from-window-start per tick.
      tick_price:  (B, L) trade prices.
      tick_size:   (B, L) trade sizes.
      tick_valid:  (B, L) bool.
      chain_k/iv/T: (B, E, n) / (B, E, n) / (B, E) quote surfaces.
      n_minutes: static window length in minutes.
      spline_ops: optional precomputed per-underlying SplineOperator
        stack ((B, E, n, n_grid) tensors, from
        ``ops.spline_matrix.build_surface_operators_batched`` on the
        session's fixed quote grids) — the refit becomes a single
        einsum instead of a tridiagonal solve + piecewise eval.
      spline_bc: cubic boundary condition for the ``spline_ops=None``
        fallback refit ('not-a-knot' default, matching
        ``StreamingSession``'s operator default, so both paths produce
        the same diagnostics; pass 'natural' for fit_surface parity).
        Ignored when ``spline_ops`` is given (the operators already
        encode their bc).
    """
    n5 = n_minutes // bucket_minutes + 1
    # 1) ticks -> 1-min candles (open=first/high=max/low=min/close=last)
    c1 = _aggregate(tick_minute, tick_price, tick_price, tick_price,
                    tick_price, tick_size, tick_valid, bucket_minutes=1,
                    num_segments=n_minutes, min_count=1)
    # 2) 1-min -> 5-min
    minutes_1m = jnp.broadcast_to(jnp.arange(n_minutes, dtype=jnp.int32),
                                  c1.open.shape)
    c5 = _aggregate(minutes_1m, c1.open, c1.high, c1.low, c1.close,
                    c1.volume, c1.valid, bucket_minutes=bucket_minutes,
                    num_segments=n5, min_count=bucket_minutes)

    # 3) realized vol from 5-min closes (masked log returns)
    close = c5.close
    ok = c5.valid
    pair_ok = ok[..., 1:] & ok[..., :-1]
    safe = jnp.where(ok, jnp.maximum(close, 1e-12), 1.0)
    lr = jnp.where(pair_ok, jnp.log(safe[..., 1:] / safe[..., :-1]), 0.0)
    n_pairs = pair_ok.sum(-1)
    n_ret = jnp.maximum(n_pairs, 1)
    var_per_bar = (lr * lr).sum(-1) / n_ret
    realized = jnp.sqrt(var_per_bar * (MINUTES_PER_YEAR / bucket_minutes))

    # 4) refit: blend quote IVs toward the realized level at the money.
    # An underlying with ZERO in-window return pairs (quiet name, refit
    # before its first tick) keeps its quoted surface (scale 1) — its
    # realized=0 is "no data", not "volatility is zero", and blending
    # toward it halved the whole surface (round-4 review)
    atm_idx = jnp.argmin(jnp.abs(chain_k), axis=-1, keepdims=True)
    atm_iv = jnp.take_along_axis(chain_iv, atm_idx, axis=-1)
    has_data = (n_pairs > 0)[:, None, None]
    scale = jnp.where(has_data & (atm_iv > 1e-6),
                      1.0 + 0.5 * (realized[:, None, None] / jnp.maximum(
                          atm_iv, 1e-6) - 1.0),
                      1.0)
    iv_new = chain_iv * jnp.clip(scale, 0.25, 4.0)
    if spline_ops is not None:
        from iv_engine.ops.spline_matrix import (
            fit_eval_surface_grid_batched)
        res = fit_eval_surface_grid_batched(spline_ops, iv_new, chain_T)
    else:
        res = fit_eval_surface(chain_k, iv_new, chain_T, n_grid=n_grid,
                               spline_bc=spline_bc)

    return StreamingOut(
        w_grid=res["w_grid"], iv_grid=res["iv_grid"],
        realized_vol=realized,
        butterfly_ok=res["butterfly_ok"], calendar_ok=res["calendar_ok"],
        candles_1m=c1, candles_5m=c5,
    )
