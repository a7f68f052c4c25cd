"""Sequence parallelism: timeline-sharded masked interpolation.

The reference's only answer to over-long series was to cap them (30-day /
100k-minute guardrails, src/interpolation/core.py:37,49) or to chunk them
*with seams* — its streaming path interpolated each 5,000-row chunk
independently, producing wrong values at chunk boundaries
(src/interpolation/optimized_batch_processor.py:333-360, defect
SURVEY.md §2.1.3). This module is the correct distributed form: the
timeline axis is sharded over mesh devices and each shard exchanges a
tiny boundary summary — (position, value) of its first/last valid sample
— via ``all_gather`` over ICI, which is exactly the information linear
interpolation needs to bridge shard boundaries seamlessly.

Identical numerics to the single-device ``ops.interp.masked_interp``
(parity-tested on the 8-device CPU mesh in tests/test_sequence.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from iv_engine.ops.interp import _prev_next_valid


def _local_fill(values, timeline_mask, offset, L_global,
                prev_in_pos, prev_in_val, next_in_pos, next_in_val,
                method, max_gap_minutes):
    """Fill one shard's chunk given global carry-in boundary state.

    values/timeline_mask: (..., Lc); offset: scalar global start of chunk;
    *_in_*: (...,) carry state from neighbouring shards (global positions).
    """
    Lc = values.shape[-1]
    iota = jnp.arange(Lc)
    valid = jnp.isfinite(values) & timeline_mask
    lp, ln = _prev_next_valid(valid)

    zeros = jnp.where(valid, values, 0.0)
    lp_c = jnp.clip(lp, 0, Lc - 1)
    ln_c = jnp.clip(ln, 0, Lc - 1)
    lp_val = jnp.take_along_axis(zeros, lp_c, axis=-1)
    ln_val = jnp.take_along_axis(zeros, ln_c, axis=-1)

    has_lp = lp >= 0
    has_ln = ln < Lc
    prev_pos = jnp.where(has_lp, lp + offset, prev_in_pos[..., None])
    prev_val = jnp.where(has_lp, lp_val, prev_in_val[..., None])
    next_pos = jnp.where(has_ln, ln + offset, next_in_pos[..., None])
    next_val = jnp.where(has_ln, ln_val, next_in_val[..., None])

    has_prev = prev_pos >= 0
    has_next = next_pos < L_global
    gpos = iota + offset

    if method == "linear":
        span = (next_pos - prev_pos).astype(values.dtype)
        w = jnp.where(span > 0,
                      (gpos - prev_pos).astype(values.dtype)
                      / jnp.where(span > 0, span, 1.0), 0.0)
        interior = prev_val * (1.0 - w) + next_val * w
        filled = jnp.where(has_next, interior, prev_val)
    elif method == "ffill":
        filled = prev_val
    else:
        raise ValueError(f"unsupported sharded method: {method!r}")

    if max_gap_minutes > 0:
        gap = next_pos - prev_pos
        bridged = ~valid & has_prev & has_next
        filled = jnp.where(bridged & (gap > max_gap_minutes), jnp.nan,
                           filled)

    filled = jnp.where(has_prev & timeline_mask, filled, jnp.nan)
    return jnp.where(valid, values, filled)


@partial(jax.jit, static_argnames=("mesh", "axis_name", "method",
                                   "max_gap_minutes"))
def sharded_masked_interp(values: jax.Array, timeline_mask: jax.Array,
                          mesh: Mesh, axis_name: str = "data",
                          method: str = "linear",
                          max_gap_minutes: int = 0) -> jax.Array:
    """masked_interp with the trailing (timeline) axis sharded over
    ``axis_name``. Batch/column axes are replicated; shard them separately
    if desired by composing with an outer pjit.

    values: (..., L) with L divisible by the mesh axis size.
    """
    L = values.shape[-1]
    ndev = mesh.shape[axis_name]
    if L % ndev:
        raise ValueError(f"timeline {L} not divisible by mesh axis {ndev}")
    Lc = L // ndev

    def shard_fn(vals, mask):
        # vals/mask: (..., Lc) local chunk
        d = jax.lax.axis_index(axis_name)
        offset = d * Lc
        valid = jnp.isfinite(vals) & mask
        # shard boundary summary: last/first valid (global pos, value)
        any_valid = jnp.any(valid, axis=-1)
        last_loc = (Lc - 1) - jnp.argmax(jnp.flip(valid, -1), axis=-1)
        first_loc = jnp.argmax(valid, axis=-1)

        def take(i):
            # gather the (zero-masked) local values at per-row index i
            return jnp.take_along_axis(
                jnp.where(valid, vals, 0.0), i[..., None], axis=-1)[..., 0]

        last_pos = jnp.where(any_valid, last_loc + offset, -1)
        last_val = jnp.where(any_valid, take(last_loc), 0.0)
        first_pos = jnp.where(any_valid, first_loc + offset, L)
        first_val = jnp.where(any_valid, take(first_loc), 0.0)

        # positions ride their OWN int32 all_gather: round-tripping them
        # through vals.dtype corrupted them for half precision (bf16 is
        # integer-exact only to 256) and for f32 timelines beyond 2^24
        # (round-4 review)
        pos_summary = jnp.stack([last_pos, first_pos],
                                axis=0).astype(jnp.int32)    # (2, ...)
        val_summary = jnp.stack([last_val, first_val], axis=0)
        g_pos = jax.lax.all_gather(pos_summary, axis_name)   # (ndev, 2, ...)
        g_val = jax.lax.all_gather(val_summary, axis_name)
        g_last_pos, g_first_pos = g_pos[:, 0], g_pos[:, 1]
        g_last_val, g_first_val = g_val[:, 0], g_val[:, 1]

        shard_ids = jnp.arange(ndev).reshape((ndev,) + (1,) *
                                             (g_last_pos.ndim - 1))
        # carry-in prev: the last valid sample in any shard before d —
        # positions grow with shard id, so take the max over earlier shards
        before = shard_ids < d
        prev_masked = jnp.where(before, g_last_pos, -1)
        prev_pos = jnp.max(prev_masked, axis=0)
        sel_prev = jnp.argmax(prev_masked, axis=0)
        prev_val = jnp.take_along_axis(g_last_val, sel_prev[None], axis=0)[0]
        # carry-in next: first valid sample in any shard after d
        after = shard_ids > d
        next_masked = jnp.where(after, g_first_pos, L)
        next_pos = jnp.min(next_masked, axis=0)
        sel_next = jnp.argmin(next_masked, axis=0)
        next_val = jnp.take_along_axis(g_first_val, sel_next[None], axis=0)[0]

        return _local_fill(vals, mask, offset, L,
                           prev_pos, prev_val,
                           next_pos, next_val,
                           method, max_gap_minutes)

    nbatch = values.ndim - 1
    spec = P(*([None] * nbatch), axis_name)
    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(spec, spec),
        out_specs=spec,
    )(values, timeline_mask)
