"""Streaming session: long-running tick ingestion + periodic surface refit.

The operational wrapper around the fused device chain
(``pipeline.streaming.streaming_step``) and the device-resident ring buffers
(``pipeline.ringbuffer``): ticks stream in per underlying, land in a
device-resident tick ring (donated in-place updates), and ``refit()``
re-derives candles, realized vol and arbitrage-checked surfaces for every
underlying in one jit — the serving-shaped version of what the reference
could only do as a nightly batch through PostgreSQL (SURVEY.md §3.5).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from iv_engine.pipeline.ringbuffer import (
    RingState,
    make_ring,
    push,
    window,
)
from iv_engine.pipeline.streaming import StreamingOut, streaming_step

_CH_MINUTE, _CH_PRICE, _CH_SIZE = 0, 1, 2


@jax.jit
def _sort_window_by_minute(minute, price, size, ok):
    """Stable per-row sort by minute with invalid rows keyed last —
    establishes streaming_step's time-sorted-valid-rows precondition for
    any tick arrival order."""
    key = jnp.where(ok, minute, jnp.int32(2 ** 30))
    order = jnp.argsort(key, axis=-1, stable=True)
    take = lambda a: jnp.take_along_axis(a, order, axis=-1)
    return take(minute), take(price), take(size), take(ok)


class StreamingSession:
    """Stateful streaming engine over a fixed underlying universe.

    Args:
      underlyings: ordered list of underlying ids (row index of the batch).
      chain_k/iv/T: (B, E, n) / (B, E, n) / (B, E) quote surfaces used as
        the refit baseline.
      window_minutes: static lookback window for candles/realized vol.
      tick_capacity: per-underlying tick-ring slots.
    """

    def __init__(self, underlyings: List[str], chain_k, chain_iv, chain_T,
                 window_minutes: int = 512, tick_capacity: int = 8192,
                 n_grid: int = 50, spline_bc: str = "not-a-knot",
                 mesh=None):
        self.underlyings = list(underlyings)
        self.index: Dict[str, int] = {u: i for i, u in
                                      enumerate(self.underlyings)}
        B = len(self.underlyings)
        self.window_minutes = int(window_minutes)
        self.n_grid = int(n_grid)

        # optional device mesh (parallel.mesh.pipeline_mesh): the
        # underlying/batch dim of every session-resident array — chains,
        # spline operators, tick rings — shards over the first axis, so
        # ingestion and the fused refit run SPMD across local chips.
        # Donated ring updates preserve the sharding (same layout in and
        # out). Non-divisible B falls back unsharded, like the runner.
        from iv_engine.parallel.mesh import shard_rows

        def _dev(x):
            return shard_rows(mesh, x, expect_dim0=B)

        self.chain_k = _dev(jnp.asarray(chain_k))
        self.chain_iv = _dev(jnp.asarray(chain_iv))
        self.chain_T = _dev(jnp.asarray(chain_T))
        # the quote grids are fixed for the session, so the spline refit
        # is a linear map of the (rescaled) knot variances: precompute
        # the per-underlying eval operators once and every refit becomes
        # a single einsum (ops.spline_matrix). spline_bc controls
        # the boundary condition (default not-a-knot — the
        # diagnostics-safe choice; streaming_step's spline_ops=None
        # fallback takes the same spline_bc kwarg, so both paths honor
        # one boundary condition).
        from iv_engine.ops.spline_matrix import (
            build_surface_operators_batched)
        from iv_engine.surface.surface import common_support_grid
        queries = common_support_grid(self.chain_k, self.n_grid)
        self.spline_ops = jax.tree.map(
            _dev, build_surface_operators_batched(
                self.chain_k, queries, bc_type=spline_bc))
        # tick ring channels: [minute, price, size]
        self.ring: RingState = jax.tree.map(
            _dev, make_ring(B, 3, int(tick_capacity), dtype=jnp.float32))
        self.latest_minute: int = 0
        self.n_ticks_seen = 0
        # the ring's minute channel is float32, whose exact-integer range
        # ends at 2^24 (~16.7M) — absolute EPOCH minutes (~29.8M today)
        # round to even values and land ticks in wrong 1-min buckets
        # (round-4 review). Minutes are therefore rebased to the first
        # minute seen before entering the ring; the public API stays
        # absolute (latest_minute, refit(now_minute=...)). Exact for
        # sessions spanning < 2^24 minutes (~31 years).
        self._minute_base: Optional[int] = None

    # ------------------------------------------------------------------
    def ingest_ticks(self, ticks: "pd.DataFrame") -> int:
        """Append a tick frame with columns (underlying, minute, price,
        size). Returns rows ingested. Unknown underlyings are dropped.

        All underlyings' rows for this call are pushed as one padded
        (B, 3, K) block so ingestion is a single donated device update.
        """
        if ticks.empty:
            return 0
        ticks = ticks[ticks["underlying"].isin(self.index)]
        if ticks.empty:
            return 0
        rows = np.asarray([self.index[u] for u in ticks["underlying"]])
        K = int(np.bincount(rows, minlength=len(self.underlyings)).max())
        B = len(self.underlyings)
        block = np.zeros((B, 3, K), np.float32)
        valid = np.zeros((B, K), bool)
        order = np.argsort(rows, kind="stable")
        rows_s = rows[order]
        minute_abs = ticks["minute"].to_numpy(np.int64)[order]
        if self._minute_base is None:
            self._minute_base = int(minute_abs.min())
        minute = (minute_abs - self._minute_base).astype(np.float32)
        price = ticks["price"].to_numpy(np.float32)[order]
        size = ticks["size"].to_numpy(np.float32)[order]
        # position within each underlying's run
        pos = np.arange(len(rows_s)) - np.searchsorted(rows_s, rows_s)
        block[rows_s, _CH_MINUTE, pos] = minute
        block[rows_s, _CH_PRICE, pos] = price
        block[rows_s, _CH_SIZE, pos] = size
        valid[rows_s, pos] = True
        self.ring = push(self.ring, jnp.asarray(block), jnp.asarray(valid))
        self.latest_minute = max(self.latest_minute, int(minute_abs.max()))
        self.n_ticks_seen += len(rows_s)
        return len(rows_s)

    # ------------------------------------------------------------------
    def refit(self, now_minute: Optional[int] = None) -> StreamingOut:
        """Refit every underlying from the ticks inside the lookback
        window ending at ``now_minute`` (defaults to the latest ingested
        minute) — one fused jit (candles -> realized vol -> surfaces)."""
        now = self.latest_minute if now_minute is None else int(now_minute)
        # ring minutes are rebased (see __init__); translate the absolute
        # window start into ring coordinates
        start = now - self.window_minutes + 1 - (self._minute_base or 0)
        data, valid = window(self.ring)
        minute_rel = (data[:, _CH_MINUTE] - float(start)).astype(jnp.int32)
        in_window = valid & (minute_rel >= 0) \
            & (minute_rel < self.window_minutes)
        # streaming_step requires time-sorted valid rows (open/close =
        # first/last-in-bucket AND the sorted-path aggregation both rely
        # on it); ring arrival order is not guaranteed — late ticks and
        # window wrap both break it. Stable sort keeps arrival order
        # within a minute and pushes out-of-window rows to the end.
        m, p, s, ok = _sort_window_by_minute(
            minute_rel, data[:, _CH_PRICE], data[:, _CH_SIZE], in_window)
        return streaming_step(
            m, p, s, ok,
            self.chain_k, self.chain_iv, self.chain_T,
            n_minutes=self.window_minutes, n_grid=self.n_grid,
            spline_ops=self.spline_ops)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "underlyings": len(self.underlyings),
            "ticks_seen": self.n_ticks_seen,
            "ring_capacity": int(self.ring.data.shape[-1]),
            "ring_fill": int(jnp.minimum(self.ring.count,
                                         self.ring.data.shape[-1]).max()),
            "latest_minute": self.latest_minute,
        }


def run_stream_replay(config, n_underlyings: int = 64,
                      window_minutes: int = 256, chunks: int = 8,
                      ticks_per_chunk: int = 200, seed: int = 0) -> dict:
    """Synthetic streaming replay: GBM ticks ingested chunk by chunk with a
    refit after each — the CLI-visible demonstration of the streaming
    engine (`--task stream`). Returns throughput + diagnostics."""
    import time as _time

    import pandas as pd

    rng = np.random.default_rng(seed)
    unds = [f"u{i:04d}" for i in range(n_underlyings)]
    E, n = 4, 12
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (n_underlyings, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E), (n_underlyings, E))
    iv = 0.5 + 0.05 * k * k
    from iv_engine.parallel.mesh import pipeline_mesh
    sess = StreamingSession(unds, k, iv, T, window_minutes=window_minutes,
                            tick_capacity=4 * window_minutes,
                            n_grid=config.surface.grid_strikes,
                            mesh=pipeline_mesh(
                                config.processing.mesh_shape,
                                config.processing.mesh_axis_names))
    per_min = 0.5 / np.sqrt(365.25 * 24 * 60)
    paths = 100.0 * np.exp(np.cumsum(
        rng.normal(0, per_min, (n_underlyings, window_minutes)), axis=-1))

    total_ticks = 0
    refit_s = []
    span = window_minutes // chunks
    out = None
    for c in range(chunks):
        lo, hi = c * span, (c + 1) * span
        frames = []
        for i, u in enumerate(unds):
            minutes = np.sort(rng.integers(lo, hi, ticks_per_chunk))
            frames.append(pd.DataFrame({
                "underlying": u, "minute": minutes,
                "price": paths[i, minutes],
                "size": rng.uniform(0, 5, ticks_per_chunk)}))
        total_ticks += sess.ingest_ticks(pd.concat(frames,
                                                   ignore_index=True))
        t0 = _time.perf_counter()
        out = sess.refit(now_minute=hi - 1)
        jax.block_until_ready(out.iv_grid)
        refit_s.append(_time.perf_counter() - t0)

    return {
        "underlyings": n_underlyings,
        "chunks": chunks,
        "ticks_ingested": total_ticks,
        "warm_refit_ms": round(sorted(refit_s)[len(refit_s) // 2] * 1e3, 1),
        "realized_vol_mean": round(
            float(np.asarray(out.realized_vol).mean()), 4),
        "butterfly_ok": int(np.asarray(out.butterfly_ok).sum()),
        "stats": sess.stats(),
    }
