"""Pipeline runner: storage -> packed batches -> jitted stage kernels ->
storage, with run-manifest checkpointing and failure isolation.

The reference's L5/L4 orchestration (ProductionPipelineManager,
production_main.py:41-299; BatchProcessor.run_parallel,
batch_processor.py:202-290) fanned symbols over a process pool with
Postgres as shared state. Here a batch of symbols is one device
computation; orchestration is a host loop over length buckets with:

  * per-symbol guardrail skips recorded to the manifest (the reference's
    'skipped' status, batch_processor.py:124-131);
  * per-batch failure isolation — one failing bucket marks only its
    symbols as errors and the run continues (mirrors per-symbol isolation,
    batch_processor.py:132-142);
  * resume: ``resume_batch_id`` re-enqueues pending+error symbols
    (batch_processor.py:53-65).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from iv_engine.config import Config
from iv_engine.ops.bridge import BridgeParams
from iv_engine.ops.segment_ohlcv import validate_ohlcv
from iv_engine.pipeline import ingest
from iv_engine.pipeline import storage as st
from iv_engine.pipeline.manifest import RunManifest
from iv_engine.pipeline import tasks
from iv_engine.monitoring.logging import get_logger, PerformanceLogger
from iv_engine.monitoring.metrics import StepMetrics

_FREQ_MIN = {"1min": 1, "5min": 5, "15min": 15, "30min": 30, "1h": 60}


def symbol_fold(symbol: str) -> int:
    """Stable 31-bit fold-in value for a symbol's bridge PRNG key.

    Python's ``hash()`` is PYTHONHASHSEED-salted per process, which would
    make synthetic OHLCV differ between a run and its ``--resume`` (a new
    process) — breaking the bridge's determinism contract
    (ops/bridge.py). CRC32 is process-stable and platform-stable."""
    import zlib

    return zlib.crc32(symbol.encode("utf-8")) & 0x7FFFFFFF


def parse_frequency(freq: str) -> int:
    """'5min'/'5m'/'1h' -> minutes (reference core.py:27-34 parser)."""
    if freq in _FREQ_MIN:
        return _FREQ_MIN[freq]
    if freq.endswith("min"):
        return int(freq[:-3])
    if freq.endswith("m"):
        return int(freq[:-1])
    if freq.endswith("h"):
        return int(freq[:-1]) * 60
    raise ValueError(f"Unsupported frequency: {freq}")


def _split_by_obs_count(batch: ingest.PackedBatch,
                        max_batch: Optional[int] = None):
    """Sub-bucket a packed batch by observation count (uniform k is what
    the batched cubic spline needs). Each sub-batch is re-padded to the
    same geometric shape schedule as the original packing
    (``ingest.batch_pad``) with all-masked padding rows, so the split
    does not introduce arbitrary batch dims that defeat the compile
    cache (ADVICE r1)."""
    # split by the ON-GRID observation count (obs_mask row sums), not the
    # source n_obs: off-grid or sub-minute-duplicated observations make
    # the two diverge, and _obs_positions checks grid counts — keyed on
    # n_obs, one misaligned symbol silently demoted its whole sub-batch
    # (including perfectly aligned symbols) to the linear fallback
    grid_counts = np.asarray(batch.obs_mask).sum(axis=1)
    real = batch.n_obs > 0
    counts = np.unique(grid_counts[real])
    if len(counts) <= 1:
        return [batch]
    out = []
    for k in counts:
        rows = np.flatnonzero((grid_counts == k) & real)
        B_real = len(rows)
        B = ingest.batch_pad(B_real, max_batch) if max_batch else B_real
        pad = B - B_real

        def take(a, fill=0):
            sel = a[rows]
            if pad:
                tail = np.full((pad,) + sel.shape[1:], fill, sel.dtype)
                sel = np.concatenate([sel, tail])
            return sel

        out.append(ingest.PackedBatch(
            bucket_len=batch.bucket_len,
            symbols=[batch.symbols[i] for i in rows if i < len(batch.symbols)],
            t0_minutes=take(batch.t0_minutes),
            valid_len=take(batch.valid_len),
            values=take(batch.values, fill=np.nan),
            obs_mask=take(batch.obs_mask),
            timeline_mask=take(batch.timeline_mask),
            n_obs=take(batch.n_obs),
            const_cols={c: [v[i] for i in rows] + [None] * pad
                        for c, v in batch.const_cols.items()},
            columns=batch.columns,
        ))
    return out


def _obs_positions(batch: ingest.PackedBatch):
    """(B, k) observation grid positions for a uniform-count batch, plus a
    cleanliness flag (no NaN among the interpolated columns at the
    observations). Padding rows get row 0's positions (outputs masked)."""
    mask = np.asarray(batch.obs_mask)
    counts = mask.sum(axis=1)
    nonempty = counts > 0
    if not nonempty.any():
        return None, False
    # uniform ON-GRID count (the quantity _split_by_obs_count keys on —
    # source n_obs can exceed it when observations are off-grid)
    k = int(counts[nonempty].max())
    if k < 2 or not (counts[nonempty] == k).all():
        return None, False  # non-uniform (shouldn't happen post-split)
    # one vectorised pass: np.nonzero walks rows in order, and uniform
    # counts make the column index reshape exactly (n_nonempty, k)
    # (replaces a per-row np.flatnonzero Python loop — O(B) host work
    # that dominated cubic ingest at large B)
    rows_ne, cols = np.nonzero(mask)
    del rows_ne
    pos = np.zeros((mask.shape[0], k), np.int64)
    pos[nonempty] = cols.reshape(-1, k)
    if nonempty.any():
        first_real = pos[nonempty][0]
        pos[~nonempty] = first_real
        # cleanliness: any NaN among the first-3 interpolated columns at
        # real observation positions disables the fast uniform path
        vals = np.take_along_axis(
            np.asarray(batch.values)[nonempty, :3],
            pos[nonempty][:, None, :], axis=2)
        clean = bool(np.isfinite(vals).all())
    else:
        clean = True
    return jnp.asarray(pos), clean


class PipelineRunner:
    """End-to-end three-stage pipeline over a storage adapter."""

    def __init__(self, config: Config, store=None):
        self.config = config
        self.store = store if store is not None else st.get_store(config.storage)
        self.log = get_logger("pipeline")
        self.perf = PerformanceLogger()
        self.metrics = StepMetrics(
            snapshot_dir=config.monitoring.snapshot_dir
            if config.monitoring.enable_snapshots else None)
        self.np_dtype = {"float32": np.float32, "float64": np.float64,
                         "bfloat16": np.float32}[config.processing.dtype]
        self.dtype = {"float32": jnp.float32, "float64": jnp.float64,
                      "bfloat16": jnp.bfloat16}[config.processing.dtype]
        # device mesh for pipeline-level data parallelism: bucket batches
        # shard their symbol (batch) dim over processing.mesh_shape /
        # mesh_axis_names — the device realisation of the reference's
        # ProcessPoolExecutor symbol fan-out (batch_processor.py:234-239).
        # None (single device / trivial shape) -> unsharded, transparently
        from iv_engine.parallel.mesh import pipeline_mesh
        self.mesh = pipeline_mesh(config.processing.mesh_shape,
                                  config.processing.mesh_axis_names)
        if self.mesh is not None:
            self.log.info("pipeline mesh: shape=%s axes=%s",
                          dict(self.mesh.shape), self.mesh.axis_names)
        # cooperative stop flag, checked between bucket batches (the
        # reference checked a SIGINT flag between symbols,
        # complete_pipeline.py:52-58); unfinished symbols stay 'pending'
        # in the manifest, so --resume picks them up
        self.stop_requested = False

    def request_stop(self) -> None:
        self.stop_requested = True

    def install_signal_handler(self) -> None:
        """SIGINT -> graceful stop after the current bucket."""
        import signal

        def handler(signum, frame):
            self.log.warning("interrupt received — stopping after the "
                             "current batch (resume with --resume)")
            self.stop_requested = True

        signal.signal(signal.SIGINT, handler)


    def _shard_symbols(self, symbols: List[str]) -> List[str]:
        """Process-level symbol partition (processing.shard_index /
        shard_count): process i of n owns symbol s iff
        crc32(s) % n == i — the reference's multi-worker fan-out lifted
        to independent processes/hosts, with storage upserts as the
        rendezvous (its workers partitioned disjoint symbols,
        batch_processor.py:234-239). Ownership is a property of the
        SYMBOL NAME alone (review round 4): a positional [i::n] slice
        was (a) not idempotent — re-applying it to a resumed manifest's
        already-partitioned pending list dropped most of the shard —
        and (b) unstable for the staged bridge/task2 stages, which
        discover from a shared downstream table whose momentary
        contents depend on other shards' progress. The hash rule is
        idempotent and enumeration-order-free, so it is safe to apply
        after discovery, resume re-enqueue, or an explicit list."""
        n = self.config.processing.shard_count
        if n <= 1:
            return symbols
        i = self.config.processing.shard_index
        if not (0 <= i < n):
            # CLI --shard validates this; the config/env path must too.
            # Wrapping with % n would silently alias another shard's
            # partition (duplicate work, masked misconfiguration).
            raise ValueError(
                f"processing.shard_index={i} out of range for "
                f"shard_count={n} (want 0 <= index < count)")
        return [s for s in symbols if symbol_fold(s) % n == i]

    def _manifest(self, name: str, resume_batch_id=None) -> RunManifest:
        """Stage manifest, shard-aware: under --shard I/N the task name
        gains a per-shard suffix so each process writes its OWN jsonl.
        Two shard processes launched within the same second otherwise
        derive the same batch_id and append to one file — torn lines,
        JSONDecodeError on the next --resume (round-4 review; --shard
        documents per-process manifests)."""
        n = self.config.processing.shard_count
        if n > 1:
            name = f"{name}.shard{self.config.processing.shard_index}"
        return RunManifest(
            self.config.checkpoint.manifest_dir, name, resume_batch_id,
            flush_interval=self.config.checkpoint.checkpoint_interval)

    def _symbol_chunks(self, symbols: List[str]):
        """Chunk the requested symbols so each storage read is bounded
        (VERDICT r1 item 8 — the reference streamed with server-side
        cursors at 32M+-row scale; here the unit is a symbol group)."""
        n = self.config.processing.read_chunk_symbols
        if not n or n >= len(symbols):
            yield symbols
            return
        for lo in range(0, len(symbols), n):
            yield symbols[lo:lo + n]

    def _shard_rows(self, *arrays):
        """Batch-dim mesh placement — see parallel.mesh.shard_rows."""
        from iv_engine.parallel.mesh import shard_rows
        return shard_rows(self.mesh, *arrays)

    def _iter_packed_batches(self, symbols, skip, start_date=None,
                             end_date=None):
        """Read + pack one bounded symbol chunk at a time, so host RAM
        never holds the whole input table. ONE definition serves the
        staged task-1 and the fused pipeline (round-4 review: two
        near-identical copies had already drifted — only the staged one
        could window by date). A requested symbol with zero observations
        after the date window — or absent from the input table entirely
        — gets an explicit skip record; a bare drop left it 'pending'
        forever, fruitlessly re-enqueued by every --resume."""
        cfg = self.config.interpolation
        freq = parse_frequency(cfg.frequency)
        for chunk_syms in self._symbol_chunks(symbols):
            df = self.store.read(st.TICKERS, symbols=chunk_syms)
            if start_date is not None and len(df):
                df = df[pd.to_datetime(df["date"])
                        >= pd.to_datetime(start_date)]
            if end_date is not None and len(df):
                df = df[pd.to_datetime(df["date"])
                        <= pd.to_datetime(end_date)]
            present = (set(df["symbol"].astype(str).unique())
                       if len(df) else set())
            for sym in chunk_syms:
                if str(sym) not in present:
                    skip(sym, "no observations (unknown symbol or "
                              "empty date window)")
            packed = ingest.pack_symbols(
                df, self.config.processing.bucket_sizes,
                min_points=cfg.min_data_points,
                max_span_days=cfg.max_span_days,
                max_timeline_points=cfg.max_timeline_points,
                freq_minutes=freq,
                max_batch=self.config.processing.batch_size,
                max_slots=self.config.processing.max_slots_per_batch,
                dtype=self.np_dtype,
                # cubic's obs-count splitting walks host-side masks
                compact=(cfg.method != "cubic"),
            )
            for sym, reason in packed.skipped.items():
                skip(sym, reason)
            bs = packed.batches
            if cfg.method == "cubic":
                bs = [b for orig in bs
                      for b in _split_by_obs_count(
                          orig, ingest.bucket_batch_cap(
                              orig.bucket_len,
                              self.config.processing.batch_size,
                              self.config.processing
                              .max_slots_per_batch))]
            yield from bs

    def _device_grids(self, batch: ingest.PackedBatch):
        """(values, obs_mask, timeline_mask) on device, batch dim sharded
        over the pipeline mesh. Compact batches scatter on device
        (tasks.scatter_batch) — the host never materialises or ships the
        mostly-empty grid; the scatter output is then resharded once
        (cheap relative to the grid compute it feeds)."""
        if batch.values is not None:
            return self._shard_rows(
                jnp.asarray(batch.values), jnp.asarray(batch.obs_mask),
                jnp.asarray(batch.timeline_mask))
        grids = tasks.scatter_batch(
            jnp.asarray(batch.obs_vals), jnp.asarray(batch.obs_row),
            jnp.asarray(batch.obs_pos), jnp.asarray(batch.valid_len),
            B=batch.batch_padded, C=len(batch.columns),
            L=batch.bucket_len)
        return self._shard_rows(*grids)

    @staticmethod
    def _quality_failures(symbols, ok_rows, reason: str) -> Dict[str, str]:
        """Per-symbol verdicts from a per-row validity mask: symbol i
        fails if any of its row's entries are bad. Padding rows (beyond
        len(symbols)) are ignored."""
        sym_ok = np.asarray(jnp.all(ok_rows, axis=tuple(
            range(1, ok_rows.ndim))))
        return {s: reason for i, s in enumerate(symbols) if not sym_ok[i]}

    @staticmethod
    def _mask_failed_rows(symbols, failed: Dict[str, str],
                          valid: np.ndarray) -> np.ndarray:
        """Validity mask with failed symbols' rows zeroed, so their
        output rows never reach storage. Returns a writable copy when a
        change is needed (device-backed arrays are read-only views)."""
        if not failed:
            return valid
        valid = np.array(valid)
        for i, s in enumerate(symbols):
            if s in failed:
                valid[i] = False
        return valid

    def _attempt(self, label: str, fn):
        """Run a bucket computation with retry (wires the reference's
        declared-but-unused max_retries, config_production.py:79-80 /
        SURVEY.md §5.3). Returns (result, None) or (None, last_error)."""
        retries = self.config.checkpoint.max_retries
        last = None
        for attempt in range(retries + 1):
            try:
                return fn(), None
            except Exception as e:  # noqa: BLE001 — failure isolation
                last = e
                if attempt < retries:
                    self.log.warning("%s attempt %d/%d failed: %s — retrying",
                                     label, attempt + 1, retries + 1, e)
        self.log.exception("%s failed after %d attempts", label, retries + 1)
        return None, last

    # ------------------------------------------------------------------
    # Task 1 — IV interpolation
    # ------------------------------------------------------------------
    def run_task1(self, symbols: Optional[List[str]] = None,
                  resume_batch_id: Optional[int] = None,
                  limit: Optional[int] = None,
                  start_date=None, end_date=None) -> dict:
        """``start_date``/``end_date`` (any pandas-parseable timestamp)
        restrict the observation window — the reference's symbol-discovery
        date filter (batch_processor.py:28-51, default window
        2023-03-15..26) generalised to arbitrary bounds."""
        cfg = self.config.interpolation
        manifest = self._manifest("interpolation", resume_batch_id)
        if resume_batch_id is not None:
            symbols = manifest.pending_symbols()
            self.log.info("resume batch %s: %d pending symbols",
                          resume_batch_id, len(symbols))
        if symbols is None:
            symbols = self.store.list_symbols(st.TICKERS)
        if limit:
            symbols = symbols[:limit]
        symbols = self._shard_symbols(symbols)
        manifest.initialize_symbols(symbols)
        manifest.flush()  # pending records must survive an early crash so
        #                   --resume can re-enqueue the whole run
        if not symbols:
            return manifest.summary()

        t_start = time.time()
        self.perf.log_batch_start(manifest.batch_id, len(symbols))
        freq = parse_frequency(cfg.frequency)
        max_gap = cfg.max_gap_hours * 60 if cfg.max_gap_hours else 0
        n_rows_out = 0

        for batch in self._iter_packed_batches(
                symbols, manifest.skip_symbol, start_date, end_date):
            if self.stop_requested:
                break
            t0 = time.time()

            def process(batch=batch):
                strike = jnp.asarray(pd.to_numeric(
                    pd.Series(batch.const_cols.get("strike", [])),
                    errors="coerce").to_numpy(self.np_dtype))
                callput = np.asarray([
                    str(c).lower() in ("c", "call")
                    for c in batch.const_cols.get("callput", [])
                ])
                method = cfg.method
                obs_pos = None
                if method == "cubic":
                    obs_pos, clean = _obs_positions(batch)
                    if not clean:
                        # NaN at an observation: pandas would drop that
                        # knot per column (ragged) — fall back to linear
                        # for the whole sub-batch and say so
                        self.log.warning(
                            "cubic: NaN at observations in bucket "
                            "L=%d — falling back to linear",
                            batch.bucket_len)
                        method, obs_pos = "linear", None
                values, obs_mask, timeline_mask = self._device_grids(batch)
                strike, callput_dev, obs_pos = self._shard_rows(
                    strike, jnp.asarray(callput), obs_pos)
                out = tasks.interpolate_batch(
                    values, obs_mask, timeline_mask,
                    strike, callput_dev,
                    method=method, max_gap_minutes=max_gap,
                    compute_greeks=cfg.compute_greeks,
                    extrapolate=cfg.extrapolate,
                    obs_pos=obs_pos,
                )
                jax.block_until_ready(out)
                out_np = jax.tree.map(np.asarray, out)
                result_df = ingest.unpack_interpolated(
                    batch, out_np["filled"], out_np["valid"],
                    out_np["is_interpolated"], manifest.batch_id,
                    greeks=out_np.get("greeks"), freq_minutes=freq)
                self.store.write(st.INTERPOLATED, result_df,
                                 upsert_keys=["symbol", "date"])
                return result_df

            with self.metrics.step(f"task1/L{batch.bucket_len}",
                                   items=batch.batch):
                result_df, err = self._attempt(
                    f"task1 bucket L={batch.bucket_len}", process)
            if err is not None:  # failure isolation per bucket
                for sym in batch.symbols:
                    manifest.error_symbol(sym, str(err), time.time() - t0)
                continue
            dt = time.time() - t0
            rows_per_symbol = (
                result_df.groupby("symbol").size() if len(result_df)
                else pd.Series(dtype=int))
            for i, sym in enumerate(batch.symbols):
                n_out = int(rows_per_symbol.get(sym, 0))
                manifest.complete_symbol(
                    sym, int(batch.n_obs[i]), n_out, dt / batch.batch)
                self.perf.log_symbol_processed(
                    sym, int(batch.n_obs[i]), n_out, dt / batch.batch)
            n_rows_out += len(result_df)
        manifest.flush()
        summary = manifest.summary()
        self.perf.log_batch_complete(manifest.batch_id, time.time() - t_start,
                                     summary["output_rows"])
        return summary

    # ------------------------------------------------------------------
    # Data bridge — interpolated -> synthetic 1-min OHLCV
    # ------------------------------------------------------------------
    def run_bridge(self, symbols: Optional[List[str]] = None,
                   batch_id: Optional[int] = None,
                   resume_batch_id: Optional[int] = None) -> dict:
        cfg = self.config.data_bridge
        manifest = self._manifest("bridge", resume_batch_id)
        if resume_batch_id is not None:
            symbols = manifest.pending_symbols()
        if symbols is None:
            symbols = self.store.list_symbols(st.INTERPOLATED)
        symbols = self._shard_symbols(symbols)
        manifest.initialize_symbols(symbols)
        manifest.flush()  # pending records must survive an early crash so
        #                   --resume can re-enqueue the whole run
        if not symbols:
            return manifest.summary()

        # interpolated rows are spaced interpolation.frequency apart; the
        # grid (and the emitted candle timestamps) must use the same
        # spacing or the staged path diverges from the fused one
        freq = parse_frequency(self.config.interpolation.frequency)
        # column pruning: the bridge needs the numeric grid + identity
        # columns, not the Greeks written by task 1
        read_cols = ["symbol", "date"] + list(ingest.ALL_COLS)
        if batch_id is not None:
            read_cols.append("batch_id")
        # the reference's price-source priority rule evaluates coverage
        # over REAL quotes (ohlcv_converter.py:189-207). The stored
        # interpolated grid cannot answer that: task 1 fills per-COLUMN
        # NaNs even on observation rows and only stores rows with finite
        # underlying_price, so every stored row — real or interpolated —
        # has the column populated and any rule computed over the
        # INTERPOLATED table is dead (frac identically 1.0; round-4
        # review caught the first fix still reading post-fill rows).
        # Genuine pre-fill coverage lives in the raw TICKERS table —
        # the same per-quote finiteness the fused path's
        # select_price_columns sees at observed grid positions.
        price_choice: Dict[str, int] = {}

        def _choose_price_cols(chunk_syms) -> None:
            prio = ["underlying_price", "mark_price", "index_price"]
            raw = self.store.read(st.TICKERS, symbols=chunk_syms,
                                  columns=["symbol"] + prio)
            for sym, g in raw.groupby("symbol"):
                n = max(len(g), 1)
                fr = [(g[c].notna().sum() / n if c in g.columns else 0.0)
                      for c in prio]
                good = [i for i, f in enumerate(fr) if f >= 0.8]
                anyd = [i for i, f in enumerate(fr) if f > 0.0]
                pick = good[0] if good else (anyd[0] if anyd else 0)
                price_choice[sym] = ingest.ALL_COLS.index(prio[pick])

        def iter_batches():
            for chunk_syms in self._symbol_chunks(symbols):
                df = self.store.read(st.INTERPOLATED, symbols=chunk_syms,
                                     columns=read_cols)
                if batch_id is not None and "batch_id" in df.columns:
                    df = df[df["batch_id"] == batch_id]
                _choose_price_cols(chunk_syms)
                packed = ingest.pack_symbols(
                    df, self.config.processing.bucket_sizes,
                    min_points=1,
                    max_span_days=self.config.interpolation.max_span_days,
                    max_timeline_points=self.config
                    .interpolation.max_timeline_points,
                    freq_minutes=freq,
                    max_batch=self.config.processing.batch_size,
                    max_slots=self.config.processing.max_slots_per_batch,
                    dtype=self.np_dtype,
                    compact=True,
                )
                for sym, reason in packed.skipped.items():
                    manifest.skip_symbol(sym, reason)
                yield from packed.batches

        params = BridgeParams(
            base_spread_percent=cfg.base_spread_percent,
            volatility_factor=cfg.volatility_factor,
            min_spread_percent=cfg.min_spread_percent,
            trend_strength=cfg.trend_strength,
            base_volume=cfg.base_volume,
        )
        root_key = jax.random.key(cfg.seed)
        for batch in iter_batches():
            if self.stop_requested:
                break
            t0 = time.time()

            def process(batch=batch):
                values, b_obs_mask, mask = self._device_grids(batch)
                # interpolated rows are stored post-fill; on the grid they
                # appear at obs positions (obs_mask), padding in between
                B_pad = batch.batch_padded
                filled = tasks.interpolate_batch(
                    values, b_obs_mask, mask,
                    self._shard_rows(
                        jnp.full((values.shape[0],), jnp.nan, self.dtype)),
                    # PADDED shape: the real batch size varies per bucket
                    # and jit caches on every arg's shape, so (batch.batch,)
                    # forced a 1-2 min recompile per distinct real size
                    self._shard_rows(jnp.zeros((B_pad,), bool)),
                    method="ffill", compute_greeks=False)
                # price columns from the host-side raw-coverage rule (see
                # _choose_price_cols above)
                pc = np.zeros(B_pad, np.int32)
                up = ingest.ALL_COLS.index("underlying_price")
                pc[:len(batch.symbols)] = [
                    price_choice.get(s, up) for s in batch.symbols]
                price_col = self._shard_rows(jnp.asarray(pc))
                # one deterministic key per symbol name hash — order-free
                # and process-stable (CRC32, not salted hash()); padded
                # rows (batch dim is shape-padded) get a dummy key
                hashes = [symbol_fold(s) for s in batch.symbols]
                hashes += [0] * (B_pad - len(hashes))
                keys = self._shard_rows(
                    jax.vmap(jax.random.fold_in, (None, 0))(
                        root_key, jnp.asarray(hashes)))
                # absolute epoch minutes of the grid rows: the draws key
                # on them, so candles match the fused path even when the
                # stored grid starts later (leading-invalid rows)
                L_b = filled["filled"].shape[-1]
                abs_min = self._shard_rows(
                    jnp.asarray(batch.t0_minutes)[:, None]
                    + jnp.arange(L_b)[None, :] * freq)
                ohlcv = tasks.bridge_batch(
                    filled["filled"], filled["valid"] & b_obs_mask,
                    keys, params=params, price_col=price_col,
                    strategy=cfg.conversion_strategy,
                    abs_minutes=abs_min)
                failed: Dict[str, str] = {}
                if cfg.enable_quality_checks:
                    base = jnp.take_along_axis(
                        filled["filled"],
                        price_col[:, None, None].astype(jnp.int32),
                        axis=1)[:, 0]
                    from iv_engine.ops.bridge import (
                        validate_bridge_quality)
                    _, ok = validate_bridge_quality(
                        ohlcv["open"], ohlcv["high"], ohlcv["low"],
                        ohlcv["close"], base, ohlcv["valid"],
                        max_spread_frac=cfg.max_spread_percent)
                    failed = self._quality_failures(
                        batch.symbols, ok, "OHLCV quality gate failed")
                ohlcv_np = jax.tree.map(np.asarray, ohlcv)
                ohlcv_np["valid"] = self._mask_failed_rows(
                    batch.symbols, failed, ohlcv_np["valid"])
                result_df = self._unpack_candles(batch, ohlcv_np,
                                                 freq_minutes=freq)
                self.store.write(st.MINUTE_CANDLES, result_df,
                                 upsert_keys=["symbol", "timestamp"])
                return result_df, failed

            with self.metrics.step(f"bridge/L{batch.bucket_len}",
                                   items=batch.batch):
                result, err = self._attempt(
                    f"bridge bucket L={batch.bucket_len}", process)
            if err is not None:
                for sym in batch.symbols:
                    manifest.error_symbol(sym, str(err), time.time() - t0)
                continue
            result_df, failed = result
            dt = time.time() - t0
            per_sym = (result_df.groupby("symbol").size()
                       if len(result_df) else pd.Series(dtype=int))
            for i, sym in enumerate(batch.symbols):
                if sym in failed:
                    # deterministic validation failure: isolate the symbol
                    # (reference per-symbol isolation,
                    # batch_processor.py:132-142) — no retries wasted
                    manifest.error_symbol(sym, failed[sym],
                                          dt / batch.batch)
                    continue
                manifest.complete_symbol(
                    sym, int(batch.n_obs[i]),
                    int(per_sym.get(sym, 0)), dt / batch.batch)
        manifest.flush()
        return manifest.summary()

    @staticmethod
    def _unpack_candles(batch: ingest.PackedBatch, ohlcv: Dict[str, np.ndarray],
                        freq_minutes: int = 1) -> pd.DataFrame:
        sel_b, sel_pos = np.nonzero(np.asarray(ohlcv["valid"]))
        if not len(sel_b):
            return pd.DataFrame()
        ts = pd.to_datetime(
            (batch.t0_minutes[sel_b] + sel_pos * freq_minutes)
            * 60_000_000_000)
        return pd.DataFrame({
            "symbol": pd.Categorical.from_codes(sel_b,
                                                categories=batch.symbols),
            "timestamp": ts,
            "open": ohlcv["open"][sel_b, sel_pos],
            "high": ohlcv["high"][sel_b, sel_pos],
            "low": ohlcv["low"][sel_b, sel_pos],
            "close": ohlcv["close"][sel_b, sel_pos],
            "volume": ohlcv["volume"][sel_b, sel_pos],
        })

    # ------------------------------------------------------------------
    # Task 2 — candle reconstruction
    # ------------------------------------------------------------------
    def run_task2(self, symbols: Optional[List[str]] = None,
                  resume_batch_id: Optional[int] = None) -> dict:
        cfg = self.config.candle_reconstruction
        manifest = self._manifest("candles", resume_batch_id)
        if resume_batch_id is not None:
            symbols = manifest.pending_symbols()
        if symbols is None:
            symbols = self.store.list_symbols(st.MINUTE_CANDLES)
        symbols = self._shard_symbols(symbols)
        manifest.initialize_symbols(symbols)
        manifest.flush()  # pending records must survive an early crash so
        #                   --resume can re-enqueue the whole run
        if not symbols:
            return manifest.summary()

        freq = parse_frequency(cfg.target_frequency)
        src_freq = parse_frequency(cfg.source_frequency)
        interp_freq = parse_frequency(self.config.interpolation.frequency)
        if src_freq != interp_freq:
            # the bridge writes MINUTE_CANDLES at interpolation.frequency
            # spacing; a disagreeing source_frequency makes every target
            # bucket hold fewer bars than min_candles_required and the
            # run 'completes' with zero output rows — warn loudly
            self.log.warning(
                "candle_reconstruction.source_frequency=%s but the bridge "
                "writes %s-spaced candles (interpolation.frequency) — "
                "if MINUTE_CANDLES came from the bridge, buckets will be "
                "mostly empty", cfg.source_frequency,
                self.config.interpolation.frequency)
        created_at = pd.Timestamp.now()

        def iter_batches():
            for chunk_syms in self._symbol_chunks(symbols):
                df = self.store.read(st.MINUTE_CANDLES, symbols=chunk_syms)
                batches, skipped = self._pack_candles(df, src_freq)
                for sym, reason in skipped.items():
                    manifest.skip_symbol(sym, reason)
                yield from batches

        for batch in iter_batches():
            if self.stop_requested:
                break
            t0 = time.time()

            def process(batch=batch):
                # t0_minutes is in src-interval units; epoch minute of grid
                # slot j is (t0 + j) * src_freq
                minutes = self._shard_rows(
                    (jnp.asarray(batch.t0_minutes)[:, None]
                     + jnp.arange(batch.bucket_len)[None, :]) * src_freq)
                values, b_obs_mask, _ = self._device_grids(batch)
                grids = {c: values[:, j]
                         for j, c in enumerate(batch.columns)}
                valid_in = b_obs_mask
                failed: Dict[str, str] = {}
                if cfg.validate_ohlc:
                    _, ok_in = validate_ohlcv(
                        grids["open"], grids["high"], grids["low"],
                        grids["close"], grids["volume"], valid_in)
                    failed = self._quality_failures(
                        batch.symbols, ok_in, "invalid input candle data")
                    if failed:
                        # exclude failed symbols' bars from aggregation
                        sym_ok = np.ones(valid_in.shape[0], bool)
                        for i, s in enumerate(batch.symbols):
                            if s in failed:
                                sym_ok[i] = False
                        valid_in = valid_in & jnp.asarray(sym_ok)[:, None]
                base_bucket = self._shard_rows(
                    jnp.asarray(batch.t0_minutes) * src_freq // freq)
                # ceil so a misaligned t0 keeps its trailing partial bucket
                # (filtered only by min_count, not silently dropped)
                num_segments = (batch.bucket_len * src_freq
                                + freq - 1) // freq + 1
                agg = tasks.candles_batch(
                    minutes, {
                        "open": grids["open"], "high": grids["high"],
                        "low": grids["low"], "close": grids["close"],
                        "volume": grids["volume"], "valid": valid_in,
                    }, jnp.int32(freq), base_bucket,
                    num_segments=num_segments,
                    min_count=cfg.min_candles_required)
                if cfg.validate_ohlc:
                    _, ok_out = validate_ohlcv(
                        agg.open, agg.high, agg.low, agg.close,
                        agg.volume, agg.valid)
                    failed.update(self._quality_failures(
                        batch.symbols, ok_out,
                        "invalid reconstructed candle data"))
                agg_np = jax.tree.map(np.asarray, agg)
                agg_np = agg_np._replace(valid=self._mask_failed_rows(
                    batch.symbols, failed, agg_np.valid))
                result_df = self._unpack_aggregated(
                    batch, agg_np, freq, src_freq,
                    cfg.target_frequency, created_at)
                self.store.write(st.RECONSTRUCTED, result_df,
                                 upsert_keys=["symbol", "timestamp",
                                              "frequency"])
                return result_df, failed

            with self.metrics.step(f"candles/L{batch.bucket_len}",
                                   items=batch.batch):
                result, err = self._attempt(
                    f"candles bucket L={batch.bucket_len}", process)
            if err is not None:
                for sym in batch.symbols:
                    manifest.error_symbol(sym, str(err), time.time() - t0)
                continue
            result_df, failed = result
            dt = time.time() - t0
            per_sym = (result_df.groupby("symbol").size()
                       if len(result_df) else pd.Series(dtype=int))
            for i, sym in enumerate(batch.symbols):
                if sym in failed:
                    manifest.error_symbol(sym, failed[sym],
                                          dt / batch.batch)
                    continue
                manifest.complete_symbol(
                    sym, int(batch.n_obs[i]),
                    int(per_sym.get(sym, 0)), dt / batch.batch)
        manifest.flush()
        return manifest.summary()

    def _pack_candles(self, df: pd.DataFrame, src_freq: int):
        """Scatter per-symbol 1-min candles onto padded dense grids.

        Returns (batches, skipped) — skipped maps symbol -> reason for
        symbols that cannot be packed (e.g. timeline beyond the largest
        bucket); a bare drop left them 'pending' forever, fruitlessly
        re-enqueued by every --resume."""
        skipped: Dict[str, str] = {}
        if df.empty:
            return [], skipped
        cols = ("open", "high", "low", "close", "volume")
        df = df.sort_values(["symbol", "timestamp"]).drop_duplicates(
            subset=["symbol", "timestamp"], keep="last")
        # collapse candles sharing one src-interval slot (stored spacing
        # finer than source_frequency): duplicate (row, pos) coordinates
        # are undefined under the device scatter's unique_indices=True
        slots = np.asarray(
            ingest.to_epoch_minutes(df["timestamp"])) // src_freq
        dup = pd.DataFrame({
            "s": df["symbol"].to_numpy(), "m": slots,
        }).duplicated(["s", "m"], keep="last").to_numpy()
        if dup.any():
            self.log.warning(
                "candles: %d bars share a %d-min source slot with a later "
                "bar (stored spacing finer than source_frequency?) — "
                "keeping the last per slot", int(dup.sum()), src_freq)
            df = df[~dup]
            slots = slots[~dup]
        minutes_all = np.asarray(slots)
        # one numeric extraction for the whole frame + numpy indexing
        # per chunk (same 14.8x pandas-take removal as pack_symbols,
        # round-4 profile)
        colmat_all = np.stack([
            pd.to_numeric(df[c], errors="coerce").to_numpy(self.np_dtype)
            for c in cols], axis=1)
        out: List[ingest.PackedBatch] = []
        per_bucket: Dict[int, List[dict]] = {}
        for symbol, idx in df.groupby("symbol", sort=True).indices.items():
            obs = minutes_all[idx]
            L = int(obs[-1] - obs[0]) + 1
            bucket = ingest.choose_bucket(
                L, self.config.processing.bucket_sizes)
            if bucket is None:
                skipped[symbol] = (
                    f"candle timeline {L} src intervals exceeds the "
                    f"largest bucket")
                continue
            per_bucket.setdefault(bucket, []).append(
                dict(symbol=symbol, obs=obs, idx=idx, L=L))
        maxb = self.config.processing.batch_size
        max_slots = self.config.processing.max_slots_per_batch
        for bucket, items in sorted(per_bucket.items()):
            cap = ingest.bucket_batch_cap(bucket, maxb, max_slots)
            for lo in range(0, len(items), cap):
                chunk = items[lo:lo + cap]
                B_real = len(chunk)
                B = ingest.batch_pad(B_real, cap)
                t0 = np.zeros(B, np.int64)
                vlen = np.zeros(B, np.int64)
                n_obs = np.zeros(B, np.int64)
                syms = [it["symbol"] for it in chunk]
                t0[:B_real] = [it["obs"][0] for it in chunk]
                vlen[:B_real] = [it["L"] for it in chunk]
                n_obs[:B_real] = [len(it["obs"]) for it in chunk]
                # compact form: the dense grid is scattered on device
                row_sym = np.repeat(np.arange(B_real), n_obs[:B_real])
                obs_all = np.concatenate([it["obs"] for it in chunk])
                pos = (obs_all - t0[row_sym]).astype(np.int64)
                colmat = colmat_all[np.concatenate(
                    [it["idx"] for it in chunk])]
                N = ingest.obs_pad(len(pos))
                obs_vals = ingest.full_nan((N, len(cols)), self.np_dtype)
                obs_vals[:len(pos)] = colmat
                obs_row = np.full(N, B, np.int32)
                obs_row[:len(pos)] = row_sym
                obs_pos = np.zeros(N, np.int64)
                obs_pos[:len(pos)] = pos
                out.append(ingest.PackedBatch(
                    bucket_len=bucket, symbols=syms, t0_minutes=t0,
                    valid_len=vlen, n_obs=n_obs, columns=cols,
                    obs_vals=obs_vals, obs_row=obs_row, obs_pos=obs_pos))
        return out, skipped

    @staticmethod
    def _unpack_aggregated(batch: ingest.PackedBatch, agg, freq: int,
                           src_freq: int, freq_name: str,
                           created_at, base_bucket=None) -> pd.DataFrame:
        if base_bucket is None:
            # staged task2 convention: t0_minutes is in src-interval units
            base_bucket = batch.t0_minutes * src_freq // freq
        sel_b, sel_pos = np.nonzero(np.asarray(agg.valid))
        if not len(sel_b):
            return pd.DataFrame()
        ts = pd.to_datetime(
            (base_bucket[sel_b] + sel_pos) * freq * 60_000_000_000)
        return pd.DataFrame({
            "symbol": pd.Categorical.from_codes(sel_b,
                                                categories=batch.symbols),
            "timestamp": ts,
            "open": agg.open[sel_b, sel_pos],
            "high": agg.high[sel_b, sel_pos],
            "low": agg.low[sel_b, sel_pos],
            "close": agg.close[sel_b, sel_pos],
            "volume": agg.volume[sel_b, sel_pos],
            "frequency": freq_name,
            "source_candles": freq // src_freq,
            "created_at": created_at,
        })


    # ------------------------------------------------------------------
    # Fused pipeline — all three stages chained on-device per batch
    # ------------------------------------------------------------------
    def run_pipeline_fused(self, symbols: Optional[List[str]] = None,
                           limit: Optional[int] = None,
                           resume_batch_id: Optional[int] = None,
                           start_date=None, end_date=None) -> dict:
        """interpolate -> bridge -> aggregate per bucket batch with NO
        storage round-trip between stages — the north star's
        "eliminating the data_bridge/database round-trips on the hot
        path" (BASELINE.json). Outputs still persist to all three tables;
        only the *inputs* of stages 2/3 stay device-resident.

        Produces byte-identical tables to the staged ``run_all`` (bridge
        PRNG keys derive from symbol hashes, not execution order) —
        asserted in tests/test_pipeline.py.
        """
        icfg = self.config.interpolation
        bcfg = self.config.data_bridge
        ccfg = self.config.candle_reconstruction
        manifests = {
            name: self._manifest(name, resume_batch_id)
            for name in ("interpolation", "bridge", "candles")
        }
        if resume_batch_id is not None:
            # a symbol is done only when ALL three stages completed it
            pending = set()
            for m in manifests.values():
                pending.update(m.pending_symbols())
            symbols = sorted(pending)
            self.log.info("fused resume batch %s: %d pending symbols",
                          resume_batch_id, len(symbols))
        if symbols is None:
            symbols = self.store.list_symbols(st.TICKERS)
        if limit:
            symbols = symbols[:limit]
        symbols = self._shard_symbols(symbols)
        for m in manifests.values():
            m.initialize_symbols(symbols)
            m.flush()  # --resume must see pending records even after an early crash
        if not symbols:
            return {"task1": manifests["interpolation"].summary(),
                    "bridge": manifests["bridge"].summary(),
                    "task2": manifests["candles"].summary(),
                    "fused": True}

        freq = parse_frequency(icfg.frequency)
        tgt_freq = parse_frequency(ccfg.target_frequency)

        def skip_all(sym, reason):
            for m in manifests.values():
                m.skip_symbol(sym, reason)

        def iter_batches():
            yield from self._iter_packed_batches(
                symbols, skip_all, start_date, end_date)

        max_gap = icfg.max_gap_hours * 60 if icfg.max_gap_hours else 0
        params = BridgeParams(
            base_spread_percent=bcfg.base_spread_percent,
            volatility_factor=bcfg.volatility_factor,
            min_spread_percent=bcfg.min_spread_percent,
            trend_strength=bcfg.trend_strength,
            base_volume=bcfg.base_volume,
        )
        root_key = jax.random.key(bcfg.seed)
        created_at = pd.Timestamp.now()

        # storage writes overlap the next batch's device compute: one
        # write-set in flight; a failed async write demotes its symbols to
        # 'error' (resume re-runs them — writes are idempotent upserts)
        from concurrent.futures import ThreadPoolExecutor
        writer = ThreadPoolExecutor(max_workers=1)
        inflight: list = []

        def drain(limit: int) -> None:
            while len(inflight) > limit:
                syms, futs, record_completions = inflight.pop(0)
                ok = True
                for f in futs:
                    try:
                        f.result()
                    except Exception as e:  # noqa: BLE001
                        ok = False
                        self.log.exception("async write failed")
                        for sym in syms:
                            for m in manifests.values():
                                m.error_symbol(sym,
                                               f"async write failed: {e}")
                        break
                if ok:
                    # manifests record 'completed' only AFTER the writes
                    # land: recording at submit time let a crash between
                    # manifest flush and the parquet write mark symbols
                    # completed with no rows — --resume then skipped them
                    # forever. Crashing between land and record errs the
                    # safe way (re-run; writes are idempotent upserts).
                    record_completions()

        def dispatch(batch):
            """Device phase: enqueue all three stages WITHOUT blocking —
            dispatch is async, so the next batch's compute overlaps this
            batch's host unpack (SURVEY §7.1: double-buffering replaces
            the reference's streaming cursors)."""
            B_pad = batch.batch_padded
            L = batch.bucket_len
            values, obs_mask, timeline_mask = self._device_grids(batch)
            strike = jnp.asarray(pd.to_numeric(
                pd.Series(batch.const_cols.get("strike", [])),
                errors="coerce").to_numpy(self.np_dtype))
            callput = np.asarray([
                str(c).lower() in ("c", "call")
                for c in batch.const_cols.get("callput", [])
            ])
            # cubic rides the obs-count sub-bucketing applied below (same
            # scheme as the staged run_task1); NaN-at-observation batches
            # fall back to linear, matching the staged behavior
            method = icfg.method
            obs_pos = None
            if method == "cubic":
                obs_pos, clean = _obs_positions(batch)
                if not clean:
                    self.log.warning(
                        "cubic: NaN at observations in bucket L=%d — "
                        "falling back to linear", batch.bucket_len)
                    method, obs_pos = "linear", None
            strike, callput_dev, obs_pos = self._shard_rows(
                strike, jnp.asarray(callput), obs_pos)
            out = tasks.interpolate_batch(
                values, obs_mask, timeline_mask,
                strike, callput_dev,
                method=method,
                max_gap_minutes=max_gap,
                compute_greeks=icfg.compute_greeks,
                extrapolate=icfg.extrapolate,
                obs_pos=obs_pos)
            price_col = tasks.select_price_columns(values, obs_mask)
            hashes = [symbol_fold(s) for s in batch.symbols]
            hashes += [0] * (B_pad - len(hashes))
            keys = self._shard_rows(
                jax.vmap(jax.random.fold_in, (None, 0))(
                    root_key, jnp.asarray(hashes)))
            # here t0_minutes is epoch minutes (pack_symbols convention),
            # not src-interval units like the staged task2 path
            minutes, base_bucket = self._shard_rows(
                jnp.asarray(batch.t0_minutes)[:, None]
                + jnp.arange(L)[None, :] * freq,
                jnp.asarray(batch.t0_minutes) // tgt_freq)
            ohlcv = tasks.bridge_batch(
                out["filled"], out["valid"], keys, params=params,
                price_col=price_col,
                strategy=bcfg.conversion_strategy,
                abs_minutes=minutes)
            quality_ok = None
            if bcfg.enable_quality_checks:
                from iv_engine.ops.bridge import (
                    validate_bridge_quality)
                base = jnp.take_along_axis(
                    out["filled"],
                    price_col[:, None, None].astype(jnp.int32),
                    axis=1)[:, 0]
                _, quality_ok = validate_bridge_quality(
                    ohlcv["open"], ohlcv["high"], ohlcv["low"],
                    ohlcv["close"], base, ohlcv["valid"],
                    max_spread_frac=bcfg.max_spread_percent)
            agg = tasks.candles_batch(
                minutes, ohlcv, jnp.int32(tgt_freq), base_bucket,
                num_segments=(L * freq + tgt_freq - 1) // tgt_freq + 1,
                min_count=ccfg.min_candles_required)
            return out, ohlcv, agg, quality_ok

        def finish(batch, dev):
            out, ohlcv, agg, quality_ok = dev
            jax.block_until_ready(agg)
            out_np = jax.tree.map(np.asarray, out)
            interp_df = ingest.unpack_interpolated(
                batch, out_np["filled"], out_np["valid"],
                out_np["is_interpolated"],
                manifests["interpolation"].batch_id,
                greeks=out_np.get("greeks"), freq_minutes=freq)
            # symbol-level quality isolation, same gate as the staged
            # bridge: failed symbols keep their interpolated rows but
            # write no candles at either frequency
            failed: Dict[str, str] = {}
            if quality_ok is not None:
                failed = self._quality_failures(
                    batch.symbols, quality_ok, "OHLCV quality gate failed")
            ohlcv_np = jax.tree.map(np.asarray, ohlcv)
            ohlcv_np["valid"] = self._mask_failed_rows(
                batch.symbols, failed, ohlcv_np["valid"])
            candle_df = self._unpack_candles(batch, ohlcv_np,
                                             freq_minutes=freq)
            # t0 here is epoch minutes, so pass the dispatch-side bucket
            # base explicitly (the default assumes src-interval units)
            agg_np = jax.tree.map(np.asarray, agg)
            agg_np = agg_np._replace(valid=self._mask_failed_rows(
                batch.symbols, failed, agg_np.valid))
            recon_df = self._unpack_aggregated(
                batch, agg_np, tgt_freq, freq,
                ccfg.target_frequency, created_at,
                base_bucket=batch.t0_minutes // tgt_freq)
            return interp_df, candle_df, recon_df, failed

        from collections import deque
        pending = deque()  # (batch, dev_or_None, t0) — depth-2 pipeline

        def complete_one():
            batch, dev, t0 = pending.popleft()
            # the pre-dispatched arrays are consumed by the FIRST attempt
            # only: async device errors surface inside finish() at
            # block_until_ready, so retrying against the same arrays just
            # replays the failure — retries must re-dispatch
            cell = {"dev": dev}

            def closure(batch=batch):
                d = cell.pop("dev", None)
                if d is None:
                    d = dispatch(batch)
                return finish(batch, d)

            with self.metrics.step(f"fused/L{batch.bucket_len}",
                                   items=batch.batch):
                result, err = self._attempt(
                    f"fused bucket L={batch.bucket_len}", closure)
            if err is not None:
                for sym in batch.symbols:
                    for m in manifests.values():
                        m.error_symbol(sym, str(err), time.time() - t0)
                return
            interp_df, candle_df, recon_df, failed = result
            dt = time.time() - t0
            per = {
                "interpolation": (interp_df.groupby("symbol").size()
                                  if len(interp_df) else pd.Series(dtype=int)),
                "bridge": (candle_df.groupby("symbol").size()
                           if len(candle_df) else pd.Series(dtype=int)),
                "candles": (recon_df.groupby("symbol").size()
                            if len(recon_df) else pd.Series(dtype=int)),
            }

            def record_completions(batch=batch, per=per, failed=failed,
                                   dt=dt):
                for i, sym in enumerate(batch.symbols):
                    n_in = int(batch.n_obs[i])
                    manifests["interpolation"].complete_symbol(
                        sym, n_in, int(per["interpolation"].get(sym, 0)),
                        dt / batch.batch)
                    if sym in failed:
                        manifests["bridge"].error_symbol(
                            sym, failed[sym], dt / batch.batch)
                        manifests["candles"].error_symbol(
                            sym, failed[sym], dt / batch.batch)
                        continue
                    manifests["bridge"].complete_symbol(
                        sym, int(per["interpolation"].get(sym, 0)),
                        int(per["bridge"].get(sym, 0)), dt / batch.batch)
                    manifests["candles"].complete_symbol(
                        sym, int(per["bridge"].get(sym, 0)),
                        int(per["candles"].get(sym, 0)), dt / batch.batch)

            drain(0)  # previous write-set must land before queueing more
            inflight.append((list(batch.symbols), [
                writer.submit(self.store.write, st.INTERPOLATED, interp_df,
                              upsert_keys=["symbol", "date"]),
                writer.submit(self.store.write, st.MINUTE_CANDLES,
                              candle_df,
                              upsert_keys=["symbol", "timestamp"]),
                writer.submit(self.store.write, st.RECONSTRUCTED, recon_df,
                              upsert_keys=["symbol", "timestamp",
                                           "frequency"]),
            ], record_completions))

        try:
            for batch in iter_batches():
                if self.stop_requested:
                    break
                t0 = time.time()
                try:
                    dev = dispatch(batch)
                except Exception:  # noqa: BLE001 — retried, fresh dispatch
                    dev = None
                pending.append((batch, dev, t0))
                while len(pending) >= 2:
                    complete_one()
            while pending:
                complete_one()
        finally:
            # an exception anywhere above (store.read, pack_symbols, ...)
            # must still land in-flight writes, stop the writer thread and
            # flush buffered manifest events — otherwise --resume sees a
            # truncated (or, for short runs, empty) manifest
            try:
                drain(0)
            finally:
                writer.shutdown(wait=True)
                for m in manifests.values():
                    m.flush()
        self.metrics.snapshot(
            f"fused_{manifests['interpolation'].batch_id}")
        return {
            "task1": manifests["interpolation"].summary(),
            "bridge": manifests["bridge"].summary(),
            "task2": manifests["candles"].summary(),
            "step_metrics": self.metrics.summary(),
            "fused": True,
        }

    # ------------------------------------------------------------------
    def run_all(self, symbols: Optional[List[str]] = None,
                limit: Optional[int] = None,
                resume_batch_id: Optional[int] = None,
                start_date=None, end_date=None) -> dict:
        """Full pipeline: interpolate -> bridge -> reconstruct
        (reference complete_pipeline.run_complete_pipeline,
        complete_pipeline.py:740-831).

        With ``symbols``/``limit``/``resume_batch_id``/date bounds, the
        downstream stages are SCOPED to the completed set of the stage
        before them instead of re-discovering from the shared tables —
        otherwise ``--test`` (3 symbols) or ``--resume`` would
        interpolate a handful of symbols and then bridge/reconstruct
        every symbol ever written to storage (round-4 review; the CLI
        also silently dropped --resume for the default task).
        ``resume_batch_id`` resumes each stage whose manifest exists
        for that batch; stages that never started run fresh over the
        scoped set."""
        scoped = (symbols is not None or bool(limit)
                  or resume_batch_id is not None
                  or start_date is not None or end_date is not None)

        def stage_resume(name):
            if resume_batch_id is None:
                return None
            return (resume_batch_id
                    if self._manifest(name, resume_batch_id).records()
                    else None)

        def completed(name, batch_id):
            m = self._manifest(name, batch_id)
            return sorted(s for s, r in m.records().items()
                          if r.status == "completed")

        # task1 gets the id verbatim: resuming an unknown batch must
        # no-op (empty pending set), not silently start a full fresh run
        s1 = self.run_task1(symbols=symbols, limit=limit,
                            resume_batch_id=resume_batch_id,
                            start_date=start_date, end_date=end_date)
        scope = (completed("interpolation", s1.get("batch_id"))
                 if scoped else None)
        s2 = self.run_bridge(symbols=scope,
                             resume_batch_id=stage_resume("bridge"))
        scope2 = (completed("bridge", s2.get("batch_id"))
                  if scoped else None)
        s3 = self.run_task2(symbols=scope2,
                            resume_batch_id=stage_resume("candles"))
        self.metrics.snapshot(f"pipeline_{s1.get('batch_id', 'run')}")
        return {"task1": s1, "bridge": s2, "task2": s3,
                "step_metrics": self.metrics.summary()}

    def status(self) -> dict:
        """Census across all four tables (reference get_pipeline_status,
        complete_pipeline.py:178-219)."""
        out = {}
        for table in (st.TICKERS, st.INTERPOLATED, st.MINUTE_CANDLES,
                      st.RECONSTRUCTED):
            out[table] = {
                "rows": self.store.count(table),
                "symbols": len(self.store.list_symbols(table)),
            }
        return out
