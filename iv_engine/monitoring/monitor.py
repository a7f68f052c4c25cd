"""Realtime progress monitor.

Console dashboard over the run manifests — the reference's
``RealtimeMonitor`` (src/monitoring/progress.py:219-267) and
``ProductionPerformanceMonitor`` dashboard (performance_monitor.py:306-459)
reworked to poll jsonl manifests instead of Postgres progress tables.
Auto-exits when no symbols remain pending/processing; writes optional
JSON snapshots per refresh (performance_monitor.py:397-414).

The monitor runs beside the process that owns the card, so it never
starts JAX: device memory comes from the newest step-metrics snapshot
that the runner writes (``StepMetrics.snapshot``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from iv_engine.monitoring.metrics import (
    StepMetrics,
    host_memory_stats,
    host_system_census,
)
from iv_engine.pipeline.manifest import RunManifest


class RealtimeMonitor:
    def __init__(self, config, task: Optional[str] = None,
                 batch_id: Optional[int] = None,
                 interval_s: Optional[float] = None):
        self.config = config
        self.task = task
        self.batch_id = batch_id
        self.interval = interval_s or config.monitoring.refresh_interval_s
        self._prev_poll = None  # (batch key, ts, rows_out, symbols_done)

    def throughput(self, summary: dict) -> dict:
        """rows/s, symbols/min and ETA from consecutive polls (reference
        performance_monitor.py:226-265). First poll returns {}. Polls
        are keyed on (task, batch_id): when the monitored batch changes
        mid-run (--task all moves from interpolation to bridge), a
        cross-batch delta would print negative garbage throughput
        (round-4 review)."""
        by = summary["by_status"]
        done = by.get("completed", 0) + by.get("skipped", 0) \
            + by.get("error", 0)
        now = time.time()
        key = (summary["task"], summary["batch_id"])
        prev, self._prev_poll = self._prev_poll, (
            key, now, summary["output_rows"], done)
        if prev is None or prev[0] != key:
            return {}
        prev = prev[1:]
        dt = now - prev[0]
        if dt <= 0:
            return {}
        rows_s = (summary["output_rows"] - prev[1]) / dt
        sym_min = (done - prev[2]) / dt * 60.0
        remaining = by.get("pending", 0) + by.get("processing", 0)
        eta_s = remaining / (sym_min / 60.0) if sym_min > 0 else None
        return {"rows_per_sec": rows_s, "symbols_per_min": sym_min,
                "eta_s": eta_s}

    def _latest_manifest(self) -> Optional[RunManifest]:
        d = self.config.checkpoint.manifest_dir
        if not os.path.isdir(d):
            return None
        candidates = []
        for name in os.listdir(d):
            if not name.endswith(".jsonl"):
                continue
            task, _, bid = name[:-6].rpartition("_")
            try:
                bid = int(bid)
            except ValueError:
                continue  # stray .jsonl (editor backup, notes) — skip,
                #           same guard as RunManifest.list_batches
            if self.task and task != self.task:
                continue
            if self.batch_id and bid != self.batch_id:
                continue
            candidates.append((bid, task))
        if not candidates:
            return None
        bid, task = max(candidates)
        return RunManifest(d, task, bid)

    def alerts(self, manifest: RunManifest) -> list:
        """CURRENT threshold alerts: host-memory pressure and low
        throughput, thresholds from MonitoringConfig (reference
        performance_monitor.py:267-304). No dedup here: the dashboard
        repaints the whole screen each frame, so deduping by message
        (the reference's log-emission behavior) made a persistent
        CRITICAL visible for exactly one frame (round-4 review)."""
        out = []
        mcfg = self.config.monitoring
        host = host_memory_stats()
        if host:
            used = host["host_used_pct"]
            if used >= mcfg.memory_crit_pct:
                out.append(("CRITICAL", f"host memory {used:.0f}% used"))
            elif used >= mcfg.memory_warn_pct:
                out.append(("WARNING", f"host memory {used:.0f}% used"))
        s = manifest.summary()
        if s["avg_symbol_time"] > 0:
            per_s = 1.0 / s["avg_symbol_time"]
            if per_s < mcfg.low_throughput_surfaces_s and \
                    s["by_status"].get("completed", 0) > 0:
                out.append(("WARNING",
                            f"low throughput: {per_s:.0f} symbols/s"))
        return out

    def device_memory(self) -> dict:
        """Device memory as of the runner's newest metrics snapshot."""
        snap = StepMetrics.latest_snapshot(
            self.config.monitoring.snapshot_dir)
        return (snap or {}).get("device") or {}

    def render(self, manifest: RunManifest) -> str:
        s = manifest.summary()
        by = s["by_status"]
        total = max(s["total_symbols"], 1)
        done = by.get("completed", 0) + by.get("skipped", 0) \
            + by.get("error", 0)
        bar_w = 40
        filled = int(bar_w * done / total)
        bar = "#" * filled + "-" * (bar_w - filled)
        lines = [
            f"batch {s['batch_id']} [{s['task']}]  "
            f"[{bar}] {done}/{total}",
            f"  completed={by.get('completed', 0)} "
            f"error={by.get('error', 0)} skipped={by.get('skipped', 0)} "
            f"pending={by.get('pending', 0)} "
            f"processing={by.get('processing', 0)}",
            f"  rows {s['input_rows']} -> {s['output_rows']} "
            f"(expansion {s['expansion_ratio']:.1f}x)  "
            f"avg {s['avg_symbol_time'] * 1e3:.1f} ms/symbol",
        ]
        tp = self.throughput(s)
        if tp:
            eta = (time.strftime("%H:%M:%S", time.gmtime(tp["eta_s"]))
                   if tp.get("eta_s") else "--")
            lines.append(
                f"  throughput {tp['rows_per_sec']:,.0f} rows/s, "
                f"{tp['symbols_per_min']:,.1f} symbols/min, ETA {eta}")
        dev = self.device_memory()
        if dev:
            lines.append(
                f"  device mem {dev.get('bytes_in_use', 0) / 2**30:.2f} / "
                f"{dev.get('bytes_limit', 0) / 2**30:.2f} GB "
                f"(last runner snapshot)")
        host = host_memory_stats()
        if host:
            lines.append(f"  host mem {host['host_used_pct']:.0f}% used")
        for level, msg in self.alerts(manifest):
            lines.append(f"  [{level}] {msg}")
        return "\n".join(lines)

    def snapshot(self, manifest: RunManifest) -> None:
        if not self.config.monitoring.enable_snapshots:
            return
        d = self.config.monitoring.snapshot_dir
        os.makedirs(d, exist_ok=True)
        payload = {
            "ts": time.time(),
            "summary": manifest.summary(),
            "device": self.device_memory(),
            "host": host_memory_stats(),
            "system": host_system_census(),
        }
        path = os.path.join(
            d, f"progress_snapshot_{manifest.batch_id}.json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)

    def run(self, max_iterations: Optional[int] = None,
            wait_for_new: bool = False,
            wait_s: Optional[float] = None) -> None:
        """Poll + render until the batch finishes (progress.py:236-267).

        ``wait_for_new=True`` (the --with-monitor side process) waits up
        to ``wait_s`` (default 10x the refresh interval) for a manifest
        to APPEAR — or for a batch newer than one that was already
        finished when the monitor started — before giving up. Without
        it, the dashboard spawned alongside a fresh run exited
        immediately: either no ./runs dir existed yet, or it latched
        onto the previous (completed) batch and printed 'batch
        complete' within one cycle (round-4 review). Plain --monitor
        keeps the instant behavior so inspecting a finished batch
        still returns immediately."""
        deadline = time.time() + (wait_s if wait_s is not None
                                  else 10 * self.interval)
        stale = None  # batch that was already done when we started
        first_poll = True
        started = False
        i = 0
        while True:
            manifest = self._latest_manifest()
            key = ((manifest.task, manifest.batch_id)
                   if manifest is not None else None)
            if wait_for_new and not started:
                if first_poll and manifest is not None \
                        and manifest.is_done():
                    # latch ONLY on the first poll: a batch appearing
                    # (and even finishing) mid-wait is the new run
                    stale = key
                first_poll = False
                if manifest is None or key == stale:
                    if time.time() >= deadline:
                        print("no run manifests found" if manifest is None
                              else "batch complete")
                        return
                    time.sleep(min(self.interval, 1.0))
                    continue
                started = True
            if manifest is None:
                print("no run manifests found")
                return
            print("\033[2J\033[H" + self.render(manifest), flush=True)
            self.snapshot(manifest)
            if manifest.is_done():
                print("batch complete")
                return
            i += 1
            if max_iterations is not None and i >= max_iterations:
                return
            time.sleep(self.interval)
