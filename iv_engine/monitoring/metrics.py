"""Step metrics: device-aware throughput/memory accounting.

Replacement for the reference's psutil + pg_stat dashboards
(performance_monitor.py:115-224): wall-clock spans bracketed by
``jax.block_until_ready``, surfaces/rows per second, device memory from
``device.memory_stats()``, and optional ``jax.profiler`` traces.
JSON snapshots mirror performance_monitor.py:397-414. JAX is imported
only by the functions that read the device, so a process that only
reads snapshots (the monitor) never starts JAX on a card.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def device_memory_stats() -> dict:
    """Device memory usage (empty dict on backends without stats).

    Reports device 0's counters plus, when the pipeline mesh spans
    several local devices, the bytes_in_use/peak summed across all of
    them — a single-device read under-reports a sharded step's real
    footprint by the mesh factor."""
    import jax

    keep = ("bytes_in_use", "bytes_limit", "peak_bytes_in_use",
            "largest_alloc_size")
    try:
        devices = jax.local_devices()
        stats = devices[0].memory_stats() or {}
    except Exception:
        return {}
    out = {k: stats[k] for k in keep if k in stats}
    if len(devices) > 1 and out:
        totals = {"bytes_in_use": 0, "peak_bytes_in_use": 0}
        for d in devices:
            try:
                s = d.memory_stats() or {}
            except Exception:
                continue
            for k in totals:
                totals[k] += s.get(k, 0)
        out.update({f"all_devices_{k}": v for k, v in totals.items()
                    if v})
    return out


def host_memory_stats() -> dict:
    try:
        import psutil
        vm = psutil.virtual_memory()
        return {"host_used_pct": vm.percent,
                "host_available_gb": vm.available / 2**30}
    except Exception:
        return {}


def host_system_census() -> dict:
    """Full host census: per-core CPU, disk usage + IO counters, network
    counters, process RSS — the reference monitor's system snapshot
    (performance_monitor.py:115-165), via psutil when present."""
    try:
        import os

        import psutil
    except Exception:
        return {}
    out: dict = {}

    def probe(name, fn):
        # per-probe guard: one unavailable counter (containers often
        # lack net/disk IO counters) must not discard the whole census
        try:
            out[name] = fn()
        except Exception:
            out[name] = None

    probe("cpu_percent_per_core", lambda: psutil.cpu_percent(percpu=True))
    probe("cpu_percent", psutil.cpu_percent)
    probe("load_avg", lambda: list(os.getloadavg()))
    probe("disk_used_pct", lambda: psutil.disk_usage("/").percent)
    probe("disk_free_gb", lambda: psutil.disk_usage("/").free / 2**30)
    probe("disk_read_mb",
          lambda: psutil.disk_io_counters().read_bytes / 2**20)
    probe("disk_write_mb",
          lambda: psutil.disk_io_counters().write_bytes / 2**20)
    probe("net_sent_mb",
          lambda: psutil.net_io_counters().bytes_sent / 2**20)
    probe("net_recv_mb",
          lambda: psutil.net_io_counters().bytes_recv / 2**20)
    probe("process_rss_gb",
          lambda: psutil.Process(os.getpid()).memory_info().rss / 2**30)
    return out


@dataclass
class StepMetrics:
    """Accumulates per-step timings and emits snapshots."""

    snapshot_dir: Optional[str] = None
    steps: List[dict] = field(default_factory=list)

    @contextmanager
    def step(self, name: str, items: int = 0):
        """Bracket a device computation; the caller must block inside (or
        the recorded span is dispatch-only)."""
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        rec = {
            "name": name,
            "wall_s": dt,
            "items": items,
            "items_per_s": items / dt if dt > 0 and items else None,
            "ts": time.time(),
        }
        rec.update(device_memory_stats())
        self.steps.append(rec)

    def summary(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for rec in self.steps:
            s = out.setdefault(rec["name"], {"wall_s": 0.0, "items": 0,
                                             "count": 0})
            s["wall_s"] += rec["wall_s"]
            s["items"] += rec["items"]
            s["count"] += 1
        for s in out.values():
            s["items_per_s"] = s["items"] / s["wall_s"] if s["wall_s"] else 0.0
        return out

    @staticmethod
    def latest_snapshot(snapshot_dir: Optional[str]) -> Optional[dict]:
        """The newest ``metrics_*.json`` snapshot in ``snapshot_dir``, or
        None. Reads files only: no device access."""
        if not snapshot_dir or not os.path.isdir(snapshot_dir):
            return None
        paths = [os.path.join(snapshot_dir, n)
                 for n in os.listdir(snapshot_dir)
                 if n.startswith("metrics_") and n.endswith(".json")]
        for path in sorted(paths, key=os.path.getmtime, reverse=True):
            try:
                with open(path) as f:
                    return json.load(f)
            except (OSError, ValueError):
                continue   # a snapshot being rewritten: try the next
        return None

    def snapshot(self, tag: str) -> Optional[str]:
        """Persist a JSON snapshot (reference
        performance_snapshot_<batch>.json, performance_monitor.py:397-414)."""
        if not self.snapshot_dir:
            return None
        os.makedirs(self.snapshot_dir, exist_ok=True)
        path = os.path.join(self.snapshot_dir, f"metrics_{tag}.json")
        payload = {
            "tag": tag,
            "ts": time.time(),
            "summary": self.summary(),
            "device": device_memory_stats(),
            "host": host_memory_stats(),
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)
        return path


@contextmanager
def profile_trace(profiler_dir: Optional[str]):
    """Optional jax.profiler trace around a region (reference had no
    profiler integration, SURVEY.md §5.1 — this is the upgrade)."""
    if not profiler_dir:
        yield
        return
    import jax

    with jax.profiler.trace(profiler_dir):
        yield
