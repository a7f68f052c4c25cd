"""Concurrent multi-process shard proof: REAL simultaneous OS processes.

The reference's production path ran genuinely concurrent worker
processes (src/interpolation/batch_processor.py:234-239,
optimized_batch_processor.py:431-436). The repo's ``--shard I/N``
machinery carries the concurrent-safety design (ns+pid parquet part
names, per-shard manifest dirs, hash-of-name ownership) — this module
is the proof that it holds under *actual* concurrency, not a
sequential loop:

1. **Concurrent parity** (:func:`proof_concurrent`): two
   ``iv-engine --task pipeline --shard {0,1}/2`` subprocesses launched
   simultaneously against ONE parquet store; both must exit 0, the
   three output tables must equal the unsharded in-process run
   byte-for-byte (modulo batch_id/created_at), and each shard's
   manifest must cover exactly its hash partition with no torn lines.
2. **Crash + resume** (:func:`proof_kill_resume`): one shard is
   SIGKILLed mid-run (after its manifest initialises, before it
   completes), then re-run with ``--resume <batch_id>`` — the resumed
   process must finish the partition and the store must reach the same
   final tables. Mirrors the reference's resume contract
   (batch_processor.py:53-65) under a hard kill instead of a clean
   error.

Consumed by ``tests/test_concurrent_shards.py`` and by the
driver-visible dry run (``__graft_entry__.dryrun_multichip`` →
``parallel.dryrun`` proof 4), so the artifact records it every round.

Subprocesses run on plain CPU (the proof is about host-side
concurrency — manifests, parquet writers, hash ownership — not device
math, which the sharded-parity proofs already cover) and share the
test suite's persistent XLA compile cache so repeat runs skip the
first-compile wall.
"""

from __future__ import annotations

import glob
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cpu_subprocess_env(manifest_dir: str, log_dir: str,
                       cache_dir: Optional[str] = None) -> dict:
    """Environment for a CPU-only CLI subprocess.

    Any inherited xla_force_host_platform_device_count flag is stripped
    (the shard workers are single-device hosts).
    """
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_PLATFORM_NAME", None)
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(flags)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO_ROOT, env.get("PYTHONPATH", "")) if p)
    env["IVTPU_CHECKPOINT__MANIFEST_DIR"] = manifest_dir
    env["IVTPU_MONITORING__LOG_DIR"] = log_dir
    env["IVTPU_MONITORING__ENABLE_SNAPSHOTS"] = "false"
    if cache_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = cache_dir
    return env


def launch_shard(i: int, n: int, data_root: str, workdir: str,
                 resume: Optional[int] = None,
                 cache_dir: Optional[str] = None) -> subprocess.Popen:
    """Start ``iv-engine --task pipeline --shard i/n`` as an OS process."""
    manifest_dir = os.path.join(workdir, f"runs_shard{i}")
    log_dir = os.path.join(workdir, f"logs_shard{i}")
    cmd = [sys.executable, "-m", "iv_engine.cli",
           "--task", "pipeline", "--shard", f"{i}/{n}",
           "--env", "testing", "--storage", "parquet",
           "--data-root", data_root, "--json"]
    if resume is not None:
        cmd += ["--resume", str(resume)]
    return subprocess.Popen(
        cmd, env=cpu_subprocess_env(manifest_dir, log_dir, cache_dir),
        cwd=_REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _seed_store(data_root: str, num_symbols: int = 6, hours: int = 12):
    # hours >= interpolation.min_data_points (10, all presets): the
    # subprocess CLI runs on the plain testing preset, so the seeded
    # series must clear the default skip threshold without env overrides
    """Write deterministic sample tickers into a fresh parquet store."""
    from iv_engine.pipeline import storage as st
    from iv_engine.pipeline.sample_data import (
        generate_sample_tickers)

    tickers = generate_sample_tickers(num_symbols=num_symbols, hours=hours)
    store = st.ParquetStore(data_root)
    store.write(st.TICKERS, tickers)
    return tickers


def _read_tables(data_root: str) -> Dict[str, "object"]:
    """The three output tables, canonically sorted, volatile cols dropped."""
    from iv_engine.pipeline import storage as st

    store = st.ParquetStore(data_root)
    out = {}
    for t in (st.INTERPOLATED, st.MINUTE_CANDLES, st.RECONSTRUCTED):
        df = store.read(t)
        key = ["symbol"] + (["date"] if t == st.INTERPOLATED
                            else ["timestamp"])
        df = df.sort_values(key).reset_index(drop=True)
        df = df.drop(columns=[c for c in ("batch_id", "created_at")
                              if c in df.columns])
        df["symbol"] = df["symbol"].astype(str)
        out[t] = df
    return out


def _reference_run(data_root: str) -> Dict[str, "object"]:
    """Unsharded in-process fused run over a parquet copy of the input."""
    import tempfile

    from iv_engine.config import get_config
    from iv_engine.pipeline import PipelineRunner, storage as st

    cfg = get_config("testing")
    cfg.storage.backend = "parquet"
    cfg.storage.root = data_root
    with tempfile.TemporaryDirectory() as td:
        cfg.checkpoint.manifest_dir = os.path.join(td, "runs")
        cfg.monitoring.log_dir = os.path.join(td, "logs")
        cfg.monitoring.enable_snapshots = False
        runner = PipelineRunner(cfg, store=st.ParquetStore(data_root))
        runner.run_pipeline_fused()
    return _read_tables(data_root)


def _manifest_records(workdir: str, shard: int,
                      task: str = "interpolation") -> Dict[str, dict]:
    """Parse a shard's newest manifest jsonl; raises on any torn line.

    Sharded runners suffix the task name (``interpolation.shard0``) so
    two shards pointed at one manifest dir could never collide.
    """
    paths = sorted(glob.glob(os.path.join(
        workdir, f"runs_shard{shard}", f"{task}.shard{shard}_*.jsonl")))
    if not paths:
        return {}
    records: Dict[str, dict] = {}
    with open(paths[-1]) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)  # torn/truncated line -> raises here
            records[rec["symbol"]] = rec
    return records


def _expected_partition(tickers, n: int) -> Dict[int, List[str]]:
    from iv_engine.pipeline.runner import symbol_fold

    universe = sorted(tickers["symbol"].unique())
    return {i: [s for s in universe if symbol_fold(s) % n == i]
            for i in range(n)}


def proof_concurrent(workdir: str, num_symbols: int = 6,
                     timeout_s: float = 600.0,
                     cache_dir: Optional[str] = None) -> dict:
    """Two simultaneous shard processes over one store == unsharded run."""
    import pandas as pd

    ref_root = os.path.join(workdir, "ref_store")
    _seed_store(ref_root, num_symbols=num_symbols)
    ref_tables = _reference_run(ref_root)

    data_root = os.path.join(workdir, "shared_store")
    tickers = _seed_store(data_root, num_symbols=num_symbols)
    expect = _expected_partition(tickers, 2)
    assert min(len(v) for v in expect.values()) >= 1, expect

    t0 = time.time()
    procs = [launch_shard(i, 2, data_root, workdir, cache_dir=cache_dir)
             for i in (0, 1)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=timeout_s)
        outs.append(out)
    overlap_wall = time.time() - t0
    for p, out in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(
                f"shard subprocess rc={p.returncode}:\n{out[-4000:]}")

    # disjoint complete coverage, no torn manifest lines
    for i in (0, 1):
        recs = _manifest_records(workdir, i)
        done = sorted(s for s, r in recs.items()
                      if r["status"] in ("completed", "skipped"))
        assert done == expect[i], (i, done, expect[i])

    got = _read_tables(data_root)
    for t, ref in ref_tables.items():
        pd.testing.assert_frame_equal(got[t], ref)

    return {"symbols": num_symbols,
            "partition_sizes": {i: len(v) for i, v in expect.items()},
            "wall_s": round(overlap_wall, 1),
            "tables": {t: len(df) for t, df in got.items()}}


def proof_kill_resume(workdir: str, num_symbols: int = 6,
                      timeout_s: float = 600.0,
                      cache_dir: Optional[str] = None) -> dict:
    """SIGKILL one shard mid-run; ``--resume`` finishes its partition."""
    import pandas as pd

    ref_root = os.path.join(workdir, "kill_ref_store")
    _seed_store(ref_root, num_symbols=num_symbols)
    ref_tables = _reference_run(ref_root)

    data_root = os.path.join(workdir, "kill_store")
    tickers = _seed_store(data_root, num_symbols=num_symbols)
    expect = _expected_partition(tickers, 2)

    # shard 1 runs to completion; shard 0 is killed as soon as its
    # manifest exists (i.e. after symbol init, before the batch lands —
    # jit compiles give a seconds-wide window)
    p1 = launch_shard(1, 2, data_root, workdir, cache_dir=cache_dir)
    p0 = launch_shard(0, 2, data_root, workdir, cache_dir=cache_dir)
    victim_glob = os.path.join(workdir, "runs_shard0",
                               "interpolation.shard0_*.jsonl")
    deadline = time.time() + timeout_s
    while not glob.glob(victim_glob):
        if p0.poll() is not None:
            # finished before the manifest was even visible — can't
            # happen (manifest init precedes compute), but fail loudly
            out, _ = p0.communicate()
            raise AssertionError(
                f"shard 0 exited (rc={p0.returncode}) before its "
                f"manifest appeared:\n{out[-2000:]}")
        if time.time() > deadline:
            p0.kill()
            p1.kill()
            raise AssertionError("timed out waiting for shard-0 manifest")
    os.kill(p0.pid, signal.SIGKILL)
    p0.communicate()
    assert p0.returncode != 0  # really died

    out1, _ = p1.communicate(timeout=timeout_s)
    assert p1.returncode == 0, out1[-4000:]

    # resume shard 0 under the SAME batch id (the torn run's manifest)
    paths = sorted(glob.glob(victim_glob))
    batch_id = int(os.path.basename(paths[-1]).split("_")[-1].split(".")[0])
    pr = launch_shard(0, 2, data_root, workdir, resume=batch_id,
                      cache_dir=cache_dir)
    outr, _ = pr.communicate(timeout=timeout_s)
    assert pr.returncode == 0, outr[-4000:]

    recs = _manifest_records(workdir, 0)
    done = sorted(s for s, r in recs.items()
                  if r["status"] in ("completed", "skipped"))
    assert done == expect[0], (done, expect[0])

    got = _read_tables(data_root)
    for t, ref in ref_tables.items():
        pd.testing.assert_frame_equal(got[t], ref)

    return {"killed_batch_id": batch_id,
            "resumed_symbols": len(done),
            "tables": {t: len(df) for t, df in got.items()}}
