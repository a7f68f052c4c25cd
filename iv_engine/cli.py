"""Command-line interface.

Preserves the reference's operator surface (main.py:459-499,
production_main.py:302-331, complete_pipeline.py:838-862):

  --task {interpolation,bridge,candles,both,pipeline,all}
  --test            3-symbol smoke run (main.py:267-343)
  --resume BATCH_ID re-enqueue pending/error symbols
  --validate-only   environment/readiness checks
  --estimate        processing-time estimate
  --monitor         live progress dashboard
  --generate-sample-candles / --generate-sample-tickers
  --symbols N       limit symbol count
  --env {development,testing,production}
  --list-batches    enumerate prior runs (aspirational in the reference,
                    setup.py:258 — real here)

Also fixes the reference's broken ``--task candles`` route (missing
``def run_task_2``, SURVEY.md §2.1.1) — candles is a first-class task.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="iv-engine",
        description="GPU IV interpolation & candle pipeline (JAX)")
    p.add_argument("--task",
                   choices=["interpolation", "bridge", "candles", "both",
                            "pipeline", "all", "surface", "stream",
                            "serve"],
                   default="all",
                   help="stage(s) to run; 'pipeline' = fused on-device "
                        "chain, 'all' = staged via storage")
    p.add_argument("--test", action="store_true",
                   help="smoke run limited to 3 symbols")
    p.add_argument("--resume", type=int, metavar="BATCH_ID",
                   help="resume pending/error symbols of a prior batch")
    p.add_argument("--validate-only", action="store_true",
                   help="validate environment and data readiness, then exit")
    p.add_argument("--estimate", action="store_true",
                   help="estimate processing time, then exit")
    p.add_argument("--monitor", action="store_true",
                   help="live progress dashboard for the latest batch")
    p.add_argument("--with-monitor", action="store_true",
                   help="run the dashboard in a side process during the "
                        "task (reference production_main.py:246-252)")
    p.add_argument("--generate-sample-candles", action="store_true",
                   help="write synthetic 1-min candles to storage")
    p.add_argument("--generate-sample-tickers", action="store_true",
                   help="write synthetic hourly tickers to storage")
    p.add_argument("--symbols", type=int, default=None,
                   help="limit number of symbols processed")
    from iv_engine.models import available as _model_names
    p.add_argument("--method", default=None, choices=list(_model_names()),
                   help="smile/surface family for --task surface "
                        "(default: config surface.smile_method)")
    p.add_argument("--parity", action="store_true",
                   help="compensated double-f32 surface fits: the "
                        "persisted (total_variance, total_variance_lo) "
                        "pair matches the x64 oracle to <=1e-8 "
                        "(cubic_spline only; throughput cost in "
                        "PERF.md)")
    p.add_argument("--env", choices=["development", "testing", "production"],
                   default=None, help="environment preset")
    p.add_argument("--storage", choices=["parquet", "memory", "postgres"],
                   default=None, help="storage backend override")
    p.add_argument("--data-root", default=None,
                   help="parquet dataset root (default ./data)")
    p.add_argument("--list-batches", action="store_true",
                   help="list prior run manifests")
    p.add_argument("--check", action="store_true",
                   help="audit pipeline results (reference check_results.py)")
    p.add_argument("--visualize", action="store_true",
                   help="render pipeline analysis PNGs "
                        "(reference pipeline_visualizer.py)")
    p.add_argument("--plot-dir", default=".",
                   help="output directory for --visualize figures")
    p.add_argument("--plot-symbol", default=None, metavar="SYM",
                   help="scope --visualize per-symbol figures to one "
                        "symbol (reference check_results.py:441-447)")
    p.add_argument("--quick", action="store_true",
                   help="with --check: quick census only, skip the "
                        "full per-task audits (reference --quick)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable summaries")
    p.add_argument("--batch-id", type=int, default=None,
                   help="bridge only: convert rows from this task-1 batch "
                        "(reference ohlcv_converter.py:31-55)")
    p.add_argument("--start-date", default=None,
                   help="restrict task-1 observations to >= this date")
    p.add_argument("--end-date", default=None,
                   help="restrict task-1 observations to <= this date")
    p.add_argument("--compact", action="store_true",
                   help="compact parquet tables (merge parts, apply "
                        "upsert dedup), then exit")
    p.add_argument("--yes", action="store_true",
                   help="skip interactive confirmations (large runs)")
    p.add_argument("--shard", default=None, metavar="I/N",
                   help="process-level scale-out: this process owns the "
                        "symbols whose crc32(name) %% N == I, e.g. "
                        "--shard 0/4 ... --shard 3/4 on four hosts "
                        "sharing one store; storage upserts are the "
                        "rendezvous, manifests are per-process (the "
                        "reference's worker fan-out lifted to the "
                        "cluster level)")
    p.add_argument("--serve-port", type=int, default=8787,
                   help="TCP port for --task serve (0 = auto)")
    p.add_argument("--serve-transport", choices=["jsonl", "flight"],
                   default="jsonl",
                   help="serving wire protocol: newline-delimited JSON "
                        "or Arrow Flight (gRPC, columnar; needs pyarrow "
                        "with Flight)")
    p.add_argument("--profile", action="store_true",
                   help="wrap the run in a jax.profiler trace "
                        "(written to monitoring.profiler_dir)")
    p.add_argument("--init-env", action="store_true",
                   help="write a .env template with every IVTPU_* knob "
                        "(reference setup.py:104-129 operator "
                        "convenience) and exit")
    p.add_argument("--check-db", action="store_true",
                   help="run the storage-backend connectivity self-test "
                        "(reference setup.py:202-232) and exit")
    return p


_ENV_TEMPLATE = """\
# iv_engine environment template (reference setup.py:108-117).
# Every IVTPU_<SECTION>__<FIELD> maps onto config.py; uncomment to
# override. ENVIRONMENT selects the preset (development|testing|production).
ENVIRONMENT=development

# storage backend: parquet (default) | memory | postgres
#IVTPU_STORAGE__BACKEND=parquet
#IVTPU_STORAGE__ROOT=./data

# postgres (used when backend=postgres; pure-Python driver built in,
# psycopg2 optional)
#IVTPU_STORAGE__PG_HOST=localhost
#IVTPU_STORAGE__PG_PORT=5432
#IVTPU_STORAGE__PG_DATABASE=trading
#IVTPU_STORAGE__PG_USER=postgres
#IVTPU_STORAGE__PG_PASSWORD=

# processing
#IVTPU_PROCESSING__BATCH_SIZE=256
#IVTPU_PROCESSING__MAX_RETRIES=3

# surface engine
#IVTPU_SURFACE__SMILE_METHOD=cubic_spline
#IVTPU_SURFACE__GRID_STRIKES=50

# monitoring
#IVTPU_MONITORING__LOG_DIR=./logs
#IVTPU_MONITORING__SNAPSHOT_DIR=./snapshots
"""


def _check_db(config, args) -> int:
    """Connectivity self-test for the configured backend (reference
    setup.py:202-232 ran SELECT version() against Postgres)."""
    from iv_engine.pipeline.storage import get_store
    try:
        store = get_store(config.storage)
        if hasattr(store, "probe_permissions"):     # PostgresStore
            with store._connect() as conn, conn.cursor() as cur:
                cur.execute("SELECT version()")
                version = cur.fetchone()[0]
            payload = {"ok": True, "backend": "postgres",
                       "server": version,
                       "permissions": store.probe_permissions()}
        else:
            tables = store.tables()
            payload = {"ok": True,
                       "backend": config.storage.backend,
                       "tables": len(tables)}
    except Exception as e:
        payload = {"ok": False, "backend": config.storage.backend,
                   "error": str(e)}
    _emit(args, payload, "storage connectivity")
    return 0 if payload["ok"] else 1


def _emit(args, payload: dict, title: str) -> None:
    if args.json:
        print(json.dumps(payload, default=str))
        return
    print(f"\n=== {title} ===")
    for k, v in payload.items():
        print(f"  {k}: {v}")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.env:
        os.environ["ENVIRONMENT"] = args.env

    if args.init_env:
        root = args.data_root or "."
        os.makedirs(root, exist_ok=True)  # setup flow runs before any
        #                                   other command creates it
        path = os.path.join(root, ".env")
        if os.path.exists(path):
            print(f"refusing to overwrite existing {path}")
            return 1
        with open(path, "w") as f:
            f.write(_ENV_TEMPLATE)
        print(f"wrote {path}")
        return 0

    from iv_engine.config import get_config, load_dotenv
    from iv_engine.monitoring.logging import setup_logging

    # a --data-root .env (written by --init-env) participates in the
    # overlay; get_config() additionally loads ./.env from the CWD
    if args.data_root:
        load_dotenv(os.path.join(args.data_root, ".env"))

    from iv_engine import compile_cache
    compile_cache.enable()

    config = get_config()
    if args.storage:
        config.storage.backend = args.storage
    if args.data_root:
        config.storage.root = args.data_root
    if args.parity:
        config.surface.compensated = True
    if args.shard:
        try:
            i_s, n_s = args.shard.split("/")
            config.processing.shard_index = int(i_s)
            config.processing.shard_count = int(n_s)
        except ValueError:
            p_err = f"--shard expects I/N (got {args.shard!r})"
            print(p_err, file=sys.stderr)
            return 2
        if not (config.processing.shard_count >= 1
                and 0 <= config.processing.shard_index
                < config.processing.shard_count):
            print(f"--shard index out of range: {args.shard}",
                  file=sys.stderr)
            return 2
    if config.processing.enable_logging:
        setup_logging(config.monitoring.log_dir,
                      config.processing.log_level)

    from iv_engine.pipeline import PipelineRunner, RunManifest
    from iv_engine.pipeline import storage as st

    if args.check_db:
        return _check_db(config, args)

    if args.list_batches:
        batches = RunManifest.list_batches(config.checkpoint.manifest_dir)
        if args.json:
            print(json.dumps(batches, default=str))
        else:
            for b in batches:
                print(f"  batch {b['batch_id']} [{b['task']}]: "
                      f"{b['by_status']}")
            if not batches:
                print("  (no batches)")
        return 0

    runner = PipelineRunner(config)
    runner.install_signal_handler()

    if args.compact:
        if not hasattr(runner.store, "compact"):
            _emit(args, {"ok": False,
                         "reason": "backend has no compaction"}, "compact")
            return 1
        report = {}
        for table in runner.store.tables():
            before = len(runner.store._parts(table))
            runner.store.compact(table)
            report[table] = {"parts_before": before, "parts_after": 1}
        _emit(args, report, "compaction complete")
        return 0

    if args.check:
        from iv_engine.pipeline.check_results import (
            check_candle_results, check_interpolation_results,
            quick_summary)
        _emit(args, quick_summary(runner.store), "quick summary")
        if args.quick:
            return 0
        _emit(args, check_interpolation_results(runner.store),
              "task 1 audit")
        _emit(args, check_candle_results(runner.store), "task 2 audit")
        from iv_engine.pipeline.check_results import (
            check_surface_results)
        _emit(args, check_surface_results(runner.store), "surface audit")
        return 0

    if args.visualize:
        from iv_engine.pipeline.visualize import PipelineVisualizer
        report = PipelineVisualizer(
            runner.store,
            out_dir=args.plot_dir).summary_report(symbol=args.plot_symbol)
        _emit(args, report, "visualization report")
        return 0

    if args.generate_sample_candles or args.generate_sample_tickers:
        from iv_engine.pipeline.sample_data import (
            generate_sample_candles, generate_sample_tickers)
        n = args.symbols or 5
        if args.generate_sample_tickers:
            df = generate_sample_tickers(num_symbols=n)
            rows = runner.store.write(st.TICKERS, df,
                                      upsert_keys=["symbol", "date"])
            _emit(args, {"table": st.TICKERS, "rows": rows,
                         "symbols": n}, "sample tickers generated")
        if args.generate_sample_candles:
            df = generate_sample_candles(num_symbols=n)
            rows = runner.store.write(st.MINUTE_CANDLES, df,
                                      upsert_keys=["symbol", "timestamp"])
            _emit(args, {"table": st.MINUTE_CANDLES, "rows": rows,
                         "symbols": n}, "sample candles generated")
        return 0

    if args.validate_only:
        from iv_engine.pipeline.validate import (
            validate_readiness)
        report = validate_readiness(config, runner.store,
                                    task=args.task)
        _emit(args, report, "readiness report")
        return 0 if report["ready"] else 1

    if args.estimate:
        from iv_engine.pipeline.validate import estimate_processing
        report = estimate_processing(config, runner.store)
        _emit(args, report, "processing estimate")
        return 0

    if args.monitor:
        from iv_engine.monitoring.monitor import RealtimeMonitor
        RealtimeMonitor(config).run()
        return 0

    limit = 3 if args.test else args.symbols
    monitor_proc = None
    if args.with_monitor:
        # spawn (not fork): forking a process whose JAX runtime already
        # started threads can deadlock. The dashboard reads manifests and
        # snapshots only, so it never opens the card this process owns
        import multiprocessing as mp
        from iv_engine.monitoring.monitor import RealtimeMonitor
        ctx = mp.get_context("spawn")
        monitor_proc = ctx.Process(
            target=RealtimeMonitor(config).run, daemon=True,
            # the side dashboard starts BEFORE the run's first manifest
            # flush: wait for a new batch instead of exiting on the
            # previous (finished) one or on a missing runs dir
            kwargs={"wait_for_new": True})
        monitor_proc.start()
    t0 = time.time()
    from contextlib import nullcontext
    from iv_engine.monitoring.metrics import profile_trace
    profiling = args.profile or config.monitoring.enable_profiler
    trace = (profile_trace(config.monitoring.profiler_dir) if profiling
             else nullcontext())
    with trace:
        out = _dispatch(args, runner, limit)
    out["wall_s"] = round(time.time() - t0, 3)
    out["status"] = runner.status()
    if profiling:
        out["profile_dir"] = config.monitoring.profiler_dir
    if monitor_proc is not None:
        monitor_proc.join(timeout=2 * config.monitoring.refresh_interval_s)
        if monitor_proc.is_alive():
            monitor_proc.terminate()
    _emit(args, out, f"task={args.task} complete")
    return 0


def _confirm_large_run(args, runner, limit) -> bool:
    """Reference operator guard (main.py:345-377: >100-symbol prompt;
    production_main.py:231-241: >1M-row prompt), active only on a TTY and
    bypassed by --yes/--test."""
    import sys as _sys
    if args.yes or args.test or not _sys.stdin.isatty():
        return True
    from iv_engine.pipeline import storage as st
    n = len(runner.store.list_symbols(st.TICKERS))
    if limit:
        n = min(n, limit)
    if n <= 100:
        return True
    answer = input(f"process {n} symbols? [y/N] ").strip().lower()
    return answer in ("y", "yes")


def _dispatch(args, runner, limit):
    from iv_engine.pipeline import storage as st

    if args.task in ("interpolation", "both", "pipeline", "all") \
            and not _confirm_large_run(args, runner, limit):
        return {"aborted": "user declined large run"}

    if args.task == "interpolation":
        out = {"task1": runner.run_task1(resume_batch_id=args.resume,
                                         limit=limit,
                                         start_date=args.start_date,
                                         end_date=args.end_date)}
    elif args.task == "bridge":
        syms = (runner.store.list_symbols(st.INTERPOLATED)[:limit]
                if limit else None)
        out = {"bridge": runner.run_bridge(symbols=syms,
                                           batch_id=args.batch_id,
                                           resume_batch_id=args.resume)}
    elif args.task == "candles":
        syms = (runner.store.list_symbols(st.MINUTE_CANDLES)[:limit]
                if limit else None)
        out = {"task2": runner.run_task2(symbols=syms,
                                         resume_batch_id=args.resume)}
    elif args.task == "both":
        out = {"task1": runner.run_task1(resume_batch_id=args.resume,
                                         limit=limit,
                                         start_date=args.start_date,
                                         end_date=args.end_date)}
        # scope task2 to this run's symbols when the run itself is
        # scoped — '--test' used to smoke-run task1 on 3 symbols and
        # then reconstruct EVERY candle symbol in storage (round-4
        # review)
        scope = None
        if limit or args.resume or args.start_date or args.end_date:
            m = runner._manifest("interpolation",
                                 out["task1"].get("batch_id"))
            scope = sorted(s for s, r in m.records().items()
                           if r.status == "completed")
        out["task2"] = runner.run_task2(symbols=scope)
    elif args.task == "surface":
        from iv_engine.pipeline.surface_task import run_surface_fit
        out = {"surface": run_surface_fit(runner.config, runner.store,
                                          limit=limit,
                                          method=args.method)}
    elif args.task == "serve":
        if args.serve_transport == "flight":
            from iv_engine.pipeline.flight_service import (
                run_serve_flight)
            run_serve_flight(runner.config, runner.store,
                             port=args.serve_port,
                             n_underlyings=limit or 64)
        else:
            from iv_engine.pipeline.serve import run_serve
            run_serve(runner.config, runner.store, port=args.serve_port,
                      n_underlyings=limit or 64)
        out = {"serve": "stopped"}
    elif args.task == "stream":
        from iv_engine.pipeline.stream_service import (
            run_stream_replay)
        out = {"stream": run_stream_replay(
            runner.config, n_underlyings=limit or 64)}
    elif args.task == "pipeline":
        # fused: stages chained on-device, no storage round-trips between
        out = runner.run_pipeline_fused(limit=limit,
                                        resume_batch_id=args.resume,
                                        start_date=args.start_date,
                                        end_date=args.end_date)
    else:  # all (staged via storage)
        out = runner.run_all(limit=limit, resume_batch_id=args.resume,
                             start_date=args.start_date,
                             end_date=args.end_date)
    return out


if __name__ == "__main__":
    sys.exit(main())
