"""Logging system: console + rotating files + structured perf events.

Mirrors the reference's three-stream setup (src/monitoring/logging.py:33-71:
main log 100MB x5 at DEBUG, error log 50MB x3, performance log 50MB x3
with date-stamped names) and its pipe-delimited ``PerformanceLogger``
event format (:79-107) so downstream log tooling carries over.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
import time
from datetime import datetime
from typing import Optional

_CONFIGURED = False


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"iv_engine.{name}")


def setup_logging(log_dir: Optional[str] = None,
                  level: str = "INFO") -> logging.Logger:
    """Configure root handlers (idempotent). Console at ``level``; when
    ``log_dir`` is given, adds rotating main/error/performance files with
    the reference's sizes and date-stamped names."""
    global _CONFIGURED
    root = logging.getLogger("iv_engine")
    if _CONFIGURED:
        return root
    root.setLevel(logging.DEBUG)
    console = logging.StreamHandler()
    console.setLevel(getattr(logging, level.upper(), logging.INFO))
    console.setFormatter(logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    root.addHandler(console)

    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y%m%d")
        fmt = logging.Formatter(
            "%(asctime)s - %(name)s - %(levelname)s - %(message)s")

        main = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, f"iv_pipeline_{stamp}.log"),
            maxBytes=100 * 1024 * 1024, backupCount=5)
        main.setLevel(logging.DEBUG)
        main.setFormatter(fmt)
        root.addHandler(main)

        err = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, f"iv_errors_{stamp}.log"),
            maxBytes=50 * 1024 * 1024, backupCount=3)
        err.setLevel(logging.ERROR)
        err.setFormatter(fmt)
        root.addHandler(err)

        perf = logging.getLogger("iv_engine.performance")
        ph = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, f"iv_performance_{stamp}.log"),
            maxBytes=50 * 1024 * 1024, backupCount=3)
        ph.setLevel(logging.INFO)
        ph.setFormatter(logging.Formatter("%(asctime)s|%(message)s"))
        perf.addHandler(ph)
        # three-stream separation: perf events must NOT propagate up to
        # iv_engine's console + main-file handlers — a 10k-symbol run would
        # flood the console (garbling the --with-monitor repaint) and
        # duplicate the whole perf stream into the main log
        perf.propagate = False

    _CONFIGURED = True
    return root


class PerformanceLogger:
    """Structured pipe-delimited perf events (reference format,
    monitoring/logging.py:85-107): BATCH_START | BATCH_COMPLETE |
    SYMBOL_PROCESSED | DB_OPERATION (here: STORE_OPERATION)."""

    def __init__(self):
        self._log = logging.getLogger("iv_engine.performance")

    def log_batch_start(self, batch_id: int, total_symbols: int) -> None:
        self._log.info("BATCH_START|%s|symbols=%d|ts=%.3f",
                       batch_id, total_symbols, time.time())

    def log_batch_complete(self, batch_id: int, duration_s: float,
                           total_rows: int) -> None:
        self._log.info("BATCH_COMPLETE|%s|duration=%.3f|rows=%d",
                       batch_id, duration_s, total_rows)

    def log_symbol_processed(self, symbol: str, input_rows: int,
                             output_rows: int, duration_s: float) -> None:
        self._log.info("SYMBOL_PROCESSED|%s|in=%d|out=%d|duration=%.4f",
                       symbol, input_rows, output_rows, duration_s)

    def log_store_operation(self, op: str, table: str, rows: int,
                            duration_s: float) -> None:
        self._log.info("STORE_OPERATION|%s|%s|rows=%d|duration=%.4f",
                       op, table, rows, duration_s)
