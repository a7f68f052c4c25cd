"""Observability: logging, structured perf events, step metrics, monitor
(reference L1 layer: src/monitoring/*, performance_monitor.py)."""

from iv_engine.monitoring.logging import (  # noqa: F401
    PerformanceLogger,
    get_logger,
    setup_logging,
)
from iv_engine.monitoring.metrics import StepMetrics  # noqa: F401
