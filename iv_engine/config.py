"""Typed configuration tree with environment overlays.

Mirrors the reference's layered config system (reference ``config.py:9-136``
and ``config_production.py:10-258``) but with every knob actually wired —
the reference declared ``frequency`` / ``max_gap_hours`` / ``extrapolate`` /
``preserve_greeks`` and never read them (SURVEY.md §2.1.5); here each field
is consumed by the engine it configures.

Layering: defaults -> environment preset (``development`` / ``testing`` /
``production``) -> explicit overrides -> env vars (``IVTPU_*``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class StorageConfig:
    """Storage adapter selection.

    Replaces the reference's three PostgreSQL manager variants
    (``src/database/connection.py``, ``optimized_connection.py``,
    ``user_optimized_connection.py``). The hot path never touches storage;
    adapters only feed/drain device batches at the pipeline edges.
    """

    backend: str = "parquet"  # 'parquet' | 'memory' | 'postgres'
    root: str = "./data"  # dataset root for the parquet backend
    # Postgres adapter settings (used only when backend == 'postgres' and
    # psycopg2 is importable; mirrors reference DatabaseConfig, config.py:10-26)
    pg_host: str = "localhost"
    pg_database: str = "trading_data"
    pg_user: str = "postgres"
    pg_password: str = ""
    pg_port: int = 5432


@dataclass
class ProcessingConfig:
    """Batching / sharding configuration.

    The reference's ``max_workers`` process-pool knob (config.py:31) becomes
    the device-mesh shape; ``symbols_per_batch`` becomes the padded device
    batch; complexity bin-packing (optimized_batch_processor.py:123-164)
    becomes static length-bucketing.
    """

    batch_size: int = 256  # symbols (series) per device step
    # padded series lengths; 65536 covers the reference's full envelope
    # (30-day span cap = 43200 minutes, core.py:37)
    bucket_sizes: tuple = (64, 256, 1024, 4096, 16384, 65536)
    # cap on batch x bucket_len grid slots per device step: compile time
    # grows superlinearly with the grid size, so big buckets run with
    # proportionally smaller batch dims
    max_slots_per_batch: int = 1 << 20
    # symbols per storage read: bounds host RAM at 32M+-row scale (the
    # reference's streaming cursors, optimized_connection.py:113-129);
    # 0 = read all requested symbols at once
    read_chunk_symbols: int = 2048
    # multi-process / multi-host scale-out, the reference's own model
    # lifted to the cluster level (ProcessPoolExecutor fan-out with the
    # database as rendezvous, batch_processor.py:234-239): process i of
    # n owns symbol s iff crc32(s) % n == i (hash ownership — stable
    # under resume and shared-table discovery); storage upserts are the
    # rendezvous, run manifests are per-process. CLI: --shard I/N.
    shard_index: int = 0
    shard_count: int = 1
    # pipeline data-parallel mesh (parallel.mesh.pipeline_mesh): bucket
    # batches shard their symbol dim over the first axis — the device
    # form of the reference's ProcessPoolExecutor fan-out. None -> all
    # visible devices (single device -> no sharding, transparently)
    mesh_shape: Optional[tuple] = None  # None -> (num_devices,)
    mesh_axis_names: tuple = ("data",)
    # (no donate_buffers knob: buffer donation is structural where it is
    # correct — the streaming ring updates, pipeline/ringbuffer.py:70 —
    # and a config switch for it would be decorative, the reference
    # defect class SURVEY §2.1.5 guards against)
    dtype: str = "float32"  # device compute dtype ('float32'|'bfloat16')
    # (no parity_dtype knob: the f64 oracle dtype is the TEST SUITE's
    # x64 configuration — tests/conftest.py — not a production setting;
    # declaring it here was decorative, SURVEY §2.1.5)
    enable_logging: bool = True  # cli: skip setup_logging when False
    log_level: str = "INFO"


@dataclass
class InterpolationConfig:
    """Task-1 engine settings (reference InterpolationConfig, config.py:39-46).

    Unlike the reference, every field is wired:
      * ``frequency``      -> output grid step (core hardcoded '1min', core.py:45)
      * ``method``         -> 'linear' | 'nearest' | 'ffill'
      * ``max_gap_hours``  -> gaps wider than this are masked, not bridged
      * ``min_data_points``-> symbols below this are skipped (core.py:26)
      * ``extrapolate``    -> allow values outside the observed time range
      * ``compute_greeks`` -> actually populate delta/gamma/theta/vega/rho
        (the reference reserved schema columns, schema.py:36-41, and never
        filled them)
    """

    frequency: str = "1min"
    method: str = "linear"
    max_gap_hours: int = 48
    min_data_points: int = 10
    extrapolate: bool = False
    compute_greeks: bool = True
    max_span_days: int = 30  # reference guardrail, core.py:37
    max_timeline_points: int = 100_000  # reference guardrail, core.py:49


@dataclass
class CandleReconstructionConfig:
    """Task-2 engine settings (reference config.py:49-55)."""

    target_frequency: str = "5min"
    source_frequency: str = "1min"
    min_candles_required: int = 5  # incomplete-bucket filter, core.py:85-89
    validate_ohlc: bool = True


@dataclass
class DataBridgeConfig:
    """Synthetic-OHLCV bridge settings (reference config.py:58-75)."""

    conversion_strategy: str = "spread_simulation"
    # 'spread_simulation' | 'price_midpoint' | 'trend_following' | 'simple_spread'
    enable_quality_checks: bool = True
    seed: int = 0  # counter-based PRNG root key (replaces global np.random)
    base_spread_percent: float = 0.002
    volatility_factor: float = 1.5
    min_spread_percent: float = 0.0005
    # quality-gate ceiling on (high-low)/source_price; the reference's
    # gate hardcoded 10% (ohlcv_converter.py:392) while its config
    # declared an unused 2% — here the knob IS the gate
    max_spread_percent: float = 0.10
    trend_strength: float = 0.6
    base_volume: float = 50.0  # exponential volume imputation scale


@dataclass
class SurfaceConfig:
    """Vol-surface engine settings (new capability; north star in BASELINE.md).

    The reference only had per-column linear interpolation plus a dead
    Black-Scholes module (greeks.py); this engine generalises it to full
    smile/surface fitting.
    """

    smile_method: str = "cubic_spline"
    # 'cubic_spline' | 'smoothing_spline' | 'svi' | 'essvi' | 'sabr'
    # | 'rbf' | 'ah'
    grid_strikes: int = 50   # dense eval grid in strike (per expiry)
    # cubic-spline boundary condition; 'not-a-knot' (SciPy's default)
    # avoids the natural-BC edge artifact in the butterfly diagnostics
    # (ops.spline_matrix._curvature_operator)
    spline_bc: str = "not-a-knot"
    # persist Dupire local vol + risk-neutral density columns with the
    # evaluated grid (surface.localvol; slice-wise methods only)
    compute_local_vol: bool = False
    # SVI batched Levenberg-Marquardt iteration budget
    lm_max_iters: int = 50
    svi_weighting: str = "uniform"  # 'uniform' | 'vega' residual weights
    # inline the LM iterations into one straight-line program instead of
    # a loop: a bigger executable and a longer compile for <2% on the
    # H100 at 1024 x 30 slices (PERF.md "SVI LM");
    # on CPU the giant executables were implicated in an LLVM-JIT
    # segfault after ~380 in-process compiles (full-suite runs)
    svi_unroll: bool = False
    smoothing_lam: float = 1e-4     # smoothing_spline curvature penalty
    # RBF / thin-plate
    rbf_smoothing: float = 1e-8
    rbf_kernel: str = "thin_plate"  # 'thin_plate' | 'gaussian' | 'multiquadric'
    # no-arbitrage penalty smoothing for the RBF surface (BASELINE
    # config #4): hinge weights on negative butterfly-g / negative
    # calendar dw over a dense penalty grid (ops.rbf.fit_rbf_arbfree);
    # 0 keeps the plain interpolating/smoothing fit
    rbf_butterfly_penalty: float = 0.0
    rbf_calendar_penalty: float = 0.0
    rbf_penalty_iters: int = 16     # damped Gauss-Newton budget
    # reduced RBF basis for the penalized fit: c < N centers spread over
    # the live quotes (least-squares RBF, ops.rbf n_centers) — the KKT
    # factorization drops (N+p)^3 -> (c+p)^3 (~60x fewer flops at
    # N=2048, c=512); None or 0 keeps the exact
    # every-site-a-center estimator
    rbf_centers: int | None = None
    # Andreasen-Huge one-step surfaces (method 'ah'): dense PDE grid
    # resolution and per-slice LM budget (ops.andreasen_huge)
    ah_grid: int = 257
    ah_iters: int = 16
    # cap on surfaces per compiled AH fit: the sequential maturity scan
    # x LM loop dominates (a dependent chain per surface), so giant
    # batches buy longer compiles, not throughput; larger chains are fit in <=this-size
    # chunks instead of one giant program (a chunk may still pad up to
    # the mesh multiple when sharded). 0/None disables the cap.
    ah_max_batch: int | None = 512
    # parity mode (CLI --parity): run cubic-spline fit+eval on the
    # compensated double-f32 path (ops.spline_compensated) and persist
    # the df64 low limb (total_variance_lo) — the pair reproduces the
    # SciPy x64 oracle to ~1e-12, meeting the <=1e-8 north star that
    # plain f32 output cannot (ulp/2 ~ 6e-8 at w ~ 1.6). Throughput
    # of both paths on the H100 is in PERF.md.
    compensated: bool = False
    # No-arbitrage handling: hinge-penalty weight on negative butterfly-g
    # during SVI calibration (calendar no-arb is structural: total-variance
    # interpolation between calendar-ordered slices cannot create it)
    butterfly_penalty: float = 0.0


@dataclass
class MonitoringConfig:
    """Observability settings (reference monitoring/logging.py + performance_monitor.py)."""

    log_dir: str = "./logs"
    snapshot_dir: str = "./snapshots"
    enable_snapshots: bool = True
    refresh_interval_s: float = 5.0
    memory_warn_pct: float = 80.0
    memory_crit_pct: float = 90.0
    low_throughput_surfaces_s: float = 100.0
    enable_profiler: bool = False
    profiler_dir: str = "./profiles"


@dataclass
class CheckpointConfig:
    """Run-manifest checkpoint/resume (replaces the reference's progress
    tables, schema.py:88-109, with a host-side jsonl manifest)."""

    manifest_dir: str = "./runs"
    checkpoint_interval: int = 100  # manifest events buffered between flushes
    max_retries: int = 3  # bucket retry budget (runner._attempt)


@dataclass
class Config:
    storage: StorageConfig = field(default_factory=StorageConfig)
    processing: ProcessingConfig = field(default_factory=ProcessingConfig)
    interpolation: InterpolationConfig = field(default_factory=InterpolationConfig)
    candle_reconstruction: CandleReconstructionConfig = field(
        default_factory=CandleReconstructionConfig
    )
    data_bridge: DataBridgeConfig = field(default_factory=DataBridgeConfig)
    surface: SurfaceConfig = field(default_factory=SurfaceConfig)
    monitoring: MonitoringConfig = field(default_factory=MonitoringConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    environment: str = "production"
    debug: bool = False


_ENV_PRESETS = {
    # mirrors reference presets: workers 4/8/32, batch 10/25/100
    # (config.py:100-126). Production batch is 256: compile time grows
    # superlinearly with the batch dim while runtime per batch stays
    # small — 256 symbols x 2048-minute grids is ~0.5M candles per
    # dispatch.
    "development": dict(batch_size=16, log_level="DEBUG", debug=True),
    "testing": dict(batch_size=64, log_level="INFO", debug=False),
    "production": dict(batch_size=256, log_level="INFO", debug=False),
}


def load_dotenv(path: str = ".env", override: bool = False) -> bool:
    """Load ``KEY=VALUE`` lines from a ``.env`` file into ``os.environ``.

    The reference loaded ``.env`` via python-dotenv (config.py:4-7);
    this is the same contract without the dependency: ``#`` comments and
    blank lines are ignored, optional surrounding quotes are stripped,
    and existing environment variables win unless ``override``. Returns
    True if the file existed.
    """
    if not os.path.isfile(path):
        return False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if value[:1] in ("'", '"') and value[-1:] == value[:1]:
                value = value[1:-1]
            if override or key not in os.environ:
                os.environ[key] = value
    return True


def get_config(environment: Optional[str] = None, **overrides) -> Config:
    """Build a config for the given environment.

    ``environment`` falls back to the ``ENVIRONMENT`` env var (the reference
    honoured the same variable, config.py:97). ``overrides`` accepts
    dotted-path keys, e.g. ``get_config(surface__grid_strikes=64)``.
    A ``.env`` file in the working directory is loaded first (reference
    parity: python-dotenv at config.py:4-7; real environment wins).
    """
    load_dotenv()
    env = environment or os.getenv("ENVIRONMENT", "production")
    if env not in _ENV_PRESETS:
        raise ValueError(f"Unknown environment: {env!r}")
    preset = _ENV_PRESETS[env]

    cfg = Config(environment=env, debug=preset["debug"])
    cfg.processing.batch_size = preset["batch_size"]
    cfg.processing.log_level = preset["log_level"]

    # Env-var overlay: IVTPU_<SECTION>__<FIELD>
    for key, raw in os.environ.items():
        if key.startswith("IVTPU_") and "__" in key:
            section_name, field_name = key[len("IVTPU_"):].lower().split("__", 1)
            _apply_override(cfg, section_name, field_name, raw)

    # Explicit overrides: section__field=value
    for key, value in overrides.items():
        if "__" not in key:
            raise ValueError(f"Override key must be section__field: {key!r}")
        section_name, field_name = key.split("__", 1)
        _apply_override(cfg, section_name, field_name, value)

    return cfg


def _parse_tuple(raw: str) -> tuple:
    """Comma-separated env string -> tuple, int elements where they parse.

    Non-numeric elements stay strings so tuple-of-str knobs work too
    (IVTPU_PROCESSING__MESH_AXIS_NAMES=data,model must not crash the
    way the int()-only coercion did).
    """
    out = []
    for v in raw.split(","):
        v = v.strip()
        try:
            out.append(int(v))
        except ValueError:
            out.append(v)
    return tuple(out)


def _apply_override(cfg: Config, section_name: str, field_name: str, value) -> None:
    if not hasattr(cfg, section_name):
        raise ValueError(f"Unknown config section: {section_name!r}")
    section = getattr(cfg, section_name)
    if not hasattr(section, field_name):
        raise ValueError(f"Unknown field {field_name!r} in section {section_name!r}")
    current = getattr(section, field_name)
    if isinstance(value, str) and not isinstance(current, str):
        # parse env-var strings into the field's declared type
        if isinstance(current, bool):
            value = value.lower() in ("1", "true", "yes", "on")
        elif isinstance(current, int):
            value = int(value)
        elif isinstance(current, float):
            value = float(value)
        elif isinstance(current, tuple):
            value = _parse_tuple(value)
        elif current is None:
            # a None default hides the declared type, so consult the
            # dataclass annotation (round-4 review: the documented
            # IVTPU_PROCESSING__MESH_SHAPE=4,1 was stored as the raw
            # string and crashed every PipelineRunner init)
            ann = str(next((f.type for f in dataclasses.fields(section)
                            if f.name == field_name), ""))
            if value.strip().lower() in ("", "none", "null"):
                value = None
            elif "bool" in ann:  # before int: bools are ints in Python
                value = value.lower() in ("1", "true", "yes", "on")
            elif "tuple" in ann:
                value = _parse_tuple(value)
            elif "int" in ann:
                value = int(value)
            elif "float" in ann:
                value = float(value)
    setattr(section, field_name, value)


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)
