"""Properties that keep the engine portable across hosts and devices:
one compile-cache policy, no branch on the backend's name, device-side
modules free of the table libraries, and a monitor that never opens
the card."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine import compile_cache


@pytest.mark.parametrize("env_dir", [None, "/some/where/else"],
                         ids=["unset", "set"])
def test_compile_cache_honours_env(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: no code sets a directory. Unset:
    the cache goes to the one fixed path inside the checkout."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.enable() == compile_cache.DEFAULT_DIR
        assert calls == [("jax_compilation_cache_dir",
                          compile_cache.DEFAULT_DIR)]
        assert os.path.dirname(compile_cache.DEFAULT_DIR) == os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert compile_cache.enable() == env_dir
        assert calls == []


def _streaming_jaxpr():
    from iv_engine.pipeline.streaming import streaming_step
    B, L, E, n = 2, 32, 3, 6
    args = (jnp.zeros((B, L), jnp.int32), jnp.ones((B, L)),
            jnp.ones((B, L)), jnp.ones((B, L), bool),
            jnp.broadcast_to(jnp.linspace(-0.5, 0.5, n), (B, E, n)),
            jnp.full((B, E, n), 0.3), jnp.broadcast_to(
                jnp.linspace(0.1, 1.0, E), (B, E)))
    return jax.make_jaxpr(lambda *a: streaming_step(
        *a, n_minutes=16, n_grid=8))(*args)


def _slicewise_jaxpr():
    from iv_engine import models
    from iv_engine.config import get_config
    scfg = get_config("testing").surface
    k = np.broadcast_to(np.linspace(-0.5, 0.5, 8), (2, 3, 8))
    iv = np.full((2, 3, 8), 0.3)
    T = np.broadcast_to(np.linspace(0.1, 1.0, 3), (2, 3))
    fit = models.get("svi").fit_eval
    return jax.make_jaxpr(lambda a, b, c: fit(
        a, b, c, np.ones((2, 3, 8), bool), scfg))(k, iv, T)


@pytest.mark.parametrize("trace", [_streaming_jaxpr, _slicewise_jaxpr],
                         ids=["streaming_step", "slicewise_fit_eval"])
def test_same_program_whatever_the_backend_name(monkeypatch, trace):
    """No code path depends on jax.default_backend(): the traced
    program is identical whatever platform name JAX knows the backend
    reports."""
    from jax._src import xla_bridge
    programs = set()
    for name in sorted(xla_bridge.known_platforms()):
        monkeypatch.setattr(jax, "default_backend", lambda n=name: n)
        jax.clear_caches()
        programs.add(str(trace()))
    assert len(programs) == 1


def test_device_modules_import_without_pandas():
    """The device side (stage kernels, streaming, the serving session
    and daemon) imports on a host without pandas or pyarrow."""
    code = ("import sys; sys.modules['pandas'] = None; "
            "sys.modules['pyarrow'] = None; "
            "import iv_engine.pipeline.tasks, iv_engine.pipeline.streaming, "
            "iv_engine.pipeline.stream_service, iv_engine.pipeline.serve")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo)
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=repo,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


def test_monitor_render_never_initialises_jax(tmp_path, monkeypatch):
    """The side monitor shares the host with the process that owns the
    card: it must render from manifests and the runner's metrics
    snapshots without ever asking JAX for a device."""
    from iv_engine.config import get_config
    from iv_engine.monitoring.metrics import StepMetrics
    from iv_engine.monitoring.monitor import RealtimeMonitor
    from iv_engine.pipeline.manifest import RunManifest

    def no_device(*a, **k):
        raise AssertionError("the monitor touched a JAX device")

    cfg = get_config("testing")
    cfg.checkpoint.manifest_dir = str(tmp_path / "runs")
    cfg.monitoring.snapshot_dir = str(tmp_path / "snap")
    m = RunManifest(cfg.checkpoint.manifest_dir, "interpolation", 1)
    m.initialize_symbols(["a", "b"])
    m.complete_symbol("a", input_rows=5, output_rows=10, processing_time=0.1)
    m.flush()
    metrics = StepMetrics(snapshot_dir=cfg.monitoring.snapshot_dir)
    metrics.snapshot("fused_1")
    import json
    path = os.path.join(cfg.monitoring.snapshot_dir, "metrics_fused_1.json")
    with open(path) as f:
        snap = json.load(f)
    snap["device"] = {"bytes_in_use": 3 * 2**30, "bytes_limit": 60 * 2**30}
    with open(path, "w") as f:
        json.dump(snap, f)

    monkeypatch.setattr(jax, "devices", no_device)
    monkeypatch.setattr(jax, "local_devices", no_device)
    mon = RealtimeMonitor(cfg)
    text = mon.render(mon._latest_manifest())
    assert "completed=1" in text
    assert "device mem 3.00 / 60.00 GB" in text
    mon.snapshot(mon._latest_manifest())

    # and importing the monitor does not even load JAX
    code = ("import sys, iv_engine.monitoring.monitor; "
            "sys.exit('jax' in sys.modules)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
