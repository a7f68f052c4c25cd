"""Mesh construction and sharding helpers.

The reference scaled by forking a ProcessPoolExecutor over symbols with
PostgreSQL as the rendezvous (src/interpolation/batch_processor.py:234-239,
optimized_batch_processor.py:431-436). Here the unit of parallelism is the
same — independent symbols/surfaces — but realised as SPMD data
parallelism over a ``jax.sharding.Mesh``: the surface batch dim is sharded
over the ``data`` axis and, for smile fitting (independent per expiry),
the expiry dim can additionally shard over a ``slice`` axis. XLA inserts
no collectives on this path (embarrassingly parallel, like the reference);
collectives appear only in reductions for global diagnostics/metrics
(``psum`` over per-shard violation counts).

Multi-host: call ``jax.distributed.initialize()`` before ``make_mesh``;
the same code paths shard over DCN-connected hosts (SURVEY.md §5.8).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "slice"),
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a device mesh.

    Args:
      shape: mesh shape; default puts every device on the first (data)
        axis, e.g. (N, 1) for N devices.
      axis_names: names; defaults to ('data', 'slice') — data parallelism
        over surfaces plus optional slice (expiry) sharding.
      devices: explicit device list (defaults to ``jax.devices()``).
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names=tuple(axis_names))


def pipeline_mesh(mesh_shape: Optional[Sequence[int]],
                  axis_names: Sequence[str] = ("data",)) -> Optional[Mesh]:
    """The production pipeline's mesh from the config knobs
    (``processing.mesh_shape`` / ``mesh_axis_names``), or ``None`` when
    sharding would be a no-op.

    ``mesh_shape=None`` auto-sizes to every visible device (the device
    analogue of the reference defaulting max_workers to the host's
    cores, config_production.py:45); an explicit shape pins the layout
    and uses the FIRST prod(shape) visible devices — it need not cover
    the host (round-4 review: requiring prod == all devices made the
    documented pinning knob unusable on any host). Axis names are
    reconciled to the shape's rank: extended with generated names or
    truncated, so a 2-D shape works with the 1-axis default. A single
    visible device — the common CLI case on this box — returns ``None``
    so the runner skips device_put sharding entirely."""
    devices = jax.devices()
    n_dev = len(devices)
    if mesh_shape is None:
        if n_dev == 1:
            return None
        mesh_shape = (n_dev,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in mesh_shape)
    need = int(np.prod(shape))
    if need <= 1:
        return None
    if need > n_dev:
        raise ValueError(
            f"processing.mesh_shape={shape} needs {need} devices; "
            f"{n_dev} visible")
    if need != n_dev and jax.process_count() > 1:
        # a devices[:need] subset under jax.distributed could land every
        # mesh device on host 0 — host 1's device_put would then target
        # non-addressable devices and crash asymmetrically (round-4
        # review). Multi-host pins must cover the full device set; use
        # --shard for coarser scale-out.
        raise ValueError(
            f"processing.mesh_shape={shape} covers {need} of {n_dev} "
            f"devices under jax.distributed ({jax.process_count()} "
            f"processes); a partial mesh is only supported single-host")
    names = tuple(axis_names)[:len(shape)]
    names = names + tuple(f"ax{i}" for i in range(len(names), len(shape)))
    return make_mesh(shape, names, devices=devices[:need])


def surface_batch_sharding(mesh: Mesh, shard_expiries: bool = False):
    """NamedSharding for (B, E, n) surface-batch arrays: B over 'data',
    optionally E over 'slice'."""
    spec = P("data", "slice" if shard_expiries else None, None)
    return NamedSharding(mesh, spec)


def shard_batch(mesh: Mesh, *arrays, axis: int = 0):
    """Place arrays with their ``axis`` dim sharded over the mesh 'data'
    axis (the device analogue of handing each pool worker a symbol batch)."""
    out = []
    for a in arrays:
        spec = [None] * a.ndim
        spec[axis] = "data"
        out.append(jax.device_put(a, NamedSharding(mesh, P(*spec))))
    return out if len(out) > 1 else out[0]


def shard_rows(mesh, *arrays, expect_dim0: int | None = None):
    """Tolerant batch-dim placement for the production pipeline: place
    each array with dim 0 (the symbol/underlying/batch dim) sharded over
    the mesh's FIRST axis. Unlike :func:`shard_batch` (which asserts a
    'data' axis and always shards), this passes through unchanged on any
    of: ``mesh is None`` (single-device fallback), a ``None`` array, a
    scalar, a dim 0 not divisible by the axis size (tiny tail batches
    below the padding schedule), or — when ``expect_dim0`` is given — a
    dim 0 that isn't the session batch size (guards tree-mapped use over
    mixed pytrees). One definition serves PipelineRunner, the surface
    task, and StreamingSession (round-4 review: three divergent copies).
    Everything downstream is per-row math, so jit compiles the same
    program SPMD across the shards — no collectives, exactly the
    reference's embarrassingly parallel symbol fan-out."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    ax = mesh.axis_names[0]
    n = mesh.shape[ax]
    out = []
    for a in arrays:
        nd = getattr(a, "ndim", 0)
        if a is not None and nd >= 1 and a.shape[0] >= n \
                and a.shape[0] % n == 0 \
                and (expect_dim0 is None or a.shape[0] == expect_dim0):
            spec = [None] * nd
            spec[0] = ax
            a = jax.device_put(a, NamedSharding(mesh, P(*spec)))
        out.append(a)
    return out if len(out) > 1 else out[0]


# canonical definition lives in utils (shared with pipeline.ingest);
# re-exported here because every mesh consumer pads through this module
from iv_engine.utils import pad_to_multiple  # noqa: E402,F401
