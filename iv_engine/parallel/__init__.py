"""Device-mesh scaling: the device-native replacement for the reference's
ProcessPoolExecutor symbol parallelism (SURVEY.md §2 row 24)."""

from iv_engine.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_batch,
    surface_batch_sharding,
)
