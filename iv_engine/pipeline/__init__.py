"""Pipeline orchestration: storage adapters, ingest/bucketing, stage
runners, run-manifest checkpointing (reference L5/L4 layers, SURVEY.md §1).

The table-side names below load on first use, so the device-side modules
(``tasks``, ``streaming``, ``stream_service``) import without pandas.
"""

_LAZY = {
    "MemoryStore": "iv_engine.pipeline.storage",
    "ParquetStore": "iv_engine.pipeline.storage",
    "get_store": "iv_engine.pipeline.storage",
    "RunManifest": "iv_engine.pipeline.manifest",
    "PipelineRunner": "iv_engine.pipeline.runner",
}
__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(
        f"module 'iv_engine.pipeline' has no attribute {name!r}")
