"""Persistent XLA compilation cache, one policy for every entry point.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set: JAX reads it itself
and this module sets nothing. Otherwise the cache lives at one fixed path
inside the checkout, so repeated runs of the CLI, the benchmark and the
smoke script find each other's compiled programs (the directory is part
of the cache key, so a path that moves never hits).
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable(default_dir: str = DEFAULT_DIR) -> str:
    """Point JAX's persistent cache at ``default_dir`` unless
    ``JAX_COMPILATION_CACHE_DIR`` is set. Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir
