"""Device-state checkpointing (orbax) for fitted surfaces and calibration
parameters.

The reference's only checkpoint store was its progress tables (resume =
re-run symbols; SURVEY.md §5.4) — fitted state never persisted because
nothing was fitted. Here surface fits are real device state worth saving:
``SurfaceFit`` pytrees, SVI/SABR parameter banks, spline operators. The
run *progress* manifest stays in ``pipeline.manifest``; this module is the
array-state side, using orbax so sharded multi-host arrays round-trip.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import jax


def _checkpointer():
    import orbax.checkpoint as ocp
    return ocp.StandardCheckpointer()


def save_state(path: str, state: Any) -> str:
    """Save an array pytree (SurfaceFit, LMResult.params, operators...).

    ``path`` is a directory; an existing checkpoint there is replaced
    (``force=True`` — the previous erase_and_create_empty dance left an
    EXISTING empty directory, which orbax's save rejects with
    "Destination already exists" AFTER the old checkpoint was erased;
    round-4 review, reproduced).
    """
    path = os.path.abspath(path)
    ckptr = _checkpointer()
    ckptr.save(path, state, force=True)
    ckptr.wait_until_finished()
    return path


def restore_state(path: str, template: Optional[Any] = None) -> Any:
    """Restore a pytree saved by :func:`save_state`. ``template`` (a pytree
    of like-shaped arrays or ShapeDtypeStructs) restores custom containers
    and shardings; without it, a plain nested dict comes back."""
    path = os.path.abspath(path)
    ckptr = _checkpointer()
    if template is not None:
        abstract = jax.tree.map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype,
                                           sharding=getattr(a, "sharding", None)),
            template)
        return ckptr.restore(path, abstract)
    return ckptr.restore(path)


def save_surface_fit(path: str, fit) -> str:
    """Persist a SurfaceFit (method string kept alongside the arrays)."""
    payload = {
        "method": jax.numpy.asarray(
            [ord(c) for c in fit.method], jax.numpy.int32),
        "k": fit.k, "expiries": fit.expiries, "w": fit.w, "coefs": fit.coefs,
    }
    return save_state(path, payload)


def restore_surface_fit(path: str):
    from iv_engine.surface.surface import SurfaceFit
    raw = restore_state(path)
    method = "".join(chr(int(c)) for c in raw["method"])
    return SurfaceFit(method=method, k=raw["k"], expiries=raw["expiries"],
                      w=raw["w"], coefs=raw["coefs"])
