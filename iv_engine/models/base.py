"""SurfaceModel protocol + registry — THE dispatch surface for smile/
surface families.

Every family (cubic spline, smoothing spline, SVI, eSSVI, SABR, RBF,
Andreasen-Huge) registers a :class:`SurfaceModel` whose two callables
own the family-specific logic that used to live inline in
``pipeline.surface_task``:

  * ``fit_eval(k, iv, T, quote_mask, scfg, dev) -> dict`` — batched
    fused fit + dense-grid eval + diagnostics. Inputs are host numpy
    ``(B, E, n)`` batches from ``surface_task.pack_chain_group``; ``dev``
    is the mesh-placement hook (shards the batch dim over the pipeline
    mesh). Output dict carries at least :data:`PERSIST_KEYS` plus ``g``.
  * ``attach_local_vol(res, T, scfg) -> dict`` — adds ``local_vol`` /
    ``density`` columns. This is where the families genuinely differ:
    slice-wise methods extract Dupire local vol from the fitted grid,
    RBF differentiates its scattered fit by finite differences, and AH
    *calibrates* a local vol directly and needs a measure conversion
    for its strike-space density (see models.andreasen_huge).

Consumers: ``pipeline.surface_task.run_surface_fit`` (string method →
``get(name)``) and ``cli.py --method`` (choices = ``available()``).
This module stays import-light (no jax) so the CLI can enumerate
methods without loading a backend; family modules import lazily at
``get()`` time.

Reference analogue: none — the reference had a single hardcoded pandas
interpolation (src/interpolation/core.py:58-61); the model registry is
where the north star's seven families plug into one pipeline.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

# keys every model's fit_eval must produce; surface_task persists these
# (plus local_vol/density after attach_local_vol)
PERSIST_KEYS = ("k_grid", "w_grid", "iv_grid",
                "butterfly_ok", "calendar_ok", "fit_rmse")


@dataclasses.dataclass(frozen=True)
class SurfaceModel:
    """One smile/surface family: name + the two capability callables."""

    name: str
    fit_eval: Callable[..., dict]
    attach_local_vol: Callable[..., dict]
    description: str = ""


# name -> (module, attribute); resolved lazily so `available()` costs no
# jax import (argparse help must stay instant)
_FAMILIES = {
    "cubic_spline": ("iv_engine.models.spline", "CUBIC_SPLINE"),
    "smoothing_spline": ("iv_engine.models.spline",
                         "SMOOTHING_SPLINE"),
    "svi": ("iv_engine.models.svi", "SVI"),
    "essvi": ("iv_engine.models.essvi", "ESSVI"),
    "sabr": ("iv_engine.models.sabr", "SABR"),
    "rbf": ("iv_engine.models.rbf", "RBF"),
    "ah": ("iv_engine.models.andreasen_huge", "AH"),
}


def available() -> tuple:
    """Registered family names (CLI --method choices)."""
    return tuple(_FAMILIES)


def get(name: str) -> SurfaceModel:
    """Resolve a family by name (lazy import of the family module)."""
    try:
        module, attr = _FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown smile method {name!r}; available: "
            f"{', '.join(_FAMILIES)}") from None
    model = getattr(importlib.import_module(module), attr)
    assert model.name == name, (model.name, name)
    return model
