"""Model families — the smile/surface parameterisations behind
``--task surface`` / ``--method``.

Each family registers a :class:`~iv_engine.models.base.
SurfaceModel` (fit_eval + attach_local_vol) that
``pipeline.surface_task.run_surface_fit`` consumes via :func:`get`;
``cli.py --method``'s choices are :func:`available`. The family modules
own the family-specific adapter logic (batch packing, precision modes,
local-vol/density conventions):

  * cubic/smoothing splines -> :mod:`.spline` (incl. the compensated
    double-f32 <=1e-8-parity mode)
  * SVI slices              -> :mod:`.svi`
  * eSSVI joint surfaces    -> :mod:`.essvi`
  * SABR (Hagan)            -> :mod:`.sabr`
  * RBF/thin-plate          -> :mod:`.rbf` (scattered-quote packing)
  * Andreasen-Huge          -> :mod:`.andreasen_huge` (measure-converted
    density)
"""

from iv_engine.models.base import (  # noqa: F401
    PERSIST_KEYS,
    SurfaceModel,
    available,
    get,
)
