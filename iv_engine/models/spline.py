"""Cubic-spline and smoothing-spline smile models.

``cubic_spline`` is the flagship family (the headline benchmark path).
It carries the framework's precision switch: with
``surface.compensated = True`` the fit+eval runs on the double-f32 path
(``ops.spline_compensated``) and the persisted surface additionally
carries the df64 low limb (``total_variance_lo`` column) — that pair
reproduces the SciPy x64 oracle to ~1e-12, closing the <=1e-8 north
star that plain f32 output cannot reach (ulp/2 ~ 6e-8 at w ~ 1.6).

``smoothing_spline`` trades exact interpolation for a curvature
penalty (ops.smoothing_spline) — the noisy-quote regime.
"""

from __future__ import annotations

import numpy as np

from iv_engine.models._slicewise import (slicewise_local_vol,
                                         slicewise_model)
from iv_engine.models.base import SurfaceModel

# re-exported kernels (the model's public math surface)
from iv_engine.ops.cubic_spline import (  # noqa: F401
    eval_cubic_spline,
    fit_cubic_spline,
    fit_eval_smile,
)
from iv_engine.ops.spline_matrix import (  # noqa: F401
    build_surface_operators,
    fit_eval_surface_grid,
)


def _cubic_fit_eval(k, iv, T, quote_mask, scfg, dev=None):
    import jax.numpy as jnp
    if not getattr(scfg, "compensated", False):
        return slicewise_model("cubic_spline", "").fit_eval(
            k, iv, T, quote_mask, scfg, dev)
    # parity mode: double-f32 fit+eval. Inputs are cast to f32 FIRST —
    # the df64 contract is "exact f32 inputs", and the x64 oracle is
    # defined on those same f32 values (bench._spline_accuracy).
    from iv_engine.ops.spline_compensated import (
        fit_eval_surface_compensated)
    bc = scfg.spline_bc
    if bc not in ("natural", "not-a-knot"):
        raise ValueError(
            f"compensated spline supports natural/not-a-knot, got {bc!r}")
    dev = dev or jnp.asarray
    f32 = lambda a: np.asarray(a, np.float32)
    out = fit_eval_surface_compensated(dev(f32(k)), dev(f32(iv)),
                                       dev(f32(T)),
                                       n_grid=scfg.grid_strikes, bc_type=bc)
    # interpolating spline: reprices the quotes exactly by construction
    out["fit_rmse"] = jnp.zeros(out["w_grid"].shape[0],
                                out["w_grid"].dtype)
    return out


CUBIC_SPLINE = SurfaceModel(
    name="cubic_spline",
    fit_eval=_cubic_fit_eval,
    attach_local_vol=slicewise_local_vol,
    description="interpolating cubic-spline smiles; surface.compensated "
                "switches to the double-f32 <=1e-8-parity path")

SMOOTHING_SPLINE = slicewise_model(
    "smoothing_spline",
    "curvature-penalised spline smiles (surface.smoothing_lam)")
