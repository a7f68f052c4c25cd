"""Shared machinery for the slice-wise families (spline / svi / essvi /
sabr): one smile parameterisation per expiry, total-variance
interpolation across maturity, Dupire local vol from the evaluated grid.

The family modules compose their :class:`~.base.SurfaceModel` from
these; family-specific behavior (compensated spline precision, AH's
own local vol, RBF's scattered fit) lives in the family modules.
"""

from __future__ import annotations

import jax.numpy as jnp

from iv_engine.models.base import SurfaceModel


def slicewise_fit_eval(method: str):
    """fit_eval for the families served by surface.fit_eval_surface."""

    def fit_eval(k, iv, T, quote_mask, scfg, dev=None):
        from iv_engine.surface.surface import fit_eval_surface
        dev = dev or jnp.asarray
        return fit_eval_surface(
            dev(k), dev(iv), dev(T),
            method=method, n_grid=scfg.grid_strikes,
            svi_iters=scfg.lm_max_iters,
            svi_butterfly_penalty=scfg.butterfly_penalty,
            svi_weighting=scfg.svi_weighting,
            svi_unroll=scfg.svi_unroll,
            smoothing_lam=scfg.smoothing_lam,
            spline_bc=scfg.spline_bc,
            quote_mask=dev(quote_mask))

    return fit_eval


def slicewise_local_vol(res: dict, T, scfg) -> dict:
    """Dupire local vol + risk-neutral density from an evaluated grid.

    Cells where g <= 0 or dw/dT < 0 hold eps-clamped garbage (~1e10x
    real values); persist NaN there so no downstream consumer mistakes
    them for real local vols. Density is masked where the w-clamp would
    fabricate ~1e5-scale spikes from w <= 0 wing cells (negative density
    from g < 0 is a REAL arbitrage signal — kept).
    """
    from iv_engine.surface.localvol import local_vol_surface
    lv = local_vol_surface(res)
    lv["local_vol"] = jnp.where(lv["local_vol_valid"], lv["local_vol"],
                                jnp.nan)
    lv["density"] = jnp.where(res["w_grid"] > 0.0, lv["density"], jnp.nan)
    return {**res, **lv}


def slicewise_model(name: str, description: str) -> SurfaceModel:
    return SurfaceModel(name=name, fit_eval=slicewise_fit_eval(name),
                        attach_local_vol=slicewise_local_vol,
                        description=description)
