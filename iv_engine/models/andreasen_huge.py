"""Andreasen-Huge one-step surface model: arbitrage-free BY
CONSTRUCTION (martingale-kernel implicit Dupire steps in strike space,
ops.andreasen_huge), on the method's own dense PDE grid
(``surface.ah_grid`` / ``ah_iters``).
"""

from __future__ import annotations

import jax.numpy as jnp

from iv_engine.models.base import SurfaceModel
from iv_engine.ops.andreasen_huge import (  # noqa: F401
    fit_eval_ah_surface,
)


def _ah_fit_eval(k, iv, T, quote_mask, scfg, dev=None):
    dev = dev or jnp.asarray
    return fit_eval_ah_surface(
        dev(k), dev(iv), dev(T),
        n_grid=scfg.ah_grid, n_iters=scfg.ah_iters,
        quote_mask=dev(quote_mask))


def _ah_local_vol(res: dict, T, scfg) -> dict:
    """AH's local vol is its own calibration product (exact, no Dupire
    extraction; already in the fused output). Its 'g' is the
    STRIKE-space density d2C/dK2; every other method persists the
    LOG-MONEYNESS Breeden-Litzenberger density, so convert measures
    (p(k) = K * d2C/dK2, K = e^k on the unit forward) before writing
    the shared 'density' column. The two boundary-condition columns
    carry no PDE row (g padded with 0 there) -> persist NaN, not a
    fabricated zero density (round-3 advisor finding)."""
    p_k = jnp.exp(res["k_grid"]) * res["g"]
    interior = jnp.zeros_like(p_k, bool).at[..., 1:-1].set(True)
    return {**res, "density": jnp.where(interior, p_k, jnp.nan)}


AH = SurfaceModel(
    name="ah",
    fit_eval=_ah_fit_eval,
    attach_local_vol=_ah_local_vol,
    description="Andreasen-Huge one-step surfaces (arb-free by "
                "construction; surface.ah_grid/ah_iters)")
