"""RBF/thin-plate scattered surface model (BASELINE.json config #4).

Unlike the slice-wise families, RBF fits the WHOLE (k, T) quote cloud
of each underlying as one scattered interpolation/smoothing problem —
so ``fit_eval`` owns its own packing: quotes flatten to (B, E*n, 2)
sites, the dense eval grid and the data sites share one eval pass, and
arbitrage handling is the penalty-smoothing solver (ops.rbf) when
``surface.rbf_butterfly_penalty`` / ``rbf_calendar_penalty`` > 0.
``surface.rbf_centers`` selects the reduced-center least-squares basis
(``scripts/rbf_frontier.py`` measures the accuracy/speed frontier vs
the exact every-site estimator).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from iv_engine.models.base import SurfaceModel

# public math surface
from iv_engine.ops.rbf import (  # noqa: F401
    eval_rbf,
    fit_eval_rbf_batched,
    fit_rbf,
)


def _rbf_fit_eval(k, iv, T, quote_mask, scfg, dev=None):
    """Scattered RBF surfaces over all (k, T) quotes — the whole shape
    bucket as one batched fit, evaluated on the same (E, grid) layout as
    the slice-wise methods so downstream handling is uniform.

    Padded quotes enter weight-0 in the penalized fit's data term; at
    zero penalties the plain interpolating/smoothing fit is used. Flags
    are the pipeline's post-hoc finite-difference diagnostics on the
    eval grid. Returns dict of (B, ...) arrays incl. a quote-masked
    ``fit_rmse``.
    """
    from iv_engine.ops.rbf import fit_eval_rbf_arbfree_batched
    from iv_engine.surface.arbitrage import butterfly_g_fd

    dev = dev or jnp.asarray  # mesh placement hook (run_surface_fit)

    B, E, n = k.shape
    m = scfg.grid_strikes
    pts = np.stack([k.reshape(B, E * n),
                    np.repeat(T, n, axis=-1)], axis=-1)      # (B, E n, 2)
    vals = (iv ** 2 * T[..., None]).reshape(B, E * n)
    lo = k[:, :, 0].max(axis=1)
    hi = k[:, :, -1].min(axis=1)
    kg_row = lo[:, None] + (hi - lo)[:, None] * np.linspace(0.0, 1.0, m)
    k_grid = np.broadcast_to(kg_row[:, None, :], (B, E, m))
    # grid queries first, the data sites after — one eval pass serves
    # both the surface grid and the fit_rmse statistic
    query = np.concatenate([
        np.stack([k_grid.reshape(B, E * m),
                  np.repeat(T, m, axis=-1)], axis=-1),
        pts,
    ], axis=1)

    penalized = (scfg.rbf_butterfly_penalty > 0.0
                 or scfg.rbf_calendar_penalty > 0.0)
    if penalized:
        w_eval, _, _ = fit_eval_rbf_arbfree_batched(
            dev(pts), dev(vals), dev(query),
            weights=dev(quote_mask.reshape(B, E * n).astype(vals.dtype)),
            smoothing=scfg.rbf_smoothing, kernel=scfg.rbf_kernel,
            butterfly_weight=scfg.rbf_butterfly_penalty,
            calendar_weight=scfg.rbf_calendar_penalty,
            n_iters=scfg.rbf_penalty_iters,
            n_centers=scfg.rbf_centers)
    else:
        w_eval = fit_eval_rbf_batched(
            dev(pts), dev(vals), dev(query),
            smoothing=scfg.rbf_smoothing, kernel=scfg.rbf_kernel)
    w_grid = w_eval[:, :E * m].reshape(B, E, m)
    w_data = w_eval[:, E * m:]
    qm = jnp.asarray(quote_mask.reshape(B, E * n))
    n_real = jnp.maximum(qm.sum(axis=-1), 1)
    fit_rmse = jnp.sqrt(
        jnp.sum(jnp.where(qm, (w_data - jnp.asarray(vals)) ** 2, 0.0),
                axis=-1) / n_real)
    k_grid = jnp.asarray(k_grid)
    g = butterfly_g_fd(k_grid, w_grid)
    iv_grid = jnp.sqrt(jnp.maximum(w_grid, 0.0)
                       / jnp.maximum(jnp.asarray(T)[..., None], 1e-12))
    return {
        "k_grid": k_grid,
        "w_grid": w_grid,
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": jnp.all(g >= -1e-10, axis=(1, 2)),
        "calendar_ok": jnp.all(
            w_grid[:, 1:] - w_grid[:, :-1] >= -1e-12, axis=(1, 2)),
        "fit_rmse": fit_rmse,
    }


def _rbf_local_vol(res: dict, T, scfg) -> dict:
    """Dupire extraction from the scattered fit: the same promise as the
    slice-wise methods (compute_local_vol is method-agnostic), with
    dw/dT by backward differences on the evaluated grid; cells without
    a real local vol persist NaN, like everywhere else."""
    from iv_engine.surface.localvol import (_backward_dwdT,
                                            risk_neutral_density)
    g = res["g"]
    dwdT = _backward_dwdT(res["w_grid"], jnp.asarray(T), 1e-10)
    lv = dwdT / jnp.maximum(g, 1e-10)
    valid = (g > 1e-10) & (dwdT >= 0.0)
    return {
        **res,
        "local_vol": jnp.where(valid, jnp.sqrt(jnp.maximum(lv, 0.0)),
                               jnp.nan),
        "density": jnp.where(
            res["w_grid"] > 0.0,
            risk_neutral_density(res["k_grid"], res["w_grid"], g),
            jnp.nan),
    }


RBF = SurfaceModel(
    name="rbf",
    fit_eval=_rbf_fit_eval,
    attach_local_vol=_rbf_local_vol,
    description="scattered RBF/thin-plate surfaces with no-arbitrage "
                "penalty smoothing (surface.rbf_*)")
