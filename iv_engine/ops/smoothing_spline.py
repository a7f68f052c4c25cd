"""Penalized (smoothing) cubic splines for noisy smiles.

Real quote smiles carry bid/ask noise; an interpolating spline chases it
and manufactures butterfly arbitrage. The smoothing spline minimises

    sum_i (y_i - f(x_i))^2 + lam * int f''(t)^2 dt

whose minimiser (Green & Silverman / Reinsch) is a natural cubic spline
with interior curvatures gamma solving the banded system

    (R + lam * Q^T Q) gamma = Q^T y,      g = y - lam * Q gamma

with R tridiagonal and Q the second-difference operator. Batched here
with dense (n-2)^2 solves (n ~ 50 smiles: trivial matmul work; the banded
structure matters only for n in the thousands).

Parity oracle: ``scipy.interpolate.make_smoothing_spline`` with explicit
``lam`` (tests/test_smoothing_spline.py, <=1e-8 in f64). lam=0 recovers
the interpolating natural spline.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from iv_engine.ops.cubic_spline import (
    eval_cubic_spline,
    eval_cubic_spline_deriv,
    eval_cubic_spline_second_deriv,
)


class SmoothingFit(NamedTuple):
    x: jax.Array   # (..., n) knots
    g: jax.Array   # (..., n) fitted (smoothed) values
    M: jax.Array   # (..., n) second derivatives (natural BCs)


@jax.jit
def fit_smoothing_spline(x: jax.Array, y: jax.Array,
                         lam: jax.Array | float) -> SmoothingFit:
    """Fit smoothing splines over the trailing axis (batched).

    Args:
      x: (..., n) strictly increasing sites.
      y: (..., n) noisy observations.
      lam: smoothness weight (scalar or (...,) per-problem).
    """
    x, y = jnp.broadcast_arrays(x, y)
    n = x.shape[-1]
    if n < 3:
        raise ValueError("smoothing spline needs >= 3 points")
    lam = jnp.asarray(lam, x.dtype)[..., None, None]
    h = jnp.diff(x, axis=-1)                     # (..., n-1)

    batch = x.shape[:-1]
    m = n - 2
    i = jnp.arange(m)
    # R (m, m) tridiagonal
    R = jnp.zeros(batch + (m, m), x.dtype)
    R = R.at[..., i, i].set((h[..., :-1] + h[..., 1:]) / 3.0)
    R = R.at[..., i[:-1], i[:-1] + 1].set(h[..., 1:-1] / 6.0)
    R = R.at[..., i[:-1] + 1, i[:-1]].set(h[..., 1:-1] / 6.0)
    # Q (n, m): column j has entries at rows j, j+1, j+2
    Q = jnp.zeros(batch + (n, m), x.dtype)
    Q = Q.at[..., i, i].set(1.0 / h[..., :-1])
    Q = Q.at[..., i + 1, i].set(-1.0 / h[..., :-1] - 1.0 / h[..., 1:])
    Q = Q.at[..., i + 2, i].set(1.0 / h[..., 1:])

    # HIGHEST: Q entries scale like 1/h — default precision may run
    # these f32 contractions in TF32 on GPU tensor cores, whose ~3
    # decimal digits corrupt them (see spline_matrix)
    hp = jax.lax.Precision.HIGHEST
    QtQ = jnp.einsum("...nm,...nk->...mk", Q, Q, precision=hp)
    Qty = jnp.einsum("...nm,...n->...m", Q, y, precision=hp)
    gamma = jnp.linalg.solve(R + lam * QtQ, Qty[..., None])[..., 0]
    g = y - lam[..., 0, 0, None] * jnp.einsum("...nm,...m->...n", Q, gamma,
                                              precision=hp)
    M = jnp.concatenate([
        jnp.zeros(batch + (1,), x.dtype), gamma,
        jnp.zeros(batch + (1,), x.dtype)], axis=-1)
    return SmoothingFit(x=x, g=g, M=M)


@jax.jit
def eval_smoothing_spline(fit: SmoothingFit, t: jax.Array) -> jax.Array:
    """Evaluate the fitted smoothing spline at (..., q) query points."""
    return eval_cubic_spline(fit.x, fit.g, fit.M, t)


@jax.jit
def eval_smoothing_spline_derivs(fit: SmoothingFit, t: jax.Array):
    """(S, S', S'') at query points — feeds butterfly-g diagnostics."""
    return (eval_cubic_spline(fit.x, fit.g, fit.M, t),
            eval_cubic_spline_deriv(fit.x, fit.g, fit.M, t),
            eval_cubic_spline_second_deriv(fit.x, fit.g, fit.M, t))


@jax.jit
def fit_eval_smoothed_smile(k: jax.Array, w: jax.Array, lam, t: jax.Array):
    """Fused smoothing fit + eval for a batch of (noisy) smiles."""
    fit = fit_smoothing_spline(k, w, lam)
    return eval_smoothing_spline(fit, t)


@partial(jax.jit, static_argnames=("n_eval",))
def fit_smoothing_spline_autolam(k: jax.Array, w: jax.Array,
                                 lams: jax.Array,
                                 n_eval: int = 64) -> SmoothingFit:
    """Arbitrage-aware smoothing: fit every candidate lam (batched), check
    butterfly g on a dense grid, and keep — per slice — the SMALLEST lam
    whose fit is butterfly-free (falling back to the largest candidate).

    The practical projection onto the no-arb set: minimal smoothing that
    removes the violation, so clean slices keep lam ~ lams[0].

    Args:
      k, w: (..., n) slices.
      lams: (L,) ascending candidate penalties (e.g. logspace).
    """
    from iv_engine.surface.arbitrage import butterfly_g

    def fit_one_lam(lam):
        fit = fit_smoothing_spline(k, w, lam)
        t = jnp.linspace(0.0, 1.0, n_eval, dtype=w.dtype)
        tq = k[..., 0:1] + (k[..., -1:] - k[..., 0:1]) * t
        S, S1, S2 = eval_smoothing_spline_derivs(fit, tq)
        g = butterfly_g(tq, S, S1, S2)
        ok = jnp.all(g >= -1e-10, axis=-1)      # (...,) per slice
        return fit, ok

    fits, oks = jax.vmap(fit_one_lam)(lams)      # leading L axis
    L = lams.shape[0]
    # index of the first ok lam; slices never ok use the last (smoothest)
    first_ok = jnp.argmax(oks, axis=0)
    any_ok = jnp.any(oks, axis=0)
    sel = jnp.where(any_ok, first_ok, L - 1)     # (...,)
    take = lambda a: jnp.take_along_axis(
        a, sel[None, ..., None], axis=0)[0]
    return SmoothingFit(x=take(fits.x), g=take(fits.g), M=take(fits.M))
