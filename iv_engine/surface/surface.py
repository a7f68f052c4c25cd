"""Full vol-surface fit/eval: smiles in strike x total-variance
interpolation in maturity.

The flagship compute path (BASELINE.json config #2: "Full surface: 30
expiries x 50 strikes, total-variance interpolation + dense grid eval").
Generalises the reference's 1-D linear time-interpolation
(src/interpolation/core.py:58-61) to the standard market-surface
construction:

  1. per expiry, fit the smile in log-moneyness as total variance
     w(k) = iv^2 * T  (cubic spline by default, SVI optional);
  2. evaluate each smile on a dense common k-grid;
  3. interpolate *linearly in total variance across maturity* at fixed k
     — the construction that preserves calendar no-arbitrage whenever the
     input slices are calendar-ordered;
  4. report butterfly/calendar diagnostics on the evaluated grid
     (``surface.arbitrage``).

Everything is batched over surfaces (leading dim B) and jit-compiled;
the benchmark target is 10k surfaces/sec fit+eval on one device.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from iv_engine.ops.cubic_spline import (
    eval_cubic_spline,
    eval_cubic_spline_deriv,
    eval_cubic_spline_second_deriv,
    fit_cubic_spline,
)
from iv_engine.ops.svi import (fit_svi_batched, svi_g,
                                           svi_total_variance, vega_weights)
from iv_engine.surface.arbitrage import butterfly_g, butterfly_g_fd


@partial(jax.tree_util.register_dataclass,
         data_fields=["k", "expiries", "w", "coefs"],
         meta_fields=["method"])
@dataclasses.dataclass(frozen=True)
class SurfaceFit:
    """Fitted surface state (device-resident, batched over B).

    ``method`` is pytree metadata (static under jit); array fields:
      k: (B, E, n) log-moneyness knots
      expiries: (B, E) maturities (years, ascending)
      w: (B, E, n) total variance at knots
      coefs: spline -> (B, E, n) second derivatives; svi -> (B, E, 5)
    """

    method: str
    k: jax.Array
    expiries: jax.Array
    w: jax.Array
    coefs: jax.Array


def _fit_slices(k, w, expiries, method: str, svi_iters: int = 64,
                svi_butterfly_penalty: float = 0.0,
                svi_weighting: str = "uniform",
                smoothing_lam: float = 0.0,
                svi_unroll: bool = False,
                spline_bc: str = "natural",
                svi_loss: str = "linear",
                svi_huber_delta: float = 1e-3):
    """Returns (knot values used by eval, coefficients). For
    'smoothing_spline' the knot values are the *smoothed* fit, not the
    observations."""
    if method == "cubic_spline":
        # 'not-a-knot' avoids the natural-BC edge artifact (fitted w''
        # forced to 0 at the end knots) that produces spurious negative
        # butterfly-g at the first/last grid columns — see
        # ops.spline_matrix._curvature_operator.
        return w, fit_cubic_spline(k, w, bc_type=spline_bc)
    if method == "smoothing_spline":
        from iv_engine.ops.smoothing_spline import (
            fit_smoothing_spline)
        fit = fit_smoothing_spline(k, w, smoothing_lam)
        return fit.g, fit.M
    if method == "svi":
        weights = vega_weights(k, w) if svi_weighting == "vega" else None
        # unroll: a looped LM is latency-bound (~1 ms/step) on this
        # runtime; unrolling is ~30x faster at production batches
        return w, fit_svi_batched(
            k, w, weights=weights, max_iters=svi_iters,
            butterfly_penalty=svi_butterfly_penalty,
            unroll=svi_unroll, loss=svi_loss,
            huber_delta=svi_huber_delta).params
    if method == "essvi":
        from iv_engine.ops.essvi import fit_essvi_batched
        weights = vega_weights(k, w) if svi_weighting == "vega" else None
        # one joint 3E-param LM per surface: theta increasing and
        # per-slice butterfly-free by construction (ops.essvi)
        return w, fit_essvi_batched(
            k, w, weights=weights, max_iters=svi_iters,
            unroll=svi_unroll, loss=svi_loss,
            huber_delta=svi_huber_delta).params
    if method == "sabr":
        from iv_engine.ops.sabr import fit_sabr_batched
        # strikes on the forward-normalised axis: K = e^k, F = 1
        T = expiries[..., None]
        iv = jnp.sqrt(jnp.maximum(w, 1e-12) / jnp.maximum(T, 1e-12))
        fit = fit_sabr_batched(jnp.exp(k), iv,
                               jnp.ones_like(expiries), expiries,
                               max_iters=svi_iters)
        return w, fit.params
    raise ValueError(f"unknown smile method: {method!r}")


@partial(jax.jit, static_argnames=("method", "svi_iters",
                                   "svi_butterfly_penalty",
                                   "svi_weighting", "smoothing_lam",
                                   "svi_unroll", "spline_bc",
                                   "svi_loss", "svi_huber_delta"))
def fit_surface(k: jax.Array, iv: jax.Array, expiries: jax.Array,
                method: str = "cubic_spline", svi_iters: int = 64,
                svi_butterfly_penalty: float = 0.0,
                svi_weighting: str = "uniform",
                smoothing_lam: float = 0.0,
                svi_unroll: bool = False,
                spline_bc: str = "natural",
                svi_loss: str = "linear",
                svi_huber_delta: float = 1e-3) -> SurfaceFit:
    """Fit a batch of vol surfaces.

    Args:
      k: (B, E, n) log-moneyness of quotes per expiry (ascending in n).
      iv: (B, E, n) implied vols.
      expiries: (B, E) maturities in years (ascending in E).
      method: smile parameterisation ('cubic_spline' | 'smoothing_spline'
        | 'svi' | 'essvi' | 'sabr'). 'essvi' fits one joint surface per
        batch element (increasing ATM variance + butterfly-free slices
        by construction — see ``ops.essvi``).
      spline_bc: boundary condition for 'cubic_spline' ('natural' |
        'not-a-knot' | 'clamped'); 'not-a-knot' recommended when the
        butterfly diagnostics matter.
    """
    w = iv * iv * expiries[..., None]
    w_fit, coefs = _fit_slices(k, w, expiries, method, svi_iters,
                               svi_butterfly_penalty, svi_weighting,
                               smoothing_lam, svi_unroll, spline_bc,
                               svi_loss, svi_huber_delta)
    return SurfaceFit(method=method, k=k, expiries=expiries, w=w_fit,
                      coefs=coefs)


_SPLINE_METHODS = ("cubic_spline", "smoothing_spline")


def common_support_grid(k: jax.Array, n_grid: int) -> jax.Array:
    """Dense eval grid on the common strike support across expiries:
    k (..., E, n) -> (..., E, n_grid) spanning [max k[...,0], min k[...,-1]].

    THE grid construction for every evaluated-surface consumer
    (fit_eval_surface, the streaming operator refit, benchmarks) — keep
    them on this single helper so precomputed operators stay on exactly
    the grid the general path evaluates.
    """
    k_lo = jnp.max(k[..., 0], axis=-1)
    k_hi = jnp.min(k[..., -1], axis=-1)
    # guard: when the strike supports do not overlap, k_hi < k_lo and a
    # naive linspace would be DESCENDING — which breaks every downstream
    # consumer that assumes an ascending grid (searchsorted bracket
    # search, finite-difference butterfly g, trapezoid integrals). Fall
    # back to the ascending gap interval [k_hi, k_lo] between the
    # supports: every choice extrapolates some slice in this degenerate
    # case, and the gap is the closest interval to all of them.
    lo = jnp.minimum(k_lo, k_hi)
    hi = jnp.maximum(k_lo, k_hi)
    steps = jnp.linspace(0.0, 1.0, n_grid).astype(k.dtype)
    span = (hi - lo)[..., None] * steps + lo[..., None]
    return jnp.broadcast_to(span[..., None, :], k.shape[:-1] + (n_grid,))


def _eval_slices(fit: SurfaceFit, k_grid: jax.Array) -> jax.Array:
    """Evaluate every fitted slice at (B, E, m) query log-moneyness."""
    if fit.method in _SPLINE_METHODS:
        return eval_cubic_spline(fit.k, fit.w, fit.coefs, k_grid)
    if fit.method == "sabr":
        from iv_engine.ops.sabr import sabr_vol
        iv = sabr_vol(fit.coefs, jnp.ones_like(fit.expiries),
                      jnp.exp(k_grid), fit.expiries)
        return iv * iv * fit.expiries[..., None]
    if fit.method == "essvi":
        from iv_engine.ops.essvi import essvi_w
        return essvi_w(fit.coefs, k_grid)
    return svi_total_variance(fit.coefs, k_grid)


def _slice_g(fit: SurfaceFit, k_grid: jax.Array, w_grid: jax.Array) -> jax.Array:
    """Butterfly g on the evaluated slices, closed-form where available."""
    if fit.method in _SPLINE_METHODS:
        w1 = eval_cubic_spline_deriv(fit.k, fit.w, fit.coefs, k_grid)
        w2 = eval_cubic_spline_second_deriv(fit.k, fit.w, fit.coefs, k_grid)
        return butterfly_g(k_grid, w_grid, w1, w2)
    if fit.method == "svi":
        return svi_g(fit.coefs, k_grid)
    if fit.method == "essvi":
        from iv_engine.ops.essvi import essvi_g
        return essvi_g(fit.coefs, k_grid)
    return butterfly_g_fd(k_grid, w_grid)


@jax.jit
def eval_surface(fit: SurfaceFit, k_q: jax.Array, T_q: jax.Array) -> jax.Array:
    """Evaluate total variance at arbitrary (k, T) query points.

    Args:
      fit: fitted surface (batch B).
      k_q: (B, Q) query log-moneyness.
      T_q: (B, Q) query maturities.

    Returns:
      (B, Q) total variance: linear in total variance between bracketing
      slices at fixed k; clamped to the first/last slice outside the
      expiry range (flat extrapolation in w avoids manufacturing calendar
      arbitrage).
    """
    E = fit.expiries.shape[-1]
    if E > 2:
        ge = (T_q[..., :, None] >= fit.expiries[..., None, 1:-1]).sum(axis=-1)
        lo = jnp.clip(ge, 0, E - 2)
    else:
        lo = jnp.zeros(T_q.shape, jnp.int32)
    T0 = jnp.take_along_axis(fit.expiries, lo, axis=-1)
    T1 = jnp.take_along_axis(fit.expiries, lo + 1, axis=-1)

    def eval_at(slice_idx):
        # gather the bracketing slice's knots per query: (B, Q, n)
        idx = slice_idx[..., :, None]
        k_s = jnp.take_along_axis(fit.k, idx, axis=-2)
        w_s = jnp.take_along_axis(fit.w, idx, axis=-2)
        c_s = jnp.take_along_axis(fit.coefs, idx, axis=-2)
        if fit.method in _SPLINE_METHODS:
            return eval_cubic_spline(k_s, w_s, c_s, k_q[..., :, None])[..., 0]
        if fit.method == "sabr":
            from iv_engine.ops.sabr import sabr_vol
            T_s = jnp.take_along_axis(fit.expiries, slice_idx, axis=-1)
            iv = sabr_vol(c_s, jnp.ones_like(T_s), jnp.exp(k_q[..., :, None]),
                          T_s)[..., 0]
            return iv * iv * T_s
        if fit.method == "essvi":
            from iv_engine.ops.essvi import essvi_w
            return essvi_w(c_s, k_q[..., :, None])[..., 0]
        return svi_total_variance(c_s, k_q[..., :, None])[..., 0]

    w0 = eval_at(lo)
    w1 = eval_at(lo + 1)
    t = jnp.clip((T_q - T0) / jnp.maximum(T1 - T0, 1e-12), 0.0, 1.0)
    return w0 * (1.0 - t) + w1 * t


@partial(jax.jit, static_argnames=("method", "n_grid", "svi_iters",
                                   "svi_butterfly_penalty",
                                   "svi_weighting", "smoothing_lam",
                                   "svi_unroll", "spline_bc",
                                   "svi_loss", "svi_huber_delta"))
def fit_eval_surface(k: jax.Array, iv: jax.Array, expiries: jax.Array,
                     method: str = "cubic_spline", n_grid: int = 50,
                     svi_iters: int = 64,
                     svi_butterfly_penalty: float = 0.0,
                     svi_weighting: str = "uniform",
                     smoothing_lam: float = 0.0,
                     svi_unroll: bool = False,
                     spline_bc: str = "natural",
                     svi_loss: str = "linear",
                     svi_huber_delta: float = 1e-3,
                     quote_mask: jax.Array | None = None):
    """Fused fit + dense-grid eval + arbitrage diagnostics — the benchmark
    hot path (fit + evaluate on the 30x50 grid).

    Returns dict with ``fit``, the evaluated ``k_grid``/``w_grid``/
    ``iv_grid`` (B, E, n_grid), the butterfly function ``g`` on the grid,
    per-surface ``butterfly_ok`` / ``calendar_ok`` flags, and
    ``fit_rmse`` (B,) — total-variance RMSE of the fitted smiles at the
    input quotes (identically ~0 for interpolating splines; the serving
    quality gate for svi/essvi/sabr/smoothing fits). ``quote_mask``
    (B, E, n) bool restricts fit_rmse to REAL quotes when the inputs
    carry padding (fabricated strikes / duplicated expiry slices would
    otherwise dominate the statistic).
    """
    fit = fit_surface(k, iv, expiries, method=method, svi_iters=svi_iters,
                      svi_butterfly_penalty=svi_butterfly_penalty,
                      svi_weighting=svi_weighting,
                      smoothing_lam=smoothing_lam, svi_unroll=svi_unroll,
                      spline_bc=spline_bc, svi_loss=svi_loss,
                      svi_huber_delta=svi_huber_delta)
    k_grid = common_support_grid(k, n_grid)
    w_grid = _eval_slices(fit, k_grid)
    g = _slice_g(fit, k_grid, w_grid)
    iv_grid = jnp.sqrt(jnp.maximum(w_grid, 0.0)
                       / jnp.maximum(fit.expiries[..., None], 1e-12))
    # 1024-ulp dtype-scaled flag tolerances, floored at the old x64
    # constants (same policy as spline_matrix._grid_diagnostics and the
    # AH flags): fixed tolerances sit below f32 evaluation noise
    eps = jnp.finfo(w_grid.dtype).eps
    butterfly_ok = jnp.all(g >= -jnp.maximum(1024.0 * eps, 1e-10),
                           axis=(-2, -1))
    calendar_ok = jnp.all(
        w_grid[..., 1:, :] >= w_grid[..., :-1, :]
        - jnp.maximum(1024.0 * eps, 1e-12), axis=(-2, -1)
    )
    # fit quality at the quotes (exactly 0 for interpolating splines)
    w_obs = iv * iv * expiries[..., None]
    w_at_knots = _eval_slices(fit, k)
    err2 = (w_at_knots - w_obs) ** 2
    if quote_mask is not None:
        m_ = quote_mask.astype(err2.dtype)
        fit_rmse = jnp.sqrt(
            jnp.sum(err2 * m_, axis=(-2, -1))
            / jnp.maximum(jnp.sum(m_, axis=(-2, -1)), 1.0))
    else:
        fit_rmse = jnp.sqrt(jnp.mean(err2, axis=(-2, -1)))
    return {
        "fit": fit,
        "k_grid": k_grid,
        "w_grid": w_grid,
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": butterfly_ok,
        "calendar_ok": calendar_ok,
        "fit_rmse": fit_rmse,
    }
