"""Batched cubic-spline smile fitting and evaluation.

The reference only ever linearly interpolated IV in *time*
(src/interpolation/core.py:58-61); the north star generalises this to
smile fitting in *strike* (BASELINE.md). A cubic-spline fit is a
tridiagonal solve for the knot second-derivatives, batched over thousands
of smiles: parallel cyclic reduction (log-depth) over the knot dimension
with the smile batch wide and vectorised. For fixed knot grids prefer
``ops.spline_matrix`` (the whole fit+eval as one matmul).

Boundary conditions:
  * ``natural``     S''(x0)=S''(xn)=0                (SciPy ``bc_type='natural'``)
  * ``clamped``     S'(x0)=fp0, S'(xn)=fpn           (SciPy ``bc_type='clamped'``)
  * ``not-a-knot``  S''' continuous at x1, x[n-2]    (SciPy default)

Parity: matches ``scipy.interpolate.CubicSpline`` to <=1e-8 in float64
(tests/test_cubic_spline.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from iv_engine.ops.tridiag import tridiag_solve_pcr as tridiag_solve
# PCR (log-depth, wide element-wise levels) instead of the sequential scan:
# on this runtime each scan step costs ~1ms of dispatch, so the 2n-step
# Thomas sweep is ~16x slower end-to-end than ceil(log2 n) PCR levels.
# Both solvers share the same contract and 1e-10 parity (tests/test_tridiag).


@partial(jax.jit, static_argnames=("bc_type",))
def fit_cubic_spline(x: jax.Array, y: jax.Array, bc_type: str = "natural",
                     fp0=None, fpn=None) -> jax.Array:
    """Compute knot second derivatives M for cubic splines.

    Args:
      x: strictly increasing knots, shape ``(..., n)`` (batch dims leading).
      y: knot values, shape ``(..., n)``, broadcastable with ``x``.
      bc_type: 'natural', 'clamped' or 'not-a-knot'.
      fp0, fpn: end-slopes for 'clamped' (broadcastable to batch shape).

    Returns:
      M: second derivatives at the knots, shape ``(..., n)``.
    """
    x, y = jnp.broadcast_arrays(x, y)
    n = x.shape[-1]
    if n < 2:
        raise ValueError("need at least 2 knots")
    if n == 2 and bc_type != "clamped":
        # Degenerate: a straight line (SciPy behaviour for n=2 natural/
        # not-a-knot). Clamped n=2 must NOT short-circuit: SciPy fits
        # the cubic Hermite honoring fp0/fpn, and the general clamped
        # system below degenerates to exactly its 2x2 equations —
        # returning zeros here discarded both end slopes (round-4
        # review, which also removed a dead 'n==3 not-a-knot' clause
        # that guarded nothing).
        return jnp.zeros_like(y)

    h = jnp.diff(x, axis=-1)                      # (..., n-1)
    s = jnp.diff(y, axis=-1) / h                  # slopes (..., n-1)

    # system-major layout for the scan-based solver
    to_sys = lambda a: jnp.moveaxis(a, -1, 0)

    if bc_type == "natural":
        dl = jnp.concatenate([jnp.zeros_like(h[..., :1]), h[..., :-1] / 6.0,
                              jnp.zeros_like(h[..., :1])], axis=-1)
        d = jnp.concatenate([jnp.ones_like(h[..., :1]),
                             (h[..., :-1] + h[..., 1:]) / 3.0,
                             jnp.ones_like(h[..., :1])], axis=-1)
        du = jnp.concatenate([jnp.zeros_like(h[..., :1]), h[..., 1:] / 6.0,
                              jnp.zeros_like(h[..., :1])], axis=-1)
        b = jnp.concatenate([jnp.zeros_like(h[..., :1]), s[..., 1:] - s[..., :-1],
                             jnp.zeros_like(h[..., :1])], axis=-1)
        M = tridiag_solve(to_sys(dl), to_sys(d), to_sys(du), to_sys(b))
        return jnp.moveaxis(M, 0, -1)

    if bc_type == "clamped":
        if fp0 is None or fpn is None:
            raise ValueError("clamped bc requires fp0 and fpn")
        fp0 = jnp.broadcast_to(jnp.asarray(fp0, x.dtype), x.shape[:-1])
        fpn = jnp.broadcast_to(jnp.asarray(fpn, x.dtype), x.shape[:-1])
        dl = jnp.concatenate([jnp.zeros_like(h[..., :1]), h[..., :-1] / 6.0,
                              h[..., -1:] / 6.0], axis=-1)
        d = jnp.concatenate([h[..., :1] / 3.0,
                             (h[..., :-1] + h[..., 1:]) / 3.0,
                             h[..., -1:] / 3.0], axis=-1)
        du = jnp.concatenate([h[..., :1] / 6.0, h[..., 1:] / 6.0,
                              jnp.zeros_like(h[..., :1])], axis=-1)
        b = jnp.concatenate([s[..., :1] - fp0[..., None],
                             s[..., 1:] - s[..., :-1],
                             fpn[..., None] - s[..., -1:]], axis=-1)
        M = tridiag_solve(to_sys(dl), to_sys(d), to_sys(du), to_sys(b))
        return jnp.moveaxis(M, 0, -1)

    if bc_type == "not-a-knot":
        if n == 3:
            # Single parabola through 3 points: constant second derivative.
            M1 = 2.0 * (s[..., 1:2] - s[..., 0:1]) / (h[..., 0:1] + h[..., 1:2])
            return jnp.concatenate([M1, M1, M1], axis=-1)
        # Eliminate M0 and M[n-1] using third-derivative continuity:
        #   M0 = ((h0+h1) M1 - h0 M2) / h1
        #   M[n-1] = ((h[n-2]+h[n-3]) M[n-2] - h[n-2] M[n-3]) / h[n-3]
        # leaving an (n-2) tridiagonal system in M1..M[n-2].
        h0, h1 = h[..., 0:1], h[..., 1:2]
        hm1, hm2 = h[..., -1:], h[..., -2:-1]
        # interior rows i = 1..n-2:  h[i-1]/6 M[i-1] + (h[i-1]+h[i])/3 M[i]
        #                            + h[i]/6 M[i+1] = s[i]-s[i-1]
        dl = h[..., :-1] / 6.0                    # coef of M[i-1], i=1..n-2
        d = (h[..., :-1] + h[..., 1:]) / 3.0      # coef of M[i]
        du = h[..., 1:] / 6.0                     # coef of M[i+1]
        b = s[..., 1:] - s[..., :-1]
        # Row for i=1 references M0 -> substitute:
        d1 = d[..., 0:1] + dl[..., 0:1] * (h0 + h1) / h1
        du1 = du[..., 0:1] - dl[..., 0:1] * h0 / h1
        # Row for i=n-2 references M[n-1] -> substitute:
        dn = d[..., -1:] + du[..., -1:] * (hm1 + hm2) / hm2
        dln = dl[..., -1:] - du[..., -1:] * hm1 / hm2
        dl_i = jnp.concatenate([jnp.zeros_like(d1), dl[..., 1:-1], dln], axis=-1)
        d_i = jnp.concatenate([d1, d[..., 1:-1], dn], axis=-1)
        du_i = jnp.concatenate([du1, du[..., 1:-1], jnp.zeros_like(dn)], axis=-1)
        M_int = tridiag_solve(to_sys(dl_i), to_sys(d_i), to_sys(du_i), to_sys(b))
        M_int = jnp.moveaxis(M_int, 0, -1)        # (..., n-2) = M1..M[n-2]
        M0 = ((h0 + h1) * M_int[..., 0:1] - h0 * M_int[..., 1:2]) / h1
        Mn = ((hm1 + hm2) * M_int[..., -1:] - hm1 * M_int[..., -2:-1]) / hm2
        return jnp.concatenate([M0, M_int, Mn], axis=-1)

    raise ValueError(f"unknown bc_type: {bc_type!r}")


def _bracket(x: jax.Array, t: jax.Array) -> jax.Array:
    """Index of the knot interval containing each query point.

    Broadcasting comparison instead of ``searchsorted`` — for smile-sized
    knot counts the dense ``(..., m, n)`` boolean compare maps cleanly onto
    the vector units and avoids gather-heavy binary search.
    """
    n = x.shape[-1]
    # count of interior knots <= t, clipped to a valid interval index
    ge = (t[..., :, None] >= x[..., None, 1:-1]).sum(axis=-1)
    return jnp.clip(ge, 0, n - 2)


@jax.jit
def eval_cubic_spline(x: jax.Array, y: jax.Array, M: jax.Array,
                      t: jax.Array) -> jax.Array:
    """Evaluate fitted splines at query points ``t``.

    Args:
      x, y, M: knots / values / second derivatives, shape ``(..., n)``.
      t: query points, shape ``(..., m)`` with the same batch dims.

    Returns:
      S(t), shape ``(..., m)``. Points outside [x0, xn] are extrapolated
      with the boundary cubic (SciPy ``extrapolate=True`` semantics).
    """
    x, y, M = jnp.broadcast_arrays(x, y, M)
    idx = _bracket(x, t)
    take = lambda a, i: jnp.take_along_axis(a, i, axis=-1)
    x0 = take(x, idx)
    x1 = take(x, idx + 1)
    y0 = take(y, idx)
    y1 = take(y, idx + 1)
    M0 = take(M, idx)
    M1 = take(M, idx + 1)
    hh = x1 - x0
    a = (x1 - t) / hh
    b = (t - x0) / hh
    return (
        a * y0
        + b * y1
        + ((a ** 3 - a) * M0 + (b ** 3 - b) * M1) * (hh ** 2) / 6.0
    )


@jax.jit
def eval_cubic_spline_deriv(x, y, M, t):
    """First derivative S'(t) of the fitted spline (for Greeks / no-arb
    checks in strike space)."""
    x, y, M = jnp.broadcast_arrays(x, y, M)
    idx = _bracket(x, t)
    take = lambda a, i: jnp.take_along_axis(a, i, axis=-1)
    x0, x1 = take(x, idx), take(x, idx + 1)
    y0, y1 = take(y, idx), take(y, idx + 1)
    M0, M1 = take(M, idx), take(M, idx + 1)
    hh = x1 - x0
    a = (x1 - t) / hh
    b = (t - x0) / hh
    return (
        (y1 - y0) / hh
        + ((-3 * a ** 2 + 1) * M0 + (3 * b ** 2 - 1) * M1) * hh / 6.0
    )


@jax.jit
def eval_cubic_spline_second_deriv(x, y, M, t):
    """Second derivative S''(t) — linear between knot curvatures; used by
    butterfly-arbitrage convexity checks."""
    x, M = jnp.broadcast_arrays(x, M)
    idx = _bracket(x, t)
    take = lambda a, i: jnp.take_along_axis(a, i, axis=-1)
    x0, x1 = take(x, idx), take(x, idx + 1)
    M0, M1 = take(M, idx), take(M, idx + 1)
    hh = x1 - x0
    return ((x1 - t) * M0 + (t - x0) * M1) / hh


def fit_eval_smile(x, y, t, bc_type: str = "natural"):
    """Fused fit+eval for a batch of smiles — the benchmark hot path."""
    M = fit_cubic_spline(x, y, bc_type=bc_type)
    return eval_cubic_spline(x, y, M, t)
