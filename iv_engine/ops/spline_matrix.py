"""Matrix-form cubic splines: fit+eval as one matmul.

For a *fixed knot grid* the natural-cubic-spline pipeline is a linear map
of the knot values: the tridiagonal system ``T M = C y`` gives curvatures
``M = G y`` with ``G = T^-1 C``, and evaluation at fixed queries ``t`` is

    S(t)   = E0 y,   S'(t) = E1 y,   S''(t) = E2 y

with (m, n) matrices E0/E1/E2 precomputed once per grid. A batch of
smiles sharing the grid then evaluates as a single
``(batch, n) @ (n, m)`` contraction — matrix-unit work instead of sequential
scans, which matters doubly on this runtime where every ``lax.scan`` step
costs ~1ms of dispatch overhead (measured; see bench.py notes).

This is the fast path behind the headline benchmark; scattered/per-smile
grids fall back to ``ops.cubic_spline`` (PCR/scan tridiagonal solve).
Parity: identical to ``scipy.interpolate.CubicSpline(bc_type='natural')``
at <=1e-8 in f64 (tests/test_spline_matrix.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SplineOperator(NamedTuple):
    """Precomputed eval operators for one knot/query grid."""

    knots: jax.Array    # (n,)
    queries: jax.Array  # (m,)
    E0: jax.Array       # (n, m) value operator (transposed for y @ E)
    E1: jax.Array       # (n, m) first-derivative operator
    E2: jax.Array       # (n, m) second-derivative operator
    # (n, 3m) = [E0 | E1 | E2], stacked ONCE at build time: the fused
    # fit+eval contraction reads this, and materialising the concat
    # inside the jitted per-tick refit instead re-wrote B*E*n*3m floats
    # of device memory every call (ops is a traced argument, so XLA cannot
    # constant-fold it away)
    EC: jax.Array


def _curvature_operator(x: jax.Array, bc_type: str = "natural") -> jax.Array:
    """G (n, n) with M = G y for the cubic spline on knots x.

    ``natural`` pins M=0 at the end knots — cheap, but it flattens the
    fitted w'' at the grid edges, which shows up as spurious negative
    butterfly-g at the first/last eval columns on smiles whose true
    curvature is positive there (measured: 63% of clean quadratic smiles
    flagged). ``not-a-knot`` (SciPy's default; third derivative
    continuous at x1/x[n-2]) tracks smooth smiles exactly and keeps the
    diagnostics edge-artifact-free.
    """
    n = x.shape[0]
    h = jnp.diff(x)
    T = jnp.zeros((n, n), x.dtype)
    i = jnp.arange(1, n - 1)
    T = T.at[i, i - 1].set(h[:-1] / 6.0)
    T = T.at[i, i].set((h[:-1] + h[1:]) / 3.0)
    T = T.at[i, i + 1].set(h[1:] / 6.0)
    if bc_type == "natural":
        # rows 0, n-1: identity -> M = 0
        T = T.at[0, 0].set(1.0).at[n - 1, n - 1].set(1.0)
    elif bc_type == "not-a-knot" and n >= 4:
        # S''' continuous at x1: (M1-M0)/h0 = (M2-M1)/h1, rhs 0
        T = T.at[0, 0].set(1.0 / h[0])
        T = T.at[0, 1].set(-1.0 / h[0] - 1.0 / h[1])
        T = T.at[0, 2].set(1.0 / h[1])
        # S''' continuous at x[n-2]
        T = T.at[n - 1, n - 3].set(1.0 / h[n - 3])
        T = T.at[n - 1, n - 2].set(-1.0 / h[n - 3] - 1.0 / h[n - 2])
        T = T.at[n - 1, n - 1].set(1.0 / h[n - 2])
    elif bc_type == "not-a-knot" and n == 3:
        # both not-a-knot rows would reference the SAME interior knot —
        # the n>=4 construction is singular here and jnp.linalg.solve
        # returns NaN operators silently under jit. SciPy's n=3
        # not-a-knot is the interpolating PARABOLA (constant S''):
        # pin M0 = M1 and M2 = M1, and the interior row then yields
        # M = 2 (s1 - s0) / (h0 + h1), exactly the parabola's curvature.
        T = T.at[0, 0].set(1.0).at[0, 1].set(-1.0)
        T = T.at[2, 2].set(1.0).at[2, 1].set(-1.0)
    elif bc_type == "not-a-knot" and n == 2:
        # two knots: the spline degrades to the straight line (SciPy
        # raises here; a streaming chain with two strikes should fit
        # linearly rather than crash) — natural rows give exactly that
        T = T.at[0, 0].set(1.0).at[n - 1, n - 1].set(1.0)
    else:
        raise ValueError(f"unsupported bc_type for operator form: {bc_type!r}")
    # C: rhs operator, b = C y with b_i = s_i - s_{i-1} (end rows stay 0)
    C = jnp.zeros((n, n), x.dtype)
    C = C.at[i, i - 1].set(1.0 / h[:-1])
    C = C.at[i, i].set(-1.0 / h[:-1] - 1.0 / h[1:])
    C = C.at[i, i + 1].set(1.0 / h[1:])
    return jnp.linalg.solve(T, C)


@partial(jax.jit, static_argnames=("bc_type",))
def build_spline_operator(knots: jax.Array, queries: jax.Array,
                          bc_type: str = "natural") -> SplineOperator:
    """Precompute E0/E1/E2 for a (knots, queries) pair. O(n^3 + m n) —
    done once per grid, amortised over the whole batch."""
    x = knots
    t = queries
    n = x.shape[0]
    G = _curvature_operator(x, bc_type)

    idx = jnp.clip(
        (t[:, None] >= x[None, 1:-1]).sum(axis=-1), 0, n - 2)
    x0 = x[idx]
    x1 = x[idx + 1]
    hh = x1 - x0
    a = (x1 - t) / hh
    b = (t - x0) / hh

    eye = jnp.eye(n, dtype=x.dtype)
    P0 = eye[idx]          # (m, n) selects y_j
    P1 = eye[idx + 1]      # (m, n) selects y_{j+1}
    G0 = G[idx]            # (m, n) row M_j as function of y
    G1 = G[idx + 1]

    h2_6 = (hh * hh / 6.0)[:, None]
    E0 = (a[:, None] * P0 + b[:, None] * P1
          + ((a**3 - a)[:, None] * G0 + (b**3 - b)[:, None] * G1) * h2_6)
    E1 = ((P1 - P0) / hh[:, None]
          + ((-3 * a**2 + 1)[:, None] * G0
             + (3 * b**2 - 1)[:, None] * G1) * (hh / 6.0)[:, None])
    E2 = a[:, None] * G0 + b[:, None] * G1
    return SplineOperator(knots=x, queries=t, E0=E0.T, E1=E1.T, E2=E2.T,
                          EC=jnp.concatenate([E0.T, E1.T, E2.T], axis=-1))


@jax.jit
def apply_spline_operator(op: SplineOperator, y: jax.Array):
    """Evaluate (S, S', S'') for a batch of smiles: y (..., n) -> (..., m)
    — three contractions.

    Precision HIGHEST is required, not a nicety: at default precision a
    GPU may run f32 contractions in TF32 (10-bit mantissa), and E2
    entries scale like 1/h^2 (~±600 at n=50 on [-1,1]), so reduced-
    precision products corrupt S'' badly enough to flip the sign of
    butterfly-g on clean smiles (PERF.md "Precision").
    """
    f32 = partial(jnp.matmul, preferred_element_type=y.dtype,
                  precision=jax.lax.Precision.HIGHEST)
    return f32(y, op.E0), f32(y, op.E1), f32(y, op.E2)


def build_surface_operators(k_knots: jax.Array, queries: jax.Array,
                            bc_type: str = "natural"):
    """Per-expiry operators: k_knots (E, n), queries (m,) or (E, m) ->
    stacked (E, n, m) operator tensors. ``bc_type='not-a-knot'`` is
    recommended when the butterfly/calendar diagnostics matter (see
    :func:`_curvature_operator`)."""
    if queries.ndim == 1:
        queries = jnp.broadcast_to(queries, (k_knots.shape[0],
                                             queries.shape[0]))
    return jax.vmap(partial(build_spline_operator, bc_type=bc_type))(
        k_knots, queries)


def build_surface_operators_batched(k_knots: jax.Array, queries: jax.Array,
                                    bc_type: str = "natural"):
    """Per-underlying, per-expiry operators: k_knots (B, E, n), queries
    (m,) or (B, E, m) -> stacked (B, E, n, m) operator tensors.

    For fixed quote grids (a streaming session's chains) this is one-off
    setup — every subsequent refit is a single einsum against the stacked
    operator (:func:`fit_eval_surface_grid_batched`)."""
    B, E, _ = k_knots.shape
    if queries.ndim == 1:
        queries = jnp.broadcast_to(queries, (B, E, queries.shape[0]))
    build = partial(build_spline_operator, bc_type=bc_type)
    return jax.vmap(jax.vmap(build))(k_knots, queries)


def _grid_diagnostics(out, m, k_grid, T):
    """Shared tail of the fused fit+eval: split the stacked contraction
    output and compute the diagnostics dict (ONE home for the grid
    tolerances and the output contract)."""
    w_grid, w1, w2 = out[..., :m], out[..., m:2 * m], out[..., 2 * m:]
    from iv_engine.surface.arbitrage import butterfly_g
    # NB: this import is lazy to avoid a package-import cost at module
    # load, but it can run during tracing — safe only because arbitrage/
    # svi/sabr keep module-level constants as numpy (see ops/svi.py)
    g = butterfly_g(k_grid, w_grid, w1, w2)
    iv_grid = jnp.sqrt(jnp.maximum(w_grid, 0.0) / jnp.maximum(T, 1e-12))
    # 1024-ulp dtype-scaled flag tolerances (the same policy as
    # ops.andreasen_huge's arbitrage flags): the old fixed -1e-10/-1e-12
    # sat far below f32 spline-evaluation noise (the E2 rows scale
    # ~1/h^2, ~±600 at n=50 on [-1,1]), so genuinely clean surfaces
    # flagged arbitrageable from rounding alone (round-4 review).
    # Floored at the old constants so x64 behavior is unchanged.
    eps = jnp.finfo(w_grid.dtype).eps
    tol_g = jnp.maximum(1024.0 * eps, 1e-10)
    tol_w = jnp.maximum(1024.0 * eps, 1e-12)
    butterfly_ok = jnp.all(g >= -tol_g, axis=(-2, -1))
    calendar_ok = jnp.all(
        w_grid[..., 1:, :] >= w_grid[..., :-1, :] - tol_w, axis=(-2, -1))
    return {
        "k_grid": k_grid,
        "w_grid": w_grid,
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": butterfly_ok,
        "calendar_ok": calendar_ok,
    }


@jax.jit
def fit_eval_surface_grid(ops: SplineOperator, iv: jax.Array,
                          expiries: jax.Array):
    """Fast-path surface fit+eval on shared per-expiry grids.

    Args:
      ops: stacked SplineOperator with (E, n, m) tensors (from
        :func:`build_surface_operators`).
      iv: (B, E, n) implied vols.
      expiries: (E,) or (B, E).

    Returns the grid subset of
    :func:`iv_engine.surface.surface.fit_eval_surface`'s
    dict contract — k_grid/w_grid/iv_grid/g/butterfly_ok/calendar_ok;
    the ``fit`` and ``fit_rmse`` keys of the general path are NOT
    produced here (interpolating splines reprice exactly, and the
    operator form has no SurfaceFit object).

    Same calendar_ok contract as the batched variant: all expiries must
    share one query grid — per-expiry grids make the cross-expiry
    column comparison meaningless.
    """
    if expiries.ndim == 1:
        T = expiries[None, :, None]
    else:
        T = expiries[..., None]
    w = iv * iv * T                       # (B, E, n)
    # one contraction against the prebuilt stacked (n, 3m) operator
    # instead of three (n, m) ones: a single pass over w and a wider
    # output tile; numerically identical — the same dot products, just
    # batched.
    # precision HIGHEST: default precision may run TF32, which corrupts
    # the 1/h^2-scaled E2 columns enough to flip butterfly-g signs —
    # see apply_spline_operator
    out = jnp.einsum("ben,enq->beq", w, ops.EC,
                     preferred_element_type=w.dtype,
                     precision=jax.lax.Precision.HIGHEST)
    m = ops.E0.shape[-1]
    k_grid = jnp.broadcast_to(ops.queries[None],
                              w.shape[:-1] + (m,))
    return _grid_diagnostics(out, m, k_grid, T)


@jax.jit
def fit_eval_surface_grid_batched(ops: SplineOperator, iv: jax.Array,
                                  expiries: jax.Array):
    """Like :func:`fit_eval_surface_grid` but with per-underlying
    operators: ops tensors (B, E, n, m), iv (B, E, n), expiries (E,),
    (B, E). The streaming-refit hot path when every underlying has its
    own strike grid.

    Contract: all expiries of one underlying must share ONE query grid
    (``ops.queries[b, e] == ops.queries[b, e']``, e.g. the common-support
    grid from ``surface.common_support_grid``) — ``calendar_ok`` compares
    w across expiries at the same grid column, which is meaningless for
    per-expiry grids."""
    if expiries.ndim == 1:
        T = expiries[None, :, None]
    else:
        T = expiries[..., None]
    w = iv * iv * T                       # (B, E, n)
    # precision HIGHEST: see fit_eval_surface_grid
    out = jnp.einsum("ben,benq->beq", w, ops.EC,
                     preferred_element_type=w.dtype,
                     precision=jax.lax.Precision.HIGHEST)
    return _grid_diagnostics(out, ops.E0.shape[-1], ops.queries, T)
