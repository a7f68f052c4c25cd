"""Compensated (double-f32) cubic-spline surface fit+eval.

Closes the last north-star gap (BASELINE.md: <=1e-8 deviation from the
SciPy x64 oracle *on the deliverable device path*). Plain f32 cannot get
there even in principle: the correctly-rounded f32 of a total variance
w ~ 1.6 is already half an ulp = 6e-8 away from the true value, and the
fast matrix path measures 4.7e-8 — essentially AT the f32 floor. So the
parity-mode deliverable is a df64 *pair* ``(w_hi, w_lo)`` (see
``ops.df64``): ``hi`` alone is the best-possible f32 surface, and
``float64(hi) + float64(lo)`` reproduces the x64 oracle to ~1e-12.

Architecture — why this is cheap enough to stay >=100x the 10k/s target:

  * The O(n log n) tridiagonal solve stays in plain f32 (PCR, wide
    element-wise ops). One **residual-refinement step** then restores full df64
    accuracy: ``r = b - A @ M0`` is computed in df64 (O(n) elementwise,
    3 products per row), the correction ``dM = solve_f32(A, r)`` only
    needs f32 relative accuracy because ``r`` itself is ~1e-7 small,
    and ``M = M0 (+) dM`` is an error-free two_sum. Spline systems are
    diagonally dominant, so one step contracts the error from ~eps to
    ~eps^2 * kappa — measured ~1e-12 (tests/test_spline_compensated.py).
  * The system right-hand side and the local cubic evaluation are short
    O(n)/O(m) chains of df64 element-wise ops — no dense df64 matmuls anywhere.
  * Query positions are df64 too: the x64 oracle evaluates at *exact*
    f64 linspace points, and an f32 grid position alone carries up to
    6e-8 * |dw/dk| of irreducible error.

Parity: matches scipy.interpolate.CubicSpline (natural / not-a-knot)
to <=1e-9 reconstructed in f64, on clean and adversarial smiles
(tests/test_spline_compensated.py); on-chip telemetry in bench.py
(stage ``spline_parity``).

Reference analogue: none — the reference ran numpy f64 on CPU
(src/interpolation/core.py) and never faced an f32 hardware floor.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from iv_engine.ops import df64 as df
from iv_engine.ops.cubic_spline import _bracket
from iv_engine.ops.df64 import two_prod, two_sum
from iv_engine.ops.tridiag import tridiag_solve_pcr

_SIXTH = df.const(1.0 / 6.0)
_THIRD = df.const(1.0 / 3.0)


def _shift_up(a):
    """a[i-1] along axis 0, zero-filled (for the sub-diagonal product)."""
    return jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]], axis=0)


def _shift_dn(a):
    return jnp.concatenate([a[1:], jnp.zeros_like(a[:1])], axis=0)


def _tridiag_solve_refined(dl, d, du, b):
    """Solve A x = b with df64 coefficient/rhs pairs (system-major).

    f32 PCR solve + one df64 residual-refinement step. Returns x as a
    df64 pair. dl[0] / du[n-1] must be true zeros (PCR contract).
    """
    x0 = tridiag_solve_pcr(dl[0], d[0], du[0], b[0])
    ax = df.add(df.add(df.mul_f(dl, _shift_up(x0)), df.mul_f(d, x0)),
                df.mul_f(du, _shift_dn(x0)))
    r = df.sub(b, ax)
    dx = tridiag_solve_pcr(dl[0], d[0], du[0], r[0] + r[1])
    return two_sum(x0, dx)


def _df_concat(parts, axis=-1):
    return df.tmap(lambda *xs: jnp.concatenate(xs, axis=axis), *parts)


@partial(jax.jit, static_argnames=("bc_type",))
def fit_cubic_spline_df(x: jax.Array, y, bc_type: str = "natural"):
    """Knot second derivatives M (df64 pair) for cubic splines.

    Args:
      x: strictly increasing f32 knots, (..., n) — exact inputs.
      y: df64 pair of (..., n) knot values.
      bc_type: 'natural' or 'not-a-knot' (the two surface-path BCs).

    Returns:
      (M_hi, M_lo) df64 pair, shape (..., n).
    """
    y_hi, y_lo = y
    x, y_hi, y_lo = jnp.broadcast_arrays(x, y_hi, y_lo)
    y = (y_hi, y_lo)
    n = x.shape[-1]
    if n < 2:
        raise ValueError("need at least 2 knots")
    if n == 2:
        return df.from_f32(jnp.zeros_like(y_hi))

    h = df.diff_exact(x)                                   # (..., n-1)
    dy = df.sub(df.tmap(lambda a: a[..., 1:], y),
                df.tmap(lambda a: a[..., :-1], y))
    s = df.div(dy, h)                                      # slopes

    to_sys = partial(df.tmap, lambda a: jnp.moveaxis(a, -1, 0))
    zeros1 = df.from_f32(jnp.zeros_like(h[0][..., :1]))
    take = lambda v, sl: df.tmap(lambda a: a[..., sl], v)

    if bc_type == "natural":
        dl = _df_concat([zeros1, df.mul(take(h, np.s_[:-1]), _SIXTH), zeros1])
        d = _df_concat([df.from_f32(jnp.ones_like(h[0][..., :1])),
                        df.mul(df.add(take(h, np.s_[:-1]), take(h, np.s_[1:])),
                               _THIRD),
                        df.from_f32(jnp.ones_like(h[0][..., :1]))])
        du = _df_concat([zeros1, df.mul(take(h, np.s_[1:]), _SIXTH), zeros1])
        b = _df_concat([zeros1,
                        df.sub(take(s, np.s_[1:]), take(s, np.s_[:-1])),
                        zeros1])
        M = _tridiag_solve_refined(to_sys(dl), to_sys(d), to_sys(du),
                                   to_sys(b))
        return df.tmap(lambda a: jnp.moveaxis(a, 0, -1), M)

    if bc_type == "not-a-knot":
        if n == 3:
            # interpolating parabola: constant curvature (SciPy semantics)
            num = df.mul_f(df.sub(take(s, np.s_[1:2]), take(s, np.s_[0:1])),
                           jnp.asarray(2.0, x.dtype))
            M1 = df.div(num, df.add(take(h, np.s_[0:1]), take(h, np.s_[1:2])))
            return _df_concat([M1, M1, M1])
        h0, h1 = take(h, np.s_[0:1]), take(h, np.s_[1:2])
        hm1, hm2 = take(h, np.s_[-1:]), take(h, np.s_[-2:-1])
        dl_c = df.mul(take(h, np.s_[:-1]), _SIXTH)
        d_c = df.mul(df.add(take(h, np.s_[:-1]), take(h, np.s_[1:])), _THIRD)
        du_c = df.mul(take(h, np.s_[1:]), _SIXTH)
        b_c = df.sub(take(s, np.s_[1:]), take(s, np.s_[:-1]))
        # substitute M0 / M[n-1] via third-derivative continuity (same
        # elimination as ops.cubic_spline, in df64)
        d1 = df.add(take(d_c, np.s_[0:1]),
                    df.mul(take(dl_c, np.s_[0:1]),
                           df.div(df.add(h0, h1), h1)))
        du1 = df.sub(take(du_c, np.s_[0:1]),
                     df.mul(take(dl_c, np.s_[0:1]), df.div(h0, h1)))
        dn = df.add(take(d_c, np.s_[-1:]),
                    df.mul(take(du_c, np.s_[-1:]),
                           df.div(df.add(hm1, hm2), hm2)))
        dln = df.sub(take(dl_c, np.s_[-1:]),
                     df.mul(take(du_c, np.s_[-1:]), df.div(hm1, hm2)))
        z1 = df.from_f32(jnp.zeros_like(d1[0]))
        dl_i = _df_concat([z1, take(dl_c, np.s_[1:-1]), dln])
        d_i = _df_concat([d1, take(d_c, np.s_[1:-1]), dn])
        du_i = _df_concat([du1, take(du_c, np.s_[1:-1]), z1])
        M_int = _tridiag_solve_refined(to_sys(dl_i), to_sys(d_i),
                                       to_sys(du_i), to_sys(b_c))
        M_int = df.tmap(lambda a: jnp.moveaxis(a, 0, -1), M_int)
        Mi = lambda sl: df.tmap(lambda a: a[..., sl], M_int)
        M0 = df.div(df.sub(df.mul(df.add(h0, h1), Mi(np.s_[0:1])),
                           df.mul(h0, Mi(np.s_[1:2]))), h1)
        Mn = df.div(df.sub(df.mul(df.add(hm1, hm2), Mi(np.s_[-1:])),
                           df.mul(hm1, Mi(np.s_[-2:-1]))), hm2)
        return _df_concat([M0, M_int, Mn])

    raise ValueError(f"unsupported bc_type for compensated path: {bc_type!r}")


def _select_onehot(oh, a):
    """Exact one-hot row selection: sum over n of a masked broadcast.

    Replaces ``take_along_axis``: measured IN CONTEXT (fused into the
    surface eval at B=8192x30x50) each gather was ~7,600x slower
    than the equivalent one-hot compare+mask+reduce on the accelerator
    the code was first written for: the gather lowering serialized,
    while the one-hot is plain compare/select/add that fuses with its
    consumers.
    Exact by construction: one nonzero term per output element, so the
    reduction order cannot round (safe for df64 lo limbs).
    """
    return jnp.sum(jnp.where(oh, a[..., None, :], 0.0), axis=-1)


@partial(jax.jit, static_argnames=("with_derivs",))
def eval_cubic_spline_df(x: jax.Array, y, M, t, with_derivs: bool = False):
    """Evaluate fitted splines at df64 query positions.

    Args:
      x: f32 knots (..., n) — exact.
      y, M: df64 pairs (..., n).
      t: df64 pair of query positions (..., m). The *positions* carry a
        low limb because the oracle grid is exact-f64 linspace — an f32
        position alone contributes up to ulp/2 * |dw/dk| of error.
      with_derivs: also return plain-f32 S'(t), S''(t) computed from the
        hi limbs on the already-selected operands (the arbitrage
        diagnostics only need f32 + ulp-scaled tolerances; fusing them
        here avoids a second bracket+select pass).

    Returns:
      df64 pair S(t), (..., m) — or (S_pair, S', S'') if with_derivs.
    """
    y_hi, y_lo = y
    M_hi, M_lo = M
    x, y_hi, y_lo, M_hi, M_lo = jnp.broadcast_arrays(x, y_hi, y_lo,
                                                     M_hi, M_lo)
    t_hi, t_lo = t
    idx = _bracket(x, t_hi)
    n = x.shape[-1]
    iota = jnp.arange(n, dtype=idx.dtype)
    oh0 = idx[..., :, None] == iota            # interval left knot
    oh1 = idx[..., :, None] == (iota - 1)      # right knot (idx + 1)
    x0, x1 = _select_onehot(oh0, x), _select_onehot(oh1, x)
    y0 = (_select_onehot(oh0, y_hi), _select_onehot(oh0, y_lo))
    y1 = (_select_onehot(oh1, y_hi), _select_onehot(oh1, y_lo))
    M0 = (_select_onehot(oh0, M_hi), _select_onehot(oh0, M_lo))
    M1 = (_select_onehot(oh1, M_hi), _select_onehot(oh1, M_lo))

    hh = two_sum(x1, -x0)                       # exact knot spacing
    a = df.div(df.sub(df.from_f32(x1), (t_hi, t_lo)), hh)
    b = df.div(df.sub((t_hi, t_lo), df.from_f32(x0)), hh)
    a3 = df.mul(df.mul(a, a), a)
    b3 = df.mul(df.mul(b, b), b)
    h2_6 = df.mul(df.mul(hh, hh), _SIXTH)
    cubic = df.mul(df.add(df.mul(df.sub(a3, a), M0),
                          df.mul(df.sub(b3, b), M1)), h2_6)
    lin = df.add(df.mul(a, y0), df.mul(b, y1))
    s = df.add(lin, cubic)
    if not with_derivs:
        return s
    # f32 derivatives on the hi limbs — identical formulas to
    # ops.cubic_spline.eval_cubic_spline_deriv/_second_deriv
    ah, bh, hhh = a[0], b[0], hh[0]
    w1 = ((y1[0] - y0[0]) / hhh
          + ((-3.0 * ah * ah + 1.0) * M0[0]
             + (3.0 * bh * bh - 1.0) * M1[0]) * hhh / 6.0)
    w2 = ((x1 - t_hi) * M0[0] + (t_hi - x0) * M1[0]) / hhh
    return s, w1, w2


def queries_df(lo: float, hi: float, m: int):
    """Host-side exact-f64 linspace split into a df64 pair — THE grid
    constructor for parity-mode consumers (matches the oracle's
    np.linspace to the last f64 bit)."""
    q = np.linspace(float(lo), float(hi), m)
    return df.const(q)


def common_support_grid_df(k: jax.Array, n_grid: int):
    """df64 common-support grid: like surface.common_support_grid but
    the grid positions represent the *exact real-arithmetic* linspace
    between the f32 support endpoints."""
    k_lo = jnp.max(k[..., 0], axis=-1)
    k_hi = jnp.min(k[..., -1], axis=-1)
    lo = jnp.minimum(k_lo, k_hi)[..., None]
    hi = jnp.maximum(k_lo, k_hi)[..., None]
    steps = df.const(np.linspace(0.0, 1.0, n_grid))
    span = two_sum(hi, -lo)                      # exact f32 difference
    g = df.add_f(df.mul(span, steps), lo)
    expand = lambda a: jnp.broadcast_to(a[..., None, :],
                                        k.shape[:-1] + (n_grid,))
    return df.tmap(expand, g)


@partial(jax.jit, static_argnames=("n_grid", "bc_type"))
def fit_eval_surface_compensated(k: jax.Array, iv: jax.Array,
                                 expiries: jax.Array, n_grid: int = 50,
                                 bc_type: str = "not-a-knot",
                                 queries=None):
    """Parity-mode surface fit+eval: same contract as the fast paths
    (spline_matrix.fit_eval_surface_grid / surface.fit_eval_surface
    grid subset) plus the df64 low limb.

    Args:
      k: (B, E, n) or (E, n) f32 log-moneyness knots.
      iv: (B, E, n) f32 implied vols — exact inputs by definition.
      expiries: (E,) or (B, E) f32.
      queries: optional df64 pair of query positions ((m,) / (E, m) /
        (B, E, m)); defaults to the df64 common-support grid.

    Returns dict: k_grid/w_grid/iv_grid/g/butterfly_ok/calendar_ok as
    the fast path, PLUS ``w_grid_lo`` — ``f64(w_grid) + f64(w_grid_lo)``
    reproduces the SciPy x64 oracle to ~1e-12, which is how the <=1e-8
    north star is met (an f32 value alone bottoms out at ulp/2 ~ 6e-8).
    """
    if expiries.ndim == 1:
        T = expiries[None, :, None]
    else:
        T = expiries[..., None]
    # w = iv^2 * T in df64: both products are error-free transformations
    w = df.mul_f(two_prod(iv, iv), T)
    M = fit_cubic_spline_df(k, w, bc_type=bc_type)

    if queries is None:
        queries = common_support_grid_df(k, n_grid)
    q_hi, q_lo = queries
    tgt = jnp.broadcast_shapes(k.shape[:-1] + (q_hi.shape[-1],),
                               q_hi.shape, w[0].shape[:-1] + (q_hi.shape[-1],))
    q = (jnp.broadcast_to(q_hi, tgt), jnp.broadcast_to(q_lo, tgt))

    # diagnostics ride the hi limbs (f32 + 1024-ulp scaled tolerances,
    # same policy as spline_matrix._grid_diagnostics — df64 derivatives
    # would buy nothing); fused into the eval's one-hot selection pass
    from iv_engine.surface.arbitrage import butterfly_g
    w_grid, w1, w2 = eval_cubic_spline_df(k, w, M, q, with_derivs=True)
    g = butterfly_g(q[0], w_grid[0], w1, w2)
    iv_grid = jnp.sqrt(jnp.maximum(w_grid[0], 0.0) / jnp.maximum(T, 1e-12))
    eps = jnp.finfo(w_grid[0].dtype).eps
    butterfly_ok = jnp.all(g >= -jnp.maximum(1024.0 * eps, 1e-10),
                           axis=(-2, -1))
    calendar_ok = jnp.all(
        w_grid[0][..., 1:, :] >= w_grid[0][..., :-1, :]
        - jnp.maximum(1024.0 * eps, 1e-12), axis=(-2, -1))
    return {
        "k_grid": q[0],
        "w_grid": w_grid[0],
        "w_grid_lo": w_grid[1],
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": butterfly_ok,
        "calendar_ok": calendar_ok,
    }
