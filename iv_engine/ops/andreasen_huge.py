"""Andreasen-Huge one-step arbitrage-free surface interpolation.

The one construction in this framework whose output is arbitrage-free
*by construction*, not by penalty or post-hoc diagnosis: following
Andreasen & Huge, "Volatility interpolation" (Risk, 2011), each expiry
slice is ONE implicit finite-difference step of the Dupire forward PDE
in strike space,

    dC/dT = (sigma^2(K) K^2 / 2) d^2C/dK^2,

discretised as second divided differences on the non-uniform strike
grid K = e^x (x uniform in log-moneyness), with a piecewise-constant
(per quote cell) local volatility calibrated so the step reprices the
market quotes. The implicit step matrix (I - dt*A) is an M-matrix
whose inverse is a discrete martingale kernel (see ``_step_system``),
so each step preserves positivity, monotonicity and convexity of the
call-price curve, and stepping forward in maturity can only increase
prices — i.e. the discrete surface has no butterfly and no calendar
arbitrage at ANY grid point, including between quoted expiries
(interpolation in T is a partial step of the same operator).

Accelerator-native design:
  * the implicit step is a batched tridiagonal solve — parallel cyclic
    reduction (``ops.tridiag.tridiag_solve_pcr``: log-depth, pure
    element-wise levels, differentiable in both AD modes);
  * per-slice calibration is the shared Levenberg-Marquardt engine
    (``ops.lm``) with jacfwd tangents THROUGH the solve (the step is
    linear in the RHS, so forward sensitivities are one extra solve per
    parameter, batched);
  * maturities chain through ``lax.scan`` (the carry is the price
    curve), surfaces batch through ``vmap``.

No analogous reference component — the reference interpolates linearly
in time per symbol (src/interpolation/core.py:58-61) with no arbitrage
notion; this is part of the surface-method family the north star calls
for, alongside splines/SVI/eSSVI/SABR/RBF (BASELINE.json).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm

from iv_engine.ops.lm import levenberg_marquardt
from iv_engine.ops.tridiag import (tridiag_matvec,
                                   tridiag_solve_pcr)

_VOL_LO, _VOL_HI = 1e-3, 5.0


def normalized_call(k: jax.Array, w: jax.Array) -> jax.Array:
    """Black call price with unit forward and zero rates:
    c(k, w) = N(d1) - e^k N(d2), d1 = -k/sqrt(w) + sqrt(w)/2.
    ``w`` is total implied variance; the w -> 0 limit is intrinsic."""
    sw = jnp.sqrt(jnp.maximum(w, 1e-14))
    d1 = -k / sw + 0.5 * sw
    d2 = d1 - sw
    c = norm.cdf(d1) - jnp.exp(k) * norm.cdf(d2)
    intrinsic = jnp.maximum(1.0 - jnp.exp(k), 0.0)
    return jnp.where(w > 1e-14, c, intrinsic)


def _normalized_vega_w(k: jax.Array, w: jax.Array) -> jax.Array:
    """dc/dw (Black vega w.r.t. total variance, unit forward)."""
    sw = jnp.sqrt(jnp.maximum(w, 1e-14))
    d1 = -k / sw + 0.5 * sw
    return 0.5 * norm.pdf(d1) / sw


def _step_system(sig2: jax.Array, x: jax.Array, dt: jax.Array):
    """Tridiagonal (I - dt*A) rows for one implicit Dupire step.

    The operator is the STRIKE-SPACE Dupire forward generator
    A = (sigma^2 K^2 / 2) d^2/dK^2 as second divided differences on the
    non-uniform strike grid K = e^x (uniform in log-moneyness for
    resolution, exact in strike for the no-arbitrage argument). This
    form — pure second derivative, no drift — is what makes the step an
    M-matrix whose inverse is a discrete MARTINGALE kernel (rows are
    probability weights with mean K_i: A annihilates constants and the
    linear function K, even on a non-uniform grid), which is the
    Andreasen-Huge theorem's engine: convexity of C in K and calendar
    monotonicity survive every step exactly. The log-space form
    (sigma^2/2)(d_kk - d_k) was measured to leak ~1.7e-5 negative
    density through its drift discretisation and was rejected.

    Boundary rows pin the SLOPE in K — dC/dK = -1 at the deep-ITM edge,
    0 at the deep-OTM edge (linear wings). Call slopes live in [-1, 0],
    so the boundary-adjacent discrete density is non-negative by
    construction (a Dirichlet pin-at-intrinsic leaves a ~4e-5 concave
    kink one node in; also measured). Returns (dl, d, du), axis 0 =
    system dim.
    """
    K = jnp.exp(x)
    h_lo = jnp.diff(K, prepend=K[:1])            # K_i - K_{i-1} (h_lo[0] dummy)
    h_hi = jnp.diff(K, append=K[-1:])            # K_{i+1} - K_i (h_hi[-1] dummy)
    safe = lambda a: jnp.where(a == 0, 1.0, a)
    alpha = 0.5 * dt * sig2 * K * K              # (n,)
    dl = -alpha * 2.0 / (safe(h_lo) * safe(h_lo + h_hi))
    du = -alpha * 2.0 / (safe(h_hi) * safe(h_lo + h_hi))
    d = 1.0 + alpha * 2.0 / safe(h_lo * h_hi)
    one = jnp.ones((), x.dtype)
    neg = -one
    dl = dl.at[0].set(0.0).at[-1].set(neg)
    du = du.at[0].set(neg).at[-1].set(0.0)
    d = d.at[0].set(one).at[-1].set(one)
    return dl, d, du


def ah_step(c_prev: jax.Array, sig2: jax.Array, x: jax.Array,
            dt: jax.Array, refine: bool = False) -> jax.Array:
    """One implicit step of the Dupire forward PDE: solve
    (I - dt*A(sigma^2)) c = c_prev with linear-wing boundaries
    C_0 - C_1 = K_1 - K_0 (slope -1 in strike) and C_{n-1} = C_{n-2}
    (slope 0).

    refine: one sweep of iterative refinement (residual + correction
    solve). The f32 PCR solution carries ~6.5e-5 price error vs x64 on
    production-shaped systems — enough to wobble the c >= c_prev
    monotonicity the construction guarantees in exact arithmetic. Off
    inside LM residuals (Jacobian accuracy is irrelevant there), on for
    the final per-slice curves and eval-time interpolation steps."""
    dl, d, du = _step_system(sig2, x, dt)
    dK0 = jnp.exp(x[1]) - jnp.exp(x[0])
    rhs = c_prev.at[0].set(dK0).at[-1].set(0.0)
    # custom_linear_solve gives the IMPLICIT-FUNCTION derivative rules:
    # a jvp solves A dx = db - dA x with the SAME operator instead of
    # differentiating through every PCR level, so the per-slice LM's
    # jacfwd (m tangents through this solve) costs m same-matrix solves
    # rather than m re-linearised PCR passes
    # transpose bands: (A^T)[i, i-1] = du[i-1], (A^T)[i, i+1] = dl[i+1]
    dl_t = jnp.concatenate([jnp.zeros_like(du[:1]), du[:-1]], axis=0)
    du_t = jnp.concatenate([dl[1:], jnp.zeros_like(dl[:1])], axis=0)
    c = jax.lax.custom_linear_solve(
        lambda v: tridiag_matvec(dl, d, du, v), rhs,
        solve=lambda _, b: tridiag_solve_pcr(dl, d, du, b),
        transpose_solve=lambda _, b: tridiag_solve_pcr(dl_t, d, du_t, b))
    if refine:
        r = rhs - tridiag_matvec(dl, d, du, c)
        c = c + tridiag_solve_pcr(dl, d, du, r)
    return c


def _cells_to_grid(theta: jax.Array, k_q: jax.Array,
                   x: jax.Array) -> jax.Array:
    """Piecewise-constant vol^2 on the grid: one cell per quote, cell
    boundaries at midpoints between adjacent quote strikes."""
    mids = 0.5 * (k_q[1:] + k_q[:-1])
    idx = jnp.sum(x[:, None] > mids[None, :], axis=1)
    return theta[idx] ** 2


def _interp_grid(c: jax.Array, x: jax.Array, k_q: jax.Array) -> jax.Array:
    """Linear interpolation of grid values at quote strikes."""
    h = x[1] - x[0]
    pos = (k_q - x[0]) / h
    i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, x.shape[0] - 2)
    frac = jnp.clip(pos - i0.astype(pos.dtype), 0.0, 1.0)
    return c[i0] * (1.0 - frac) + c[i0 + 1] * frac


def _interp_price(c: jax.Array, x: jax.Array, k_q: jax.Array) -> jax.Array:
    """Price interpolation via the TIME VALUE: intrinsic 1 - e^k is
    concave in k, so interpolating c directly undershoots it by O(h^2)
    on the ITM wing — orders of magnitude above the true wing time
    value. Interpolate c - intrinsic (smooth, >= 0) and add intrinsic
    back exactly at the query."""
    tv = jnp.maximum(c - jnp.maximum(1.0 - jnp.exp(x), 0.0), 0.0)
    return (_interp_grid(tv, x, k_q)
            + jnp.maximum(1.0 - jnp.exp(k_q), 0.0))


def _slice_residual(theta, c_prev, k_q, c_mkt, wgt, x, dt):
    sig2 = _cells_to_grid(theta, k_q, x)
    c = ah_step(c_prev, sig2, x, dt)
    return (_interp_price(c, x, k_q) - c_mkt) * wgt


@partial(jax.tree_util.register_dataclass,
         data_fields=["x", "expiries", "c", "theta", "k_q", "fit_rmse"],
         meta_fields=[])
@dataclasses.dataclass(frozen=True)
class AHFit:
    """Fitted Andreasen-Huge surface (device-resident, batched over B).

    x: (B, n) uniform log-moneyness grid per surface.
    expiries: (B, E) maturities (years, ascending).
    c: (B, E, n) normalized call prices after each calibrated step —
       convex and decreasing in k, nondecreasing in E by construction.
    theta: (B, E, m) calibrated piecewise-constant vols (one per quote).
    k_q: (B, E, m) the quote strikes theta's cells are anchored to
       (needed to rebuild the step operator at eval time).
    fit_rmse: (B,) price-space RMSE at the quotes (vega-weighted
       residuals are the objective; this is the raw price error).
    """

    x: jax.Array
    expiries: jax.Array
    c: jax.Array
    theta: jax.Array
    k_q: jax.Array
    fit_rmse: jax.Array


def _fit_one(k_q, iv, expiries, x, quote_wgt, *, n_iters: int,
             lm_unroll: bool = False):
    """Single-surface AH calibration: scan over expiries, LM per slice.

    k_q: (E, m) quote log-moneyness (ascending in m); iv: (E, m);
    expiries: (E,); x: (n,) uniform grid; quote_wgt: (E, m).
    """
    live = (quote_wgt > 0).astype(iv.dtype)
    # masked quotes may carry ANYTHING (NaN/garbage iv): sanitize their
    # market variance to the slice's unmasked mean so every downstream
    # use (prices, vega weights, forward-variance init via the PREVIOUS
    # slice's w) stays finite — a NaN times the zero weight is still NaN
    w_raw = iv * iv * expiries[:, None]
    w_fill = (jnp.sum(jnp.where(live > 0, w_raw, 0.0), -1, keepdims=True)
              / jnp.maximum(jnp.sum(live, -1, keepdims=True), 1.0))
    w_mkt = jnp.where(live > 0, w_raw, w_fill)
    c_mkt = normalized_call(k_q, w_mkt)
    # equalize implied-variance (not price) error across strikes: weight
    # each price residual by 1/(dc/dw), floored to keep far wings from
    # dominating; zero-weight rows (padding) are inert in the LM
    vega = _normalized_vega_w(k_q, w_mkt)
    wgt = jnp.where(live > 0, quote_wgt / jnp.maximum(vega, 1e-3), 0.0)
    # forward-variance init: theta0^2 ~ (w_j - w_{j-1}) / dt
    w_prev = jnp.concatenate([jnp.zeros_like(w_mkt[:1]), w_mkt[:-1]], 0)
    dts = jnp.diff(expiries, prepend=jnp.zeros((1,), expiries.dtype))
    theta0 = jnp.sqrt(jnp.maximum(w_mkt - w_prev, 1e-6)
                      / jnp.maximum(dts[:, None], 1e-12))
    theta0 = jnp.clip(theta0, _VOL_LO, _VOL_HI)
    # masked cells' init must not start at a garbage-driven extreme (LM
    # recovers slowly from a 5.0-vol start): use each slice's unmasked
    # mean for masked cells.
    mean0 = (jnp.sum(theta0 * live, axis=-1, keepdims=True)
             / jnp.maximum(jnp.sum(live, axis=-1, keepdims=True), 1.0))
    theta0 = jnp.where(live > 0, theta0, mean0)

    c0 = jnp.maximum(1.0 - jnp.exp(x), 0.0)

    def step(c_prev, inp):
        kq_j, cm_j, wg_j, dt_j, th0_j = inp
        res = levenberg_marquardt(
            _slice_residual, th0_j, c_prev, kq_j, cm_j, wg_j, x, dt_j,
            max_iters=n_iters, lower=_VOL_LO, upper=_VOL_HI,
            unroll=lm_unroll)
        sig2 = _cells_to_grid(res.params, kq_j, x)
        c_j = ah_step(c_prev, sig2, x, dt_j, refine=True)
        err = _interp_price(c_j, x, kq_j) - cm_j
        return c_j, (res.params, c_j, err)

    _, (theta, c, err) = jax.lax.scan(
        step, c0, (k_q, c_mkt, wgt, dts, theta0))
    mask = (quote_wgt > 0).astype(err.dtype)
    rmse = jnp.sqrt(jnp.sum(err * err * mask)
                    / jnp.maximum(jnp.sum(mask), 1.0))
    return theta, c, rmse


@partial(jax.jit, static_argnames=("n_grid", "n_iters", "lm_unroll"))
def fit_ah(k: jax.Array, iv: jax.Array, expiries: jax.Array,
           n_grid: int = 257, n_iters: int = 16,
           grid_pad: float = 1.0,
           quote_mask: jax.Array | None = None,
           lm_unroll: bool = False) -> AHFit:
    """Calibrate Andreasen-Huge one-step surfaces (batched).

    Args:
      k: (B, E, m) quote log-moneyness, ascending in m.
      iv: (B, E, m) implied vols at the quotes.
      expiries: (B, E) maturities in years, ascending.
      n_grid: dense-grid resolution (uniform in k).
      n_iters: LM iterations per slice.
      lm_unroll: unroll the per-slice LM loop (n_iters copies of the
        body in the expiry scan). The loop runs INSIDE one jit, so
        unrolling only trades compile time for possible XLA fusion
        across iterations. At B=64 E=8 grid 257 iters 16 the loop
        compiles 2.8x faster on CPU (11.8 s vs 33 s) with BITWISE-
        identical fitted curves. Default is therefore False; set True
        only if a profile shows the fusion winning on your shape.
      grid_pad: MINIMUM grid extension beyond the quote range on each
        side. The effective pad scales with the surface's own scale,
        max(grid_pad, 3 sqrt(w_max) + w_max/2): the linear-wing
        boundary rows need N(d2) ~ 1 at the ITM edge, and d2 there is
        pad/sqrt(w) - sqrt(w)/2 — a FIXED pad put the boundary where a
        high-vol long-dated call (iv=2, T=5y -> w=20) is nowhere near
        linear, and the distorted interior could not reprice (0.12
        price rmse; round-3 review). The 3-sigma constant reproduces
        the measured-good default (pad 1.0 at w~0.1) exactly. Very
        high vol*sqrt(T) also warrants a larger ``n_grid``: the span
        grows as ~7 sqrt(w), so h = span/n_grid must stay below the
        quote-cell spacing for the piecewise vols to be resolvable.
      quote_mask: (B, E, m) bool — False rows get zero residual weight.

    Returns an :class:`AHFit`; the fitted ``c`` curves are free of
    butterfly and calendar arbitrage at every grid point by
    construction (monotone implicit scheme).
    """
    B, E, m = k.shape
    wgt = (jnp.ones_like(k) if quote_mask is None
           else quote_mask.astype(k.dtype))
    # grid bounds come from UNMASKED strikes only: a sentinel strike in
    # a masked slot (k=-999) must not stretch the grid until all real
    # quotes collapse into a handful of cells. Masked strikes do still
    # anchor vol-cell boundaries (_cells_to_grid), so they must be
    # FINITE; keep padding strikes within a few units of the real ones.
    w_q = iv * iv * expiries[..., None]
    w_max = jnp.max(jnp.where(wgt > 0, w_q, 0.0), axis=(1, 2))
    pad = jnp.maximum(jnp.asarray(grid_pad, k.dtype),
                      3.0 * jnp.sqrt(w_max) + 0.5 * w_max)
    lo = jnp.min(jnp.where(wgt > 0, k, jnp.inf), axis=(1, 2)) - pad
    hi = jnp.max(jnp.where(wgt > 0, k, -jnp.inf), axis=(1, 2)) + pad
    steps = jnp.linspace(0.0, 1.0, n_grid).astype(k.dtype)
    x = lo[:, None] + (hi - lo)[:, None] * steps[None, :]
    theta, c, rmse = jax.vmap(
        partial(_fit_one, n_iters=int(n_iters),
                lm_unroll=bool(lm_unroll)))(
        k, iv, expiries, x, wgt)
    return AHFit(x=x, expiries=expiries, c=c, theta=theta, k_q=k,
                 fit_rmse=rmse)


@jax.jit
def ah_local_vol(fit: AHFit) -> jax.Array:
    """The calibrated model's OWN local volatility on the dense grid:
    (B, E, n) sigma_loc, piecewise-constant per quote cell within each
    maturity interval. The one-step model is a local-vol model by
    definition, so unlike ``surface.localvol``'s Dupire extraction from
    an implied grid (finite differences + clamping), this is exact —
    theta is the object the calibration solves for."""
    sig2 = jax.vmap(jax.vmap(_cells_to_grid, in_axes=(0, 0, None)))(
        fit.theta, fit.k_q, fit.x)
    return jnp.sqrt(sig2)


def _bracket_lo(expiries: jax.Array, T_q: jax.Array) -> jax.Array:
    """Index of the slice at-or-below each query maturity: -1 when the
    query sits before the first expiry (step from the T=0 intrinsic)."""
    return jnp.sum(T_q[..., :, None] >= expiries[..., None, :],
                   axis=-1).astype(jnp.int32) - 1


@jax.jit
def eval_ah(fit: AHFit, k_q: jax.Array, T_q: jax.Array) -> jax.Array:
    """Total variance at arbitrary (k, T) — arbitrage-free interpolation.

    For T between slices j and j+1, prices come from a PARTIAL implicit
    step of slice j+1's calibrated operator applied to slice j's curve
    (dt = T - T_j) — the Andreasen-Huge interpolation rule, which keeps
    the in-between surface arbitrage-free (same monotone operator).
    Beyond the last expiry the last slice's operator extrapolates.

    Cost note: each query POINT builds and solves one full n-point
    tridiagonal system, so Q strikes sharing one maturity cost Q
    identical steps. For dense per-expiry grids use
    ``fit_eval_ah_surface`` (one step per slice); this entry point is
    for scattered (k, T) queries.

    Args:
      fit: batched AHFit.
      k_q, T_q: (B, Q) query log-moneyness / maturities.

    Returns (B, Q) total implied variance (Black-inverted from prices).
    """

    def one(x, expiries, c_all, theta_all, kq_slice, k_pts, T_pts):
        E = c_all.shape[0]
        lo = _bracket_lo(expiries, T_pts)              # (Q,) in [-1, E-1]
        c0 = jnp.maximum(1.0 - jnp.exp(x), 0.0)
        c_base = jnp.where(
            (lo >= 0)[:, None],
            c_all[jnp.clip(lo, 0, E - 1)], c0[None, :])  # (Q, n)
        T_base = jnp.where(lo >= 0, expiries[jnp.clip(lo, 0, E - 1)], 0.0)
        op_idx = jnp.clip(lo + 1, 0, E - 1)            # operator slice
        theta_op = theta_all[op_idx]                   # (Q, m)
        kq_op = kq_slice[op_idx]                       # (Q, m)
        dt = jnp.maximum(T_pts - T_base, 0.0)          # (Q,)

        def step_one(cb, th, kq, dt_q):
            sig2 = _cells_to_grid(th, kq, x)
            return ah_step(cb, sig2, x, dt_q, refine=True)

        c_at = jax.vmap(step_one)(c_base, theta_op, kq_op, dt)  # (Q, n)
        c_pts = jax.vmap(_interp_price, in_axes=(0, None, 0))(
            c_at, x, k_pts[:, None])[:, 0]
        return _invert_w(c_pts, k_pts,
                         w_hi=_VOL_HI * _VOL_HI * jnp.maximum(T_pts, 1.0))

    return jax.vmap(one)(fit.x, fit.expiries, fit.c, fit.theta,
                         fit.k_q, k_q, T_q)


def _invert_w(c: jax.Array, k: jax.Array, max_iters: int = 64,
              w_hi=16.0) -> jax.Array:
    """Black-invert normalized call prices to total variance via
    safeguarded bisection+Newton on w (monotone: dc/dw > 0).

    ``w_hi`` is the bracket's upper edge and MUST cover the surface's
    maximum total variance — callers scale it as _VOL_HI^2 * T (a fixed
    16.0 silently capped long-dated high-vol surfaces: iv=2 at T=5y is
    w=20, inside the model's own vol box)."""
    lo = jnp.full_like(c, 1e-10)
    hi = jnp.broadcast_to(jnp.asarray(w_hi, c.dtype), c.shape)
    w = jnp.full_like(c, 0.04)

    def body(_, state):
        w, lo, hi = state
        p = normalized_call(k, w)
        too_high = p > c
        lo = jnp.where(too_high, lo, w)
        hi = jnp.where(too_high, w, hi)
        dcdw = _normalized_vega_w(k, w)
        newton = w - (p - c) / jnp.maximum(dcdw, 1e-14)
        ok = (newton > lo) & (newton < hi) & jnp.isfinite(newton)
        w = jnp.where(ok, newton, 0.5 * (lo + hi))
        return w, lo, hi

    w, _, _ = jax.lax.fori_loop(0, max_iters, body, (w, lo, hi))
    # prices at/below intrinsic carry no variance information; the
    # cutoff scales with the dtype's solve-noise floor (same 1024-ulp
    # policy as the arbitrage flags) — a fixed 1e-14 let f32 PCR noise
    # (~4e-5 of notional) masquerade as deep-ITM wing variance
    intrinsic = jnp.maximum(1.0 - jnp.exp(k), 0.0)
    tol = 1024.0 * jnp.finfo(c.dtype).eps
    return jnp.where(c > intrinsic + tol, w, 0.0)


def _price_space_density(c: jax.Array, x: jax.Array) -> jax.Array:
    """Discrete risk-neutral density d^2C/dK^2 on K = e^x (divided
    differences on the non-uniform K grid); >= 0 iff butterfly-free.
    Same scale as :func:`_step_identity_density` (scale-parity test in
    tests/test_andreasen_huge.py).
    Shape: c (..., n), x (..., n) -> (..., n-2) interior columns.

    CONDITIONING WARNING: second divided differences divide f32 price
    rounding by h_K^2 (down to ~6e-6 on the ITM wing of a log grid) —
    O(1) garbage in f32. Use only at x64 (tests/oracles); the
    production diagnostic is :func:`_step_identity_density`."""
    K = jnp.exp(x)
    dK_lo = K[..., 1:-1] - K[..., :-2]
    dK_hi = K[..., 2:] - K[..., 1:-1]
    s_lo = (c[..., 1:-1] - c[..., :-2]) / dK_lo
    s_hi = (c[..., 2:] - c[..., 1:-1]) / dK_hi
    return 2.0 * (s_hi - s_lo) / (dK_lo + dK_hi)


def _step_identity_density(c: jax.Array, c_prev: jax.Array,
                           sig2: jax.Array, x: jax.Array,
                           dt: jax.Array) -> jax.Array:
    """Discrete density via the step identity — f32-safe.

    From (I - dt*A)c = c_prev: A c = (c - c_prev)/dt, and A is
    (sigma^2 K^2/2) d^2/dK^2, so d^2C/dK^2 = 2 (c - c_prev) /
    (dt sigma^2 K^2). A difference of NEARBY CURVES (error ~ f32 eps of
    the price scale) replaces second differences over h_K^2 (error
    amplified ~1e5x on the ITM wing — measured min g of -3.5 in f32
    where x64 says -1e-10). Boundary rows carry slope conditions, not
    the PDE; callers drop them. Shapes: all (..., n); dt broadcasts."""
    K2 = jnp.exp(2.0 * x)
    denom = jnp.maximum(dt * sig2 * K2, 1e-12)
    return 2.0 * (c - c_prev) / denom


@partial(jax.jit, static_argnames=("n_grid", "n_iters", "lm_unroll"))
def fit_eval_ah_surface(k: jax.Array, iv: jax.Array, expiries: jax.Array,
                        n_grid: int = 257, n_iters: int = 16,
                        grid_pad: float = 1.0,
                        quote_mask: jax.Array | None = None,
                        lm_unroll: bool = False):
    """Fused AH fit + dense-grid eval + arbitrage diagnostics.

    Mirrors ``surface.fit_eval_surface``'s output contract so consumers
    can switch methods: returns dict with ``fit`` (AHFit), ``k_grid``/
    ``w_grid``/``iv_grid`` (B, E, n_grid), ``g``, ``butterfly_ok``/
    ``calendar_ok``, ``fit_rmse``. Two deliberate differences, both from
    the price-space construction:

      * ``g`` is the discrete risk-neutral DENSITY d^2C/dK^2 in STRIKE
        space (unit forward, K = e^k) on the grid interior — zero at
        the two boundary-condition columns — not the Gatheral butterfly
        function; same sign test (>= 0 iff butterfly-free), different
        scale and measure. The log-moneyness density other methods
        report is ``exp(k_grid) * g``. It comes from the f32-safe
        step identity (:func:`_step_identity_density`), not from
        second differences of the price curves;
      * the flags are computed in PRICE space (the step identity IS
        convexity in strike, and calendar monotonicity reads off the
        call curves directly), where the construction's guarantee
        actually lives — the implied-variance grid is Black-inverted
        afterwards, and its deep wings clamp to w=0 where prices touch
        intrinsic.
    """
    fit = fit_ah(k, iv, expiries, n_grid=n_grid, n_iters=n_iters,
                 grid_pad=grid_pad, quote_mask=quote_mask,
                 lm_unroll=lm_unroll)
    x = fit.x                                  # (B, n)
    k_grid = jnp.broadcast_to(x[:, None, :], fit.c.shape)
    c0 = jnp.maximum(1.0 - jnp.exp(x), 0.0)[:, None, :]
    c_prev = jnp.concatenate([c0, fit.c[:, :-1]], axis=1)
    dts = jnp.diff(fit.expiries, prepend=jnp.zeros_like(
        fit.expiries[:, :1]), axis=-1)
    sig2 = jax.vmap(jax.vmap(_cells_to_grid, in_axes=(0, 0, None)))(
        fit.theta, fit.k_q, x)
    dens = _step_identity_density(
        fit.c, c_prev, sig2, x[:, None, :], dts[..., None])[..., 1:-1]
    pad = jnp.zeros_like(dens[..., :1])
    g = jnp.concatenate([pad, dens, pad], axis=-1)
    # the construction guarantees c >= c_prev in EXACT arithmetic
    # (x64 measures min(c - c_prev) = +2e-16); in f32 the PCR solve
    # carries ~4e-5 of price noise (measured, after one refinement
    # sweep), so the flags tolerate 1024 ulps of the unit-forward price
    # scale — 1.2e-4 of notional at f32 (well below any market spread),
    # 2.3e-13 at x64
    tol = 1024.0 * jnp.finfo(k.dtype).eps
    butterfly_ok = jnp.all(
        fit.c[..., 1:-1] >= c_prev[..., 1:-1] - tol, axis=(-2, -1))
    calendar_ok = jnp.all(
        fit.c[:, 1:] >= fit.c[:, :-1] - tol, axis=(-2, -1))
    w_hi = _VOL_HI * _VOL_HI * jnp.maximum(fit.expiries, 1.0)[..., None]
    w_grid = jax.vmap(jax.vmap(_invert_w))(
        fit.c, jnp.broadcast_to(x[:, None, :], fit.c.shape),
        w_hi=jnp.broadcast_to(w_hi, fit.c.shape))
    iv_grid = jnp.sqrt(w_grid / jnp.maximum(fit.expiries[..., None], 1e-12))
    return {
        "fit": fit,
        "k_grid": k_grid,
        "w_grid": w_grid,
        "iv_grid": iv_grid,
        "g": g,
        "butterfly_ok": butterfly_ok,
        "calendar_ok": calendar_ok,
        "fit_rmse": fit.fit_rmse,
        # the model's own local vol — sqrt of the sig2 the density
        # diagnostic already expanded (same values as ah_local_vol(fit),
        # without a second cells-to-grid pass)
        "local_vol": jnp.sqrt(sig2),
    }
