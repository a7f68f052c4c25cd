"""SVI smile calibration — batched 5-param fits via Levenberg-Marquardt.

North-star capability (BASELINE.json config #3): "SVI calibration: 5-param
per-expiry fits batched over 30 slices via vmapped LM solver". The
reference had no smile model at all (linear time-interpolation only,
src/interpolation/core.py:58-61); SVI is the industry-standard extension
of its implied-vol handling.

Raw SVI (Gatheral): total variance as a function of log-moneyness k,

    w(k) = a + b * (rho * (k - m) + sqrt((k - m)^2 + sigma^2))

with b >= 0, |rho| < 1, sigma > 0. Butterfly arbitrage is checked with
Gatheral's g-function; calendar arbitrage with total-variance monotonicity
across expiries (see ``surface.arbitrage``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from iv_engine.ops.lm import LMResult, levenberg_marquardt

# parameter order: (a, b, rho, m, sigma)
# numpy on purpose: module-level jnp constants become trace-linked if the
# module is first imported inside a jit trace (a lazy import elsewhere),
# leaking tracers into every later trace; numpy constants are immune
SVI_LOWER = np.array([-10.0, 1e-6, -0.9999, -10.0, 1e-6])
SVI_UPPER = np.array([10.0, 100.0, 0.9999, 10.0, 100.0])


def svi_total_variance(params: jax.Array, k: jax.Array) -> jax.Array:
    """w(k) for raw-SVI ``params`` = (..., 5) against ``k`` = (..., n)."""
    a, b, rho, m, sigma = (params[..., i:i + 1] for i in range(5))
    km = k - m
    return a + b * (rho * km + jnp.sqrt(km * km + sigma * sigma))


def svi_init(k: jax.Array, w: jax.Array) -> jax.Array:
    """Heuristic initial guess from the observed slice."""
    w_min = jnp.min(w)
    m0 = k[jnp.argmin(w)]
    span = jnp.maximum(jnp.max(k) - jnp.min(k), 1e-3)
    # slope of the wings ~ b(1 +/- rho)
    b0 = jnp.maximum((jnp.max(w) - w_min) / span, 1e-3)
    a0 = jnp.maximum(w_min * 0.9, 1e-6)
    return jnp.array([a0, b0, 0.0, m0, 0.1 * span], w.dtype)


def adjugate3x3(A: jax.Array):
    """Batched 3x3 ``(adjugate, det)`` via pure elementwise cofactor
    math — the ONE home for the 9-cofactor block behind both
    :func:`_solve3x3` (svi quasi-init) and ``ops.essvi._inv3x3``
    (round-4 review: the identical block lived in two files, so a
    numerical hardening of one would silently miss the other).

    adj rows are laid out so ``adj @ b`` solves ``A x = det * x`` —
    i.e. ``x = (adj @ b) / det``.
    """
    a11, a12, a13 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a21, a22, a23 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a31, a32, a33 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c11 = a22 * a33 - a23 * a32
    c12 = a23 * a31 - a21 * a33
    c13 = a21 * a32 - a22 * a31
    det = a11 * c11 + a12 * c12 + a13 * c13
    c21 = a13 * a32 - a12 * a33
    c22 = a11 * a33 - a13 * a31
    c23 = a12 * a31 - a11 * a32
    c31 = a12 * a23 - a13 * a22
    c32 = a13 * a21 - a11 * a23
    c33 = a11 * a22 - a12 * a21
    adj = jnp.stack([
        jnp.stack([c11, c21, c31], axis=-1),
        jnp.stack([c12, c22, c32], axis=-1),
        jnp.stack([c13, c23, c33], axis=-1),
    ], axis=-2)
    return adj, det


def _solve3x3(A: jax.Array, b: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 solve (Cramer / adjugate): pure
    elementwise math instead of jnp.linalg.solve's batched LU — the
    quasi-init solves G x batch tiny systems (millions at production
    shapes), where a batched LU is mostly launch and pivoting overhead.
    The systems
    are ridge-regularised normal equations, so the determinant is
    bounded away from zero."""
    adj, det = adjugate3x3(A)
    x = jnp.einsum("...ij,...j->...i", adj, b,
                   precision=jax.lax.Precision.HIGHEST)
    return x / det[..., None]


def svi_quasi_init(k: jax.Array, w: jax.Array, n_m: int = 8,
                   n_sigma: int = 8) -> jax.Array:
    """Quasi-explicit initialisation (Zeliade-style): for fixed (m, sigma)
    SVI is linear in (a, c, d) with w = a + c*y + d*sqrt(y^2+1),
    y = (k-m)/sigma, c = b*sigma*rho, d = b*sigma. Grid-search (m, sigma),
    solve the 3x3 normal equations per candidate, keep the best SSE.
    One slice: k, w (n,) -> params (5,). Batch with vmap.
    """
    k_lo, k_hi = jnp.min(k), jnp.max(k)
    span = jnp.maximum(k_hi - k_lo, 1e-3)
    m_grid = jnp.linspace(k_lo, k_hi, n_m)
    sig_grid = jnp.exp(jnp.linspace(jnp.log(0.05 * span), jnp.log(span),
                                    n_sigma))
    mm, ss = jnp.meshgrid(m_grid, sig_grid, indexing="ij")
    mm = mm.reshape(-1)                       # (G,)
    ss = ss.reshape(-1)
    y = (k[None, :] - mm[:, None]) / ss[:, None]        # (G, n)
    root = jnp.sqrt(y * y + 1.0)
    ones = jnp.ones_like(y)
    X = jnp.stack([ones, y, root], axis=-1)              # (G, n, 3)
    hp = jax.lax.Precision.HIGHEST  # full f32: the default may run TF32
    A = jnp.einsum("gni,gnj->gij", X, X, precision=hp)
    A = A + 1e-10 * jnp.eye(3, dtype=w.dtype)
    rhs = jnp.einsum("gni,n->gi", X, w, precision=hp)
    sol = _solve3x3(A, rhs)                              # (G, 3) = (a, c, d)
    # project into the valid cone: d >= |c| >= 0
    a_, c_, d_ = sol[:, 0], sol[:, 1], sol[:, 2]
    d_ = jnp.maximum(d_, 1e-8)
    c_ = jnp.clip(c_, -0.999 * d_, 0.999 * d_)
    pred = a_[:, None] + c_[:, None] * y + d_[:, None] * root
    sse = jnp.sum((pred - w[None, :]) ** 2, axis=-1)
    gbest = jnp.argmin(sse)
    a0 = a_[gbest]
    d0 = d_[gbest]
    c0 = c_[gbest]
    sigma0 = ss[gbest]
    b0 = d0 / sigma0
    rho0 = c0 / d0
    params = jnp.stack([a0, b0, rho0, mm[gbest], sigma0]).astype(w.dtype)
    return jnp.clip(params, SVI_LOWER.astype(w.dtype),
                    SVI_UPPER.astype(w.dtype))


def _svi_residual(params, k, w, weights, butterfly_penalty):
    r = (svi_total_variance(params, k) - w) * weights
    if butterfly_penalty > 0.0:
        g = svi_g(params, k)
        r = jnp.concatenate([r, butterfly_penalty * jnp.minimum(g, 0.0)])
    return r


@partial(jax.jit, static_argnames=("max_iters", "butterfly_penalty"))
def fit_svi(k: jax.Array, w: jax.Array, weights: jax.Array | None = None,
            params0: jax.Array | None = None, max_iters: int = 64,
            butterfly_penalty: float = 0.0) -> LMResult:
    """Fit one SVI slice: log-moneyness ``k`` -> total variance ``w``.

    ``weights`` scales residuals (e.g. vega weights); ``butterfly_penalty``
    adds hinge residuals on negative g(k) so fits stay arbitrage-free.
    Batch with ``fit_svi_batched``.
    """
    if weights is None:
        weights = jnp.ones_like(w)
    if params0 is None:
        params0 = svi_init(k, w)
    return levenberg_marquardt(
        partial(_svi_residual, butterfly_penalty=butterfly_penalty),
        params0, k, w, weights,
        max_iters=max_iters,
        lower=SVI_LOWER.astype(w.dtype), upper=SVI_UPPER.astype(w.dtype),
    )


@partial(jax.jit, static_argnames=("max_iters", "butterfly_penalty",
                                   "init", "unroll", "loss",
                                   "huber_delta"))
def fit_svi_batched(k: jax.Array, w: jax.Array,
                    weights: jax.Array | None = None,
                    max_iters: int = 64,
                    butterfly_penalty: float = 0.0,
                    init: str = "heuristic",
                    unroll: bool = False,
                    loss: str = "linear",
                    huber_delta: float = 1e-3) -> LMResult:
    """Batched SVI calibration: ``k``, ``w`` of shape (..., n_strikes).

    The whole batch (surfaces x expiries) runs as one vmapped LM — this is
    the benchmark configuration "30 slices x thousands of surfaces"
    (SURVEY.md §7.1).

    ``unroll=True`` inlines the LM iterations: a bigger compile for
    no loop overhead. On an H100 at 1024 x 30 slices the two run
    within 2% of each other (PERF.md), so the loop is the default.

    ``loss='huber'`` minimises the pseudo-Huber loss with scale
    ``huber_delta`` (in total-variance units) instead of least squares —
    bad quotes pull the fit with bounded force (``ops.lm.robustify``).
    """
    if weights is None:
        weights = jnp.ones_like(w)
    batch_shape = w.shape[:-1]
    kf = k.reshape((-1, k.shape[-1]))
    wf = w.reshape((-1, w.shape[-1]))
    wtf = weights.reshape((-1, w.shape[-1]))
    if init == "quasi":
        p0 = jax.vmap(svi_quasi_init)(kf, wf)
    else:
        p0 = jax.vmap(svi_init)(kf, wf)
    residual = partial(_svi_residual, butterfly_penalty=butterfly_penalty)
    if loss == "huber":
        from iv_engine.ops.lm import robustify
        residual = robustify(residual, huber_delta)
    elif loss != "linear":
        raise ValueError(f"unknown loss: {loss!r}")
    fit = jax.vmap(
        lambda p, kk, ww, wt: levenberg_marquardt(
            residual,
            p, kk, ww, wt, max_iters=max_iters, unroll=unroll,
            lower=SVI_LOWER.astype(w.dtype), upper=SVI_UPPER.astype(w.dtype),
        )
    )(p0, kf, wf, wtf)
    reshape = lambda a: a.reshape(batch_shape + a.shape[1:])
    return LMResult(*map(reshape, fit))


def vega_weights(k: jax.Array, w: jax.Array) -> jax.Array:
    """Relative Black-Scholes vega weights from log-moneyness and observed
    total variance alone: vega ~ S sqrt(T) phi(d1) with
    d1 = (-k + w/2) / sqrt(w); constant per-slice factors drop out of the
    least-squares weighting. Normalised to mean 1 per slice."""
    w_safe = jnp.maximum(w, 1e-8)
    d1 = (-k + w_safe / 2.0) / jnp.sqrt(w_safe)
    phi = jnp.exp(-0.5 * d1 * d1)
    return phi / jnp.maximum(jnp.mean(phi, axis=-1, keepdims=True), 1e-12)


def svi_g(params: jax.Array, k: jax.Array) -> jax.Array:
    """Gatheral's butterfly-arbitrage function

        g(k) = (1 - k w'/(2w))^2 - (w'^2/4)(1/w + 1/4) + w''/2 .

    g(k) >= 0 for all k (with w > 0) <=> the slice is butterfly-arbitrage
    free. Derivatives are closed-form for SVI.
    """
    a, b, rho, m, sigma = (params[..., i:i + 1] for i in range(5))
    km = k - m
    root = jnp.sqrt(km * km + sigma * sigma)
    w = a + b * (rho * km + root)
    w1 = b * (rho + km / root)
    w2 = b * sigma * sigma / (root * root * root)
    # closed-form SVI derivatives -> the ONE shared Gatheral g formula
    # (surface.arbitrage.butterfly_g, which owns the w floor policy) —
    # essvi_g follows the same pattern; an inline copy of the t1/t2
    # terms had already drifted into two homes (round-4 review)
    from iv_engine.surface.arbitrage import butterfly_g
    return butterfly_g(k, w, w1, w2)


def svi_is_butterfly_free(params: jax.Array, k_grid: jax.Array,
                          tol: float = -1e-10) -> jax.Array:
    """Check g(k) >= tol on a dense grid."""
    return jnp.all(svi_g(params, k_grid) >= tol)
