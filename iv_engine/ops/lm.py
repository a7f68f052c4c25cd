"""Batched Levenberg-Marquardt for small nonlinear least-squares problems.

Built for SVI smile calibration (5 params x thousands of slices, see
``ops.svi``) but generic. Accelerator-first design choices:

  * fixed iteration count (``lax.fori_loop``), per-problem acceptance
    masking instead of data-dependent control flow — vmapping a
    ``while_loop`` would run every problem until the *slowest* converges
    anyway, so a static bound with freeze-on-convergence is both simpler
    and XLA-friendlier (SURVEY.md §7.3 "batched LM robustness under vmap");
  * Jacobians via ``jax.jacfwd`` (forward mode: few params, many residuals);
  * normal equations with Marquardt diagonal scaling, solved by
    Cholesky on (P,P) systems — JtJ + positive damping is SPD by
    construction, and Cholesky does half LU's factorization work at
    P=90 (eSSVI's joint surface fit, where the solve dominates the
    step). If rounding ever makes the system indefinite the factor goes
    NaN, the candidate step is rejected, and lambda grows — exactly
    LM's normal recovery path, so no fallback solve is needed.

No analogous reference component — the reference had no solver at all;
this is the engine behind the north-star SVI capability (BASELINE.json
config #3).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class LMResult(NamedTuple):
    params: jax.Array      # (..., P) final parameters
    cost: jax.Array        # (...,) final 0.5*sum(r^2)
    n_accepted: jax.Array  # (...,) accepted steps
    converged: jax.Array   # (...,) bool — gradient/step tolerance met


@partial(jax.jit, static_argnames=("residual_fn", "max_iters", "unroll"))
def levenberg_marquardt(residual_fn: Callable, params0: jax.Array, *args,
                        max_iters: int = 50, lambda0: float = 1e-3,
                        tol: float = 1e-12, lower=None, upper=None,
                        unroll: bool = False) -> LMResult:
    """Minimise ``0.5 * ||residual_fn(p, *args)||^2`` for one problem.

    Batch by ``jax.vmap`` over leading dims of ``params0``/``args``.

    Args:
      residual_fn: (P,) params, *args -> (M,) residuals. Must be traceable.
      params0: (P,) initial guess.
      args: data arrays closed over per problem.
      lower/upper: optional (P,) box constraints, applied by projection.
    """
    dtype = params0.dtype
    lo = -jnp.inf if lower is None else jnp.asarray(lower, dtype)
    hi = jnp.inf if upper is None else jnp.asarray(upper, dtype)

    def clip(p):
        return jnp.clip(p, lo, hi)

    def cost_of(p):
        r = residual_fn(p, *args)
        return 0.5 * jnp.sum(r * r)

    def body(_, state):
        p, lam, cost, n_acc, converged = state
        r = residual_fn(p, *args)
        J = jax.jacfwd(residual_fn)(p, *args)          # (M, P)
        hp = jax.lax.Precision.HIGHEST  # full f32: the default may run TF32
        g = jnp.matmul(J.T, r, precision=hp)           # gradient (P,)
        JtJ = jnp.matmul(J.T, J, precision=hp)
        diag = jnp.diag(JtJ)
        # Marquardt scaling with a floor so flat directions stay regularised
        damp = lam * jnp.maximum(diag, 1e-12)
        A = JtJ + jnp.diag(damp)
        L = jnp.linalg.cholesky(A)
        y = jax.scipy.linalg.solve_triangular(L, -g[..., None], lower=True)
        delta = jax.scipy.linalg.solve_triangular(
            L.T, y, lower=False)[..., 0]
        p_new = clip(p + delta)
        cost_new = cost_of(p_new)
        accept = (cost_new < cost) & jnp.isfinite(cost_new)
        p = jnp.where(accept & ~converged, p_new, p)
        cost_next = jnp.where(accept & ~converged, cost_new, cost)
        lam = jnp.where(converged, lam,
                        jnp.where(accept, lam / 3.0, lam * 3.0))
        lam = jnp.clip(lam, 1e-12, 1e12)
        n_acc = n_acc + (accept & ~converged)
        # small_step is gated on ACCEPTANCE: a rejection streak drives
        # lambda to its cap, shrinking the damped step towards zero —
        # ungated, that latched converged=True at a non-optimum.
        # small_grad needs no gate (it tests the CURRENT iterate).
        small_step = accept & (
            jnp.max(jnp.abs(delta)) < tol * (1.0 + jnp.max(jnp.abs(p))))
        small_grad = jnp.max(jnp.abs(g)) < tol
        small_impr = accept & (cost - cost_new < tol * jnp.maximum(cost, 1.0))
        converged = converged | small_step | small_grad | small_impr
        return p, lam, cost_next, n_acc, converged

    p0 = clip(params0)
    state0 = (p0, jnp.asarray(lambda0, dtype), cost_of(p0),
              jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    # unroll=True inlines the iterations into one straight-line program —
    # essential on runtimes where each on-device loop iteration costs ~1ms
    # of dispatch (see bench.py); costs compile time, so it is opt-in.
    p, lam, cost, n_acc, converged = jax.lax.fori_loop(
        0, max_iters, body, state0, unroll=max_iters if unroll else 1
    )
    return LMResult(params=p, cost=cost, n_accepted=n_acc, converged=converged)


def levenberg_marquardt_batched(residual_fn, params0, *args, **kw):
    """vmap over the leading batch dim of every input."""
    f = partial(levenberg_marquardt, residual_fn, **kw)
    return jax.vmap(f)(params0, *args)


def robustify(residual_fn: Callable, delta: float) -> Callable:
    """Wrap a residual function with a pseudo-Huber transform so LM
    minimises a robust loss instead of plain least squares.

    With rho(r) = 2 delta^2 (sqrt(1+(r/delta)^2) - 1) (pseudo-Huber:
    quadratic for |r| << delta, linear for |r| >> delta), the returned
    residual is s(r) = r * sqrt(rho(r)/r^2) so that ||s||^2 = sum rho.
    The ratio uses the exact identity rho/r^2 =
    2/(1 + sqrt(1+(r/delta)^2)) — smooth at r=0 and jacfwd-safe (no
    sign/abs). Outlier quotes then pull the fit with bounded force
    instead of quadratically dominating it.
    """
    inv_d = 1.0 / float(delta)

    def robust_fn(p, *args):
        r = residual_fn(p, *args)
        scaled = r * inv_d
        ratio = 2.0 / (1.0 + jnp.sqrt(1.0 + scaled * scaled))
        return r * jnp.sqrt(ratio)

    return robust_fn
