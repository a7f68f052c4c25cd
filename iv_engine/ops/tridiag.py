"""Batched tridiagonal solvers.

The cubic-spline smile fit (see ``ops.cubic_spline``) reduces to solving a
symmetric tridiagonal system per smile. The layout is *batch-major*:
thousands of independent systems are carried in the trailing (vectorised)
dimensions while a ``lax.scan`` walks the (small, ~50) system dimension —
every scan step is a wide element-wise op over the whole batch.

This replaces the reference's implicit use of SciPy/pandas C internals as
its "native tier" (SURVEY.md §2); there is no analogous reference file —
the reference only did linear interpolation (src/interpolation/core.py:58-61).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tridiag_solve(dl: jax.Array, d: jax.Array, du: jax.Array, b: jax.Array) -> jax.Array:
    """Solve tridiagonal systems ``A x = b`` via the Thomas algorithm.

    Args:
      dl: sub-diagonal, shape ``(n,) + batch``; ``dl[0]`` is ignored.
      d:  main diagonal, shape ``(n,) + batch``.
      du: super-diagonal, shape ``(n,) + batch``; ``du[n-1]`` is ignored.
      b:  right-hand side, shape ``(n,) + batch``.

    The system dimension must be axis 0 so that each scan step is a wide
    vector op over the batch dims. No pivoting — callers must supply
    diagonally-dominant systems (spline systems always are).

    Returns:
      x with the same shape as ``b``.
    """
    n = d.shape[0]
    if n == 1:
        return b / d

    # Forward elimination: c'[i] = du[i] / (d[i] - dl[i] * c'[i-1])
    #                      r'[i] = (b[i] - dl[i] * r'[i-1]) / (d[i] - dl[i] * c'[i-1])
    def fwd(carry, inputs):
        c_prev, r_prev = carry
        dl_i, d_i, du_i, b_i = inputs
        denom = d_i - dl_i * c_prev
        c_i = du_i / denom
        r_i = (b_i - dl_i * r_prev) / denom
        return (c_i, r_i), (c_i, r_i)

    c0 = du[0] / d[0]
    r0 = b[0] / d[0]
    (_, _), (c_rest, r_rest) = jax.lax.scan(
        fwd, (c0, r0), (dl[1:], d[1:], du[1:], b[1:])
    )
    c = jnp.concatenate([c0[None], c_rest], axis=0)
    r = jnp.concatenate([r0[None], r_rest], axis=0)

    # Back substitution: x[i] = r'[i] - c'[i] * x[i+1]
    def bwd(x_next, inputs):
        c_i, r_i = inputs
        x_i = r_i - c_i * x_next
        return x_i, x_i

    x_last = r[n - 1]
    _, x_front = jax.lax.scan(
        bwd, x_last, (c[: n - 1], r[: n - 1]), reverse=True
    )
    return jnp.concatenate([x_front, x_last[None]], axis=0)


def tridiag_solve_pcr(dl: jax.Array, d: jax.Array, du: jax.Array,
                      b: jax.Array) -> jax.Array:
    """Parallel cyclic reduction solve (same contract as
    :func:`tridiag_solve`: system dim = axis 0).

    PCR runs ceil(log2 n) *levels* of wide element-wise updates instead of
    2n sequential scan steps — fewer dependent steps, each a wide
    element-wise kernel. Numerically safe for the diagonally-dominant
    spline systems this framework generates; no pivoting.
    """
    n = d.shape[0]
    if n == 1:
        return b / d
    # the Thomas-contract ignores dl[0] / du[n-1]; PCR reads them, so they
    # must be true zeros (no coupling outside the system)
    dl = dl.at[0].set(0.0)
    du = du.at[n - 1].set(0.0)

    def shifted(a, s, fill):
        """a[i+s] along axis 0 with out-of-range -> fill."""
        k = min(abs(s), a.shape[0])
        pad = jnp.full((k,) + a.shape[1:], fill, a.dtype)
        if s > 0:
            return jnp.concatenate([a[k:], pad], axis=0)
        return jnp.concatenate([pad, a[:a.shape[0] - k]], axis=0)

    s = 1
    while s < n:
        d_m = shifted(d, -s, 1.0)   # d_{i-s} (identity ghost rows)
        d_p = shifted(d, s, 1.0)    # d_{i+s}
        alpha = -dl / d_m
        beta = -du / d_p
        dl_new = alpha * shifted(dl, -s, 0.0)
        du_new = beta * shifted(du, s, 0.0)
        d_new = d + alpha * shifted(du, -s, 0.0) + beta * shifted(dl, s, 0.0)
        b_new = b + alpha * shifted(b, -s, 0.0) + beta * shifted(b, s, 0.0)
        dl, d, du, b = dl_new, d_new, du_new, b_new
        s *= 2
    return b / d


def tridiag_solve_batch_last(dl, d, du, b):
    """Convenience wrapper for ``(batch..., n)``-shaped inputs.

    Moves the system dimension to axis 0, solves, and moves it back. Prefer
    calling :func:`tridiag_solve` directly with system-major layout in hot
    loops to avoid the transposes.
    """
    move = lambda a: jnp.moveaxis(a, -1, 0)
    x = tridiag_solve(move(dl), move(d), move(du), move(b))
    return jnp.moveaxis(x, 0, -1)


def tridiag_matvec(dl, d, du, x):
    """Multiply a tridiagonal matrix by ``x`` (system dim = axis 0).

    Used by tests and the LM normal-equation checks.
    """
    upper = du[:-1] * x[1:]
    lower = dl[1:] * x[:-1]
    y = d * x
    y = y.at[:-1].add(upper)
    y = y.at[1:].add(lower)
    return y
