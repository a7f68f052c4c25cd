"""Double-f32 ("df64") compensated arithmetic.

The accelerator this was first written for had no f64 datapath for
dense math (f64 linear algebra did not compile there; ROADMAP D1 asks
whether native f64 on the GPU can replace this layer), yet BASELINE.md's
north star demands
<=1e-8 deviation from the SciPy x64 oracle *on the deliverable path*.
This module closes that gap with classic error-free transformations
(Dekker 1971, Knuth TAOCP 4.2.2): every value is an unevaluated pair
``(hi, lo)`` of f32 arrays with ``hi = fl(hi + lo)``, giving ~2^-45
effective relative precision — six orders of magnitude tighter than the
1e-8 target — while every op stays a plain f32 element-wise op XLA can fuse.

Design notes (why each primitive is safe under XLA):
  * ``two_sum`` uses only adds/subtracts — XLA does not reassociate
    floating-point adds, so the error term is computed exactly.
  * ``two_prod`` uses the FMA-free Dekker split (constant ``2^12 + 1``
    for f32). If a backend contracts ``a*b - p`` into an FMA the result
    only gets MORE exact (that is the FMA form of two_prod), so the
    transformation is safe either way. Verified against the f64 oracle
    in tests/test_df64.py on the CPU backend and by the on-chip parity
    telemetry in bench.py.
  * All helpers are shape-polymorphic: a df64 value is a ``(hi, lo)``
    tuple of equal-shape f32 arrays, which is a pytree — jit/vmap/scan
    compose without ceremony.

Costs (f32 flops per element): add ~10, mul ~20, div ~35. The consumers
(ops.spline_compensated) restrict df64 work to O(n) per smile — the
residual-refinement structure keeps the O(n log n) solve in plain f32.

No reference analogue: the reference ran everything in numpy f64 on CPU
(src/interpolation/core.py) and never faced an f32 hardware floor.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Dekker splitting constant for f32 (24-bit mantissa): 2^ceil(24/2) + 1.
_SPLIT_F32 = 4097.0


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), s + e = a + b."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = a * jnp.asarray(_SPLIT_F32, a.dtype)
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: returns (p, e) with p = fl(a*b), p + e = a*b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ---------------------------------------------------------------------------
# df64 values: (hi, lo) tuples of f32 arrays.
# ---------------------------------------------------------------------------

def const(v, dtype=jnp.float32):
    """df64 constant from a python/np float64 (host-side split)."""
    hi = np.asarray(v, np.float32)
    lo = np.asarray(np.asarray(v, np.float64) - np.float64(hi), np.float32)
    return jnp.asarray(hi, dtype), jnp.asarray(lo, dtype)


def from_f32(a):
    """Lift an exact f32 array into df64."""
    return a, jnp.zeros_like(a)


def to_f32(x):
    """Round a df64 value to nearest f32 (hi already is, by invariant)."""
    return x[0] + x[1]


def neg(x):
    return -x[0], -x[1]


def add(x, y):
    """df64 + df64 (sloppy variant: abs error ~eps^2*|x+y| — far inside
    the 1e-8 budget; the accurate variant's extra 10 flops buy nothing
    here)."""
    sh, se = two_sum(x[0], y[0])
    return fast_two_sum(sh, se + (x[1] + y[1]))


def add_f(x, f):
    """df64 + f32."""
    sh, se = two_sum(x[0], f)
    return fast_two_sum(sh, se + x[1])


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    """df64 * df64."""
    ph, pe = two_prod(x[0], y[0])
    pe = pe + (x[0] * y[1] + x[1] * y[0])
    return fast_two_sum(ph, pe)


def mul_f(x, f):
    """df64 * f32 (f exact)."""
    ph, pe = two_prod(x[0], f)
    pe = pe + x[1] * f
    return fast_two_sum(ph, pe)


def div(x, y):
    """df64 / df64 via one Newton-style correction: ~2^-44 relative."""
    q1 = x[0] / y[0]
    r = sub(x, mul_f(y, q1))
    q2 = (r[0] + r[1]) / y[0]
    return fast_two_sum(q1, q2)


def diff_exact(a, axis=-1):
    """Exact consecutive differences of an f32 array as df64.

    jnp.diff rounds; ``two_sum(a[i+1], -a[i])`` does not. Used for knot
    spacings h where the fit's conditioning concentrates.
    """
    hi_src = jnp.moveaxis(a, axis, -1)
    s, e = two_sum(hi_src[..., 1:], -hi_src[..., :-1])
    return jnp.moveaxis(s, -1, axis), jnp.moveaxis(e, -1, axis)


def tmap(fn, *xs):
    """Apply an array-level fn (gather/transpose/concat...) to both limbs."""
    return tuple(fn(*[x[i] for x in xs]) for i in range(2))
