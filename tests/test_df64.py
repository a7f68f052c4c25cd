"""df64 (double-f32) arithmetic: error-free transformations vs the f64
oracle. These primitives underwrite the <=1e-8 north-star parity claim
(ops/spline_compensated.py), so the tests check EXACTNESS of the EFTs,
not just closeness — a backend that contracts or reassociates them
would fail here loudly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine.ops import df64 as df


def _rand_f32(rng, n=4096, scale_span=12):
    # magnitudes spanning ~2^-6..2^6 with mixed signs
    m = rng.uniform(-1.0, 1.0, n) * np.exp2(
        rng.integers(-scale_span // 2, scale_span // 2, n))
    return jnp.asarray(m.astype(np.float32))


def test_two_sum_exact(rng):
    a, b = _rand_f32(rng), _rand_f32(rng)
    s, e = jax.jit(df.two_sum)(a, b)
    lhs = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    rhs = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_array_equal(lhs, rhs)


def test_two_prod_exact(rng):
    a, b = _rand_f32(rng), _rand_f32(rng)
    p, e = jax.jit(df.two_prod)(a, b)
    # the exact product of two f32 has <=48 mantissa bits: representable
    # in f64, so p + e must reproduce it to the LAST BIT
    lhs = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    rhs = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(lhs, rhs)


def _to64(x):
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


def _as_df(rng, n=4096):
    """Random df64 values with genuinely populated low limbs."""
    hi = _rand_f32(rng, n)
    lo = jnp.asarray(
        (np.asarray(hi, np.float64) * rng.uniform(1e-9, 1e-8, n)
         ).astype(np.float32))
    return hi, lo


@pytest.mark.parametrize("op,ref", [
    (df.add, np.add), (df.sub, np.subtract),
    (df.mul, np.multiply), (df.div, np.divide),
])
def test_df_ops_vs_f64(rng, op, ref):
    x, y = _as_df(rng), _as_df(rng)
    got = _to64(jax.jit(op)(x, y))
    want = ref(_to64(x), _to64(y))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert rel.max() < 1e-12, rel.max()


def test_df_mul_f_add_f(rng):
    x, f = _as_df(rng), _rand_f32(rng)
    got = _to64(jax.jit(df.mul_f)(x, f))
    want = _to64(x) * np.asarray(f, np.float64)
    assert (np.abs(got - want)
            / np.maximum(np.abs(want), 1e-300)).max() < 1e-12
    got = _to64(jax.jit(df.add_f)(x, f))
    want = _to64(x) + np.asarray(f, np.float64)
    assert (np.abs(got - want)
            / np.maximum(np.abs(got) + np.abs(want), 1e-300)).max() < 1e-12


def test_df_add_cancellation(rng):
    # near-total cancellation: hi limbs annihilate, result = low limbs
    hi = _rand_f32(rng, 512)
    x = (hi, jnp.asarray(np.full(512, 3e-8, np.float32)))
    y = (-hi, jnp.asarray(np.full(512, 2e-8, np.float32)))
    got = _to64(df.add(x, y))
    np.testing.assert_allclose(got, 5e-8, rtol=1e-6)


def test_diff_exact(rng):
    x = jnp.asarray(np.sort(rng.uniform(-1, 1, 64)).astype(np.float32))
    h = df.diff_exact(x)
    want = np.diff(np.asarray(x, np.float64))
    np.testing.assert_array_equal(_to64(h), want)


def test_const_roundtrip():
    v = np.array([1.0 / 3.0, 1e-7, 123.456789], np.float64)
    np.testing.assert_allclose(_to64(df.const(v)), v, rtol=2e-15)
