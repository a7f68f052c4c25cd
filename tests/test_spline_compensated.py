"""Compensated (df64) spline path vs the SciPy x64 oracle.

THE north-star parity tests (BASELINE.md: <=1e-8 deviation from the
SciPy reference on the deliverable path). The deliverable here is the
df64 pair — ``f64(w_grid) + f64(w_grid_lo)`` — asserted to ~1e-9, three
orders inside the target, on clean, non-uniform, and adversarial
smiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.interpolate import CubicSpline

from iv_engine.ops import df64 as df
from iv_engine.ops.spline_compensated import (
    eval_cubic_spline_df, fit_cubic_spline_df, fit_eval_surface_compensated,
    queries_df)


def _to64(x):
    return np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)


def _oracle(x32, y64, q64, bc):
    return CubicSpline(np.asarray(x32, np.float64), y64, bc_type=bc)(q64)


@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
@pytest.mark.parametrize("uniform", [True, False])
def test_smile_parity_1e9(rng, bc, uniform):
    n, m = 50, 50
    if uniform:
        x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    else:
        x = np.sort(rng.uniform(-1.2, 1.2, n)).astype(np.float32)
    iv = (0.3 + 0.2 * x * x + 0.02 * rng.standard_normal(n)).astype(
        np.float32)
    T = np.float32(0.7)
    # oracle consumes the EXACT f32 inputs in f64 — same contract as
    # bench._spline_accuracy
    w64 = np.asarray(iv, np.float64) ** 2 * np.float64(T)
    q = queries_df(float(x[0]) - 0.1, float(x[-1]) + 0.1, m)  # + extrapolation
    ref = _oracle(x, w64, _to64(q), bc)

    w = df.mul_f(df.two_prod(jnp.asarray(iv), jnp.asarray(iv)), T)
    M = fit_cubic_spline_df(jnp.asarray(x), w, bc_type=bc)
    got = _to64(eval_cubic_spline_df(jnp.asarray(x), w, M, q))
    assert np.abs(got - ref).max() < 1e-9


def test_adversarial_wiggle_parity(rng):
    # the bench adversarial case: grid-scale wiggles (large curvatures)
    n, m = 50, 50
    x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    iv = (0.4 + 0.1 * x * x + 0.08 * np.sin(20 * x)).astype(np.float32)
    w64 = np.asarray(iv, np.float64) ** 2 * 2.0
    q = queries_df(-1.0, 1.0, m)
    ref = _oracle(x, w64, _to64(q), "not-a-knot")
    w = df.mul_f(df.two_prod(jnp.asarray(iv), jnp.asarray(iv)),
                 np.float32(2.0))
    M = fit_cubic_spline_df(jnp.asarray(x), w, bc_type="not-a-knot")
    got = _to64(eval_cubic_spline_df(jnp.asarray(x), w, M, q))
    assert np.abs(got - ref).max() < 1e-9


def test_surface_parity_and_flags(rng):
    B, E, n, m = 4, 6, 50, 50
    k_row = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    k = jnp.asarray(np.broadcast_to(k_row, (E, n)).copy())
    T = np.linspace(0.05, 2.0, E, dtype=np.float32)
    atm = rng.uniform(0.15, 0.6, (B, 1, 1))
    curv = rng.uniform(0.05, 0.3, (B, 1, 1))
    iv = np.broadcast_to(atm + curv * k_row ** 2, (B, E, n)).astype(
        np.float32)

    out = fit_eval_surface_compensated(k, jnp.asarray(iv),
                                       jnp.asarray(T), n_grid=m)
    w64 = (np.asarray(out["w_grid"], np.float64)
           + np.asarray(out["w_grid_lo"], np.float64))
    q64 = np.linspace(-1.0, 1.0, m)
    worst = 0.0
    for b in range(B):
        for e in range(E):
            ref = _oracle(k_row, np.asarray(iv[b, e], np.float64) ** 2
                          * np.float64(T[e]), q64, "not-a-knot")
            worst = max(worst, np.abs(w64[b, e] - ref).max())
    assert worst < 1e-9, worst

    # hi limb alone is a correctly-rounded-grade f32 surface
    assert np.abs(np.asarray(out["w_grid"], np.float64)
                  - w64).max() < 1.2e-7
    assert bool(out["butterfly_ok"].all())
    assert bool(out["calendar_ok"].all())

    # adversarial wiggles must flag
    iv_bad = (iv + 0.08 * np.sin(20 * k_row)).astype(np.float32)
    out_bad = fit_eval_surface_compensated(k, jnp.asarray(iv_bad),
                                           jnp.asarray(T), n_grid=m)
    assert not bool(out_bad["butterfly_ok"].any())


def test_matches_fast_path_to_f32(rng):
    """The compensated hi limb and the matrix fast path agree to f32
    noise — same mathematical object, two numeric routes."""
    from iv_engine.ops.spline_matrix import (
        build_surface_operators, fit_eval_surface_grid)
    B, E, n, m = 3, 5, 30, 40
    k_row = np.linspace(-0.8, 0.8, n, dtype=np.float32)
    k = jnp.asarray(np.broadcast_to(k_row, (E, n)).copy())
    T = jnp.asarray(np.linspace(0.1, 1.5, E, dtype=np.float32))
    iv = jnp.asarray(
        rng.uniform(0.2, 0.5, (B, E, n)).astype(np.float32))
    q32 = jnp.asarray(np.linspace(-0.8, 0.8, m, dtype=np.float32))
    ops = build_surface_operators(k, q32, bc_type="not-a-knot")
    fast = fit_eval_surface_grid(ops, iv, T)
    comp = fit_eval_surface_compensated(
        k, iv, T, queries=queries_df(-0.8, 0.8, m))
    np.testing.assert_allclose(np.asarray(fast["w_grid"]),
                               np.asarray(comp["w_grid"]),
                               atol=5e-6, rtol=0)
