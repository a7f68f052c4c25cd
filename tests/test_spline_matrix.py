"""Matrix-form spline parity: identical to SciPy CubicSpline (natural)
and to the scan-based path, at <=1e-8 in f64."""

import jax.numpy as jnp
import numpy as np
from scipy.interpolate import CubicSpline

from iv_engine.ops.spline_matrix import (
    apply_spline_operator,
    build_spline_operator,
    build_surface_operators,
    fit_eval_surface_grid,
)
from iv_engine.surface.surface import fit_eval_surface


def test_matches_scipy(rng):
    n, m = 50, 80
    x = np.sort(rng.uniform(-1, 1, n))
    t = np.linspace(x[0], x[-1], m)
    op = build_spline_operator(jnp.array(x), jnp.array(t))
    B = 16
    ys = rng.normal(size=(B, n))
    S, S1, S2 = apply_spline_operator(op, jnp.array(ys))
    for i in range(B):
        cs = CubicSpline(x, ys[i], bc_type="natural")
        np.testing.assert_allclose(np.asarray(S)[i], cs(t), atol=1e-8)
        np.testing.assert_allclose(np.asarray(S1)[i], cs(t, 1), atol=1e-8)
        np.testing.assert_allclose(np.asarray(S2)[i], cs(t, 2), atol=1e-8)


def test_surface_grid_matches_general_path(rng):
    B, E, n, m = 8, 10, 20, 25
    k = np.broadcast_to(np.linspace(-1.0, 1.0, n), (B, E, n)).copy()
    T = np.linspace(0.1, 2.0, E)
    iv = 0.2 + 0.08 * k**2 + 0.01 * rng.normal(size=(B, 1, 1))

    # general (scan) path evaluates on its own common grid; replicate it
    general = fit_eval_surface(jnp.array(k), jnp.array(iv),
                               jnp.array(np.broadcast_to(T, (B, E))),
                               n_grid=m)
    queries = np.asarray(general["k_grid"])[0, 0]
    ops = build_surface_operators(jnp.array(k[0]), jnp.array(queries))
    fast = fit_eval_surface_grid(ops, jnp.array(iv), jnp.array(T))

    np.testing.assert_allclose(np.asarray(fast["w_grid"]),
                               np.asarray(general["w_grid"]), atol=1e-10)
    np.testing.assert_allclose(np.asarray(fast["g"]),
                               np.asarray(general["g"]), atol=1e-9)
    np.testing.assert_array_equal(np.asarray(fast["butterfly_ok"]),
                                  np.asarray(general["butterfly_ok"]))
    np.testing.assert_array_equal(np.asarray(fast["calendar_ok"]),
                                  np.asarray(general["calendar_ok"]))


def test_extrapolation_matches_scipy(rng):
    n = 20
    x = np.sort(rng.uniform(-1, 1, n))
    t = np.array([x[0] - 0.2, x[-1] + 0.2])
    op = build_spline_operator(jnp.array(x), jnp.array(t))
    y = rng.normal(size=n)
    S, _, _ = apply_spline_operator(op, jnp.array(y))
    cs = CubicSpline(x, y, bc_type="natural")
    np.testing.assert_allclose(np.asarray(S), cs(t), atol=1e-8)


def test_not_a_knot_operator_matches_scipy(rng):
    """Operator-form not-a-knot == SciPy CubicSpline default bc."""
    n, m = 50, 80
    x = np.sort(rng.uniform(-1, 1, n))
    t = np.linspace(x[0], x[-1], m)
    op = build_spline_operator(jnp.array(x), jnp.array(t),
                               bc_type="not-a-knot")
    B = 16
    ys = rng.normal(size=(B, n))
    S, S1, S2 = apply_spline_operator(op, jnp.array(ys))
    for i in range(B):
        cs = CubicSpline(x, ys[i])  # SciPy default == not-a-knot
        np.testing.assert_allclose(np.asarray(S)[i], cs(t), atol=1e-8)
        np.testing.assert_allclose(np.asarray(S1)[i], cs(t, 1), atol=1e-8)
        np.testing.assert_allclose(np.asarray(S2)[i], cs(t, 2), atol=1e-7)


def test_not_a_knot_kills_natural_edge_butterfly_artifact():
    """Natural BC pins fitted w''=0 at the end knots, creating spurious
    negative butterfly-g at the first/last grid columns on smiles whose
    true curvature is positive there; not-a-knot tracks the smooth smile
    and keeps the diagnostic clean. (Root-caused 2026-08-16: 63% of clean
    quadratic smiles were flagged under natural BC.)"""
    E, n, m = 30, 50, 50
    k_row = np.linspace(-1.0, 1.0, n)
    knots = jnp.array(np.broadcast_to(k_row, (E, n)).copy())
    queries = jnp.array(np.linspace(-1.0, 1.0, m))
    T = jnp.array(np.linspace(0.05, 2.0, E))
    # steep-but-arbitrage-free quadratic smiles (true g verified >= 0.009
    # in closed form across this parameter box)
    B = 64
    rng = np.random.default_rng(7)
    atm = rng.uniform(0.15, 0.6, (B, 1, 1))
    curv = rng.uniform(0.05, 0.3, (B, 1, 1))
    iv = jnp.array(atm + curv * k_row[None, None, :] ** 2
                   * np.ones((B, E, n)))

    ops_nat = build_surface_operators(knots, queries, bc_type="natural")
    ops_nak = build_surface_operators(knots, queries, bc_type="not-a-knot")
    out_nat = fit_eval_surface_grid(ops_nat, iv, T)
    out_nak = fit_eval_surface_grid(ops_nak, iv, T)

    assert bool(jnp.all(out_nak["butterfly_ok"])), (
        "not-a-knot should be artifact-free on smooth smiles")
    # the natural-BC artifact is real and sits at the edge columns
    g_nat = np.asarray(out_nat["g"])
    assert not bool(jnp.all(out_nat["butterfly_ok"]))
    interior_min = g_nat[..., 1:-1].min()
    assert interior_min > -1e-8, "natural-BC artifact must be edge-only"


def test_fit_surface_spline_bc_threaded(rng):
    """surface.fit_eval_surface(spline_bc='not-a-knot') == SciPy default
    bc on each slice."""
    B, E, n = 2, 4, 20
    k = np.broadcast_to(np.linspace(-1.0, 1.0, n), (B, E, n)).copy()
    T = np.broadcast_to(np.linspace(0.1, 2.0, E), (B, E)).copy()
    iv = 0.3 + 0.1 * k**2 + 0.01 * rng.normal(size=(B, E, n))
    out = fit_eval_surface(jnp.array(k), jnp.array(iv), jnp.array(T),
                           n_grid=33, spline_bc="not-a-knot")
    kg = np.asarray(out["k_grid"])
    w = iv**2 * T[..., None]
    for b in range(B):
        for e in range(E):
            cs = CubicSpline(k[b, e], w[b, e])
            np.testing.assert_allclose(np.asarray(out["w_grid"])[b, e],
                                       cs(kg[b, e]), atol=1e-8)


def test_not_a_knot_three_knots_is_scipy_parabola(rng):
    """n=3 not-a-knot: the generic construction is SINGULAR (both
    boundary rows reference the same interior knot) and silently
    returned NaN operators under jit — the pipeline's streaming default
    hit this on any 3-strike chain (round-3 review finding). The fix
    pins constant curvature, which is exactly SciPy's n=3 behavior
    (the interpolating parabola)."""
    x = np.array([-0.4, 0.1, 0.5])
    t = np.linspace(-0.6, 0.7, 23)
    op = build_spline_operator(jnp.asarray(x), jnp.asarray(t),
                               bc_type="not-a-knot")
    y = np.array([0.09, 0.04, 0.075])
    s, s1, s2 = (np.asarray(a) for a in
                 apply_spline_operator(op, jnp.asarray(y)))
    assert np.isfinite(s).all() and np.isfinite(s2).all()
    cs = CubicSpline(x, y)          # SciPy default == not-a-knot
    np.testing.assert_allclose(s, cs(t), atol=1e-10)
    np.testing.assert_allclose(s2, cs(t, 2), atol=1e-9)


def test_not_a_knot_two_knots_degrades_to_linear():
    """n=2 not-a-knot: SciPy raises; the operator form degrades to the
    straight line so a 2-strike streaming chain fits instead of
    producing NaNs (the old construction indexed out of bounds)."""
    x = np.array([-0.3, 0.4])
    t = np.linspace(-0.3, 0.4, 11)
    op = build_spline_operator(jnp.asarray(x), jnp.asarray(t),
                               bc_type="not-a-knot")
    y = np.array([0.05, 0.12])
    s, s1, s2 = (np.asarray(a) for a in
                 apply_spline_operator(op, jnp.asarray(y)))
    expect = y[0] + (y[1] - y[0]) * (t - x[0]) / (x[1] - x[0])
    np.testing.assert_allclose(s, expect, atol=1e-12)
    np.testing.assert_allclose(s2, 0.0, atol=1e-12)
