"""Smoothing spline parity vs scipy.interpolate.make_smoothing_spline."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.interpolate import CubicSpline, make_smoothing_spline

from iv_engine.ops.smoothing_spline import (
    eval_smoothing_spline,
    eval_smoothing_spline_derivs,
    fit_smoothing_spline,
)


def _noisy_smile(rng, n):
    k = np.sort(rng.uniform(-1.2, 1.2, n))
    k += np.arange(n) * 1e-6
    w = 0.04 + 0.12 * k**2 + 0.004 * rng.normal(size=n)
    return k, w


@pytest.mark.parametrize("lam", [1e-6, 1e-4, 1e-2])
def test_matches_scipy(rng, lam):
    k, w = _noisy_smile(rng, 40)
    t = np.linspace(k[0], k[-1], 120)
    fit = fit_smoothing_spline(jnp.array(k), jnp.array(w), lam)
    got = eval_smoothing_spline(fit, jnp.array(t))
    ref = make_smoothing_spline(k, w, lam=lam)(t)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-8)


def test_lam_zero_interpolates(rng):
    k, w = _noisy_smile(rng, 25)
    fit = fit_smoothing_spline(jnp.array(k), jnp.array(w), 0.0)
    got = eval_smoothing_spline(fit, jnp.array(k))
    np.testing.assert_allclose(np.asarray(got), w, atol=1e-9)
    # and equals the natural interpolating spline between knots
    t = np.linspace(k[0], k[-1], 77)
    ref = CubicSpline(k, w, bc_type="natural")(t)
    got_t = eval_smoothing_spline(fit, jnp.array(t))
    np.testing.assert_allclose(np.asarray(got_t), ref, atol=1e-9)


def test_large_lam_approaches_line(rng):
    k, w = _noisy_smile(rng, 30)
    fit = fit_smoothing_spline(jnp.array(k), jnp.array(w), 1e6)
    _, _, S2 = eval_smoothing_spline_derivs(
        fit, jnp.array(np.linspace(k[0], k[-1], 50)))
    assert float(jnp.max(jnp.abs(S2))) < 1e-4  # curvature penalised away


def test_batched(rng):
    B, n = 8, 30
    ks = np.stack([_noisy_smile(rng, n)[0] for _ in range(B)])
    ws = np.stack([_noisy_smile(rng, n)[1] for _ in range(B)])
    t = np.linspace(-1.0, 1.0, 60)
    fit = fit_smoothing_spline(jnp.array(ks), jnp.array(ws), 1e-4)
    got = np.asarray(eval_smoothing_spline(
        fit, jnp.broadcast_to(jnp.array(t), (B, 60))))
    for b in range(B):
        ref = make_smoothing_spline(ks[b], ws[b], lam=1e-4)(t)
        np.testing.assert_allclose(got[b], ref, atol=1e-8)


def test_smoothing_reduces_butterfly_violations(rng):
    """Noisy smiles that violate butterfly no-arb should stop violating
    after smoothing — the production use case."""
    from iv_engine.surface.arbitrage import butterfly_g
    k = np.linspace(-1.0, 1.0, 40)
    w = 0.04 + 0.1 * k**2 + 0.003 * rng.normal(size=40)
    t = jnp.array(np.linspace(-0.9, 0.9, 100))
    raw = fit_smoothing_spline(jnp.array(k), jnp.array(w), 0.0)
    S0, S1_0, S2_0 = eval_smoothing_spline_derivs(raw, t)
    g_raw = butterfly_g(t, S0, S1_0, S2_0)
    sm = fit_smoothing_spline(jnp.array(k), jnp.array(w), 1e-3)
    S, S1, S2 = eval_smoothing_spline_derivs(sm, t)
    g_sm = butterfly_g(t, S, S1, S2)
    assert float(jnp.min(g_sm)) > float(jnp.min(g_raw))
    assert float(jnp.min(g_sm)) > -1e-6


def test_autolam_minimal_smoothing(rng):
    """Noisy violating slices get just enough smoothing to clear the
    butterfly check; clean slices keep (near-)zero smoothing."""
    from iv_engine.ops.smoothing_spline import (
        eval_smoothing_spline, fit_smoothing_spline_autolam)
    from iv_engine.surface.arbitrage import butterfly_g
    from iv_engine.ops.smoothing_spline import (
        eval_smoothing_spline_derivs)
    n = 40
    k = np.broadcast_to(np.linspace(-1.0, 1.0, n), (2, n)).copy()
    clean = 0.04 + 0.1 * k[0] ** 2
    noisy = clean + 0.004 * rng.normal(size=n)
    w = jnp.array(np.stack([clean, noisy]))
    lams = jnp.array([1e-8, 1e-5, 1e-3, 1e-1])
    fit = fit_smoothing_spline_autolam(jnp.array(k), w, lams)
    t = jnp.array(np.broadcast_to(np.linspace(-0.9, 0.9, 80), (2, 80)))
    S, S1, S2 = eval_smoothing_spline_derivs(fit, t)
    g = butterfly_g(t, S, S1, S2)
    assert float(jnp.min(g)) > -1e-9   # every slice arb-free
    # the clean slice is barely perturbed (lam stayed tiny)
    np.testing.assert_allclose(np.asarray(fit.g[0]), clean, atol=1e-5)
    # the noisy slice was actually smoothed
    assert float(jnp.max(jnp.abs(fit.g[1] - w[1]))) > 1e-4
