"""Dupire local vol + Breeden-Litzenberger density (surface.localvol)."""

import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine.surface.localvol import (
    local_variance_grid,
    local_vol_surface,
    risk_neutral_density,
)
from iv_engine.surface.surface import fit_eval_surface


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _flat_surface(B=2, E=6, n=30, sigma=0.3):
    k = np.broadcast_to(np.linspace(-1.0, 1.0, n), (B, E, n)).copy()
    T = np.broadcast_to(np.linspace(0.25, 1.5, E), (B, E)).copy()
    iv = np.full((B, E, n), sigma)
    return jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T)


@pytest.mark.slow
def test_flat_surface_local_vol_is_sigma():
    """w = sigma^2 T: w'=w''=0 -> g=1, dw/dT=sigma^2 -> local vol =
    sigma everywhere (the canonical Dupire sanity check)."""
    sigma = 0.3
    k, iv, T = _flat_surface(sigma=sigma)
    out = fit_eval_surface(k, iv, T, n_grid=40, spline_bc="not-a-knot")
    lv = local_vol_surface(out)
    np.testing.assert_allclose(np.asarray(lv["local_vol"]), sigma,
                               rtol=1e-5)
    assert bool(jnp.all(lv["local_vol_ok"]))


def test_flat_surface_density_is_lognormal():
    """Flat surface: p(k) must equal the Black-Scholes lognormal density
    of log-moneyness and integrate to ~1 over a wide grid."""
    sigma, T0 = 0.4, 1.0
    n = 401
    k = np.linspace(-4.0, 4.0, n)
    w = np.full(n, sigma * sigma * T0)
    g = np.ones(n)  # flat smile: g == 1 identically
    p = np.asarray(risk_neutral_density(jnp.asarray(k), jnp.asarray(w),
                                        jnp.asarray(g)))
    s = np.sqrt(sigma * sigma * T0)
    d = (-k / s - s / 2.0)
    p_ref = np.exp(-0.5 * d * d) / (s * np.sqrt(2 * np.pi))
    np.testing.assert_allclose(p, p_ref, rtol=1e-6)
    integral = np.trapezoid(p, k)
    assert abs(integral - 1.0) < 1e-4


@pytest.mark.slow
def test_quadratic_smile_closed_form(rng):
    """w(k,T) = s^2 T (1 + a k^2): linear in T (forward differences
    exact) with closed-form k-derivatives -> compare the whole pipeline
    against the hand-derived Dupire local variance."""
    s2, a = 0.09, 0.05
    B, E, n, m = 1, 5, 40, 40
    k = np.broadcast_to(np.linspace(-1.0, 1.0, n), (B, E, n)).copy()
    T = np.broadcast_to(np.linspace(0.2, 1.0, E), (B, E)).copy()
    w = s2 * T[..., None] * (1.0 + a * k * k)
    iv = np.sqrt(w / T[..., None])
    out = fit_eval_surface(jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T),
                           n_grid=m, spline_bc="not-a-knot")
    lv = local_vol_surface(out)
    kg = np.asarray(out["k_grid"])
    Tg = T[..., None]
    wg = s2 * Tg * (1.0 + a * kg * kg)
    w1 = 2.0 * s2 * Tg * a * kg
    w2 = 2.0 * s2 * Tg * a
    g_ref = ((1.0 - kg * w1 / (2.0 * wg)) ** 2
             - (w1 * w1 / 4.0) * (1.0 / wg + 0.25) + w2 / 2.0)
    lv_ref = s2 * (1.0 + a * kg * kg) / g_ref
    np.testing.assert_allclose(np.asarray(lv["local_var"]), lv_ref,
                               rtol=2e-3)


def test_first_slice_uses_w_over_T():
    """Slice 0's maturity derivative is w_0/T_0 (w(k, 0) = 0)."""
    k, iv, T = _flat_surface(B=1, sigma=0.25)
    out = fit_eval_surface(k, iv, T, n_grid=10, spline_bc="not-a-knot")
    lv = local_variance_grid(out["w_grid"], out["g"], out["fit"].expiries)
    # flat: slice 0 local var = (sigma^2 T_0 / T_0) / 1 = sigma^2
    np.testing.assert_allclose(np.asarray(lv[0, 0]), 0.25 ** 2, rtol=1e-5)


@pytest.mark.slow
def test_density_nonneg_iff_butterfly_free(rng):
    """On an arbitrage-free fitted smile the density is non-negative
    everywhere; negative g would make it negative by the same formula."""
    B, E, n = 4, 6, 30
    k = np.broadcast_to(np.linspace(-1.0, 1.0, n), (B, E, n)).copy()
    T = np.broadcast_to(np.linspace(0.25, 1.5, E), (B, E)).copy()
    iv = 0.3 + 0.1 * k ** 2
    out = fit_eval_surface(jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T),
                           n_grid=40, spline_bc="not-a-knot")
    assert bool(jnp.all(out["butterfly_ok"]))
    lv = local_vol_surface(out)
    assert float(jnp.min(lv["density"])) >= 0.0
    assert bool(jnp.all(lv["local_vol_ok"]))


@pytest.mark.slow
def test_essvi_local_vol_clean(rng):
    """Local vol through the eSSVI method: guaranteed-admissible fits
    give a real local vol everywhere on the grid."""
    from iv_engine.ops.essvi import essvi_w, psi_butterfly_cap
    B, E, n = 2, 6, 21
    theta = np.cumsum(rng.uniform(0.01, 0.05, (B, E)), axis=-1)
    rho = np.broadcast_to(rng.uniform(-0.5, 0.5, (B, 1)), (B, E)).copy()
    frac = np.broadcast_to(rng.uniform(0.3, 0.6, (B, 1)), (B, E)).copy()
    psi = np.asarray(psi_butterfly_cap(jnp.asarray(theta),
                                       jnp.asarray(rho))) * frac
    params = jnp.asarray(np.stack([theta, rho, psi], axis=-1))
    k = jnp.asarray(np.broadcast_to(
        np.linspace(-1.0, 1.0, n), (B, E, n)).copy())
    w = essvi_w(params, k)
    T = jnp.asarray(np.broadcast_to(np.linspace(0.1, 1.1, E), (B, E)).copy())
    iv = jnp.sqrt(w / T[..., None])
    out = fit_eval_surface(k, iv, T, method="essvi", n_grid=33,
                           svi_iters=48)
    lv = local_vol_surface(out)
    assert bool(jnp.all(lv["local_vol_ok"]))
    assert float(jnp.min(lv["local_var"])) > 0.0
    assert np.all(np.isfinite(np.asarray(lv["local_vol"])))


def test_variance_swap_flat_surface():
    """Flat smile: K_var == sigma^2 exactly (up to wing truncation,
    corrected first-order by mass normalisation)."""
    from iv_engine.surface.localvol import variance_swap_strike
    sigma = 0.3
    E = 4
    T = np.linspace(0.25, 1.0, E)
    n = 801
    k = np.broadcast_to(np.linspace(-3.0, 3.0, n), (E, n)).copy()
    w = (sigma * sigma * T)[:, None] * np.ones((E, n))
    g = np.ones((E, n))
    kv = np.asarray(variance_swap_strike(
        jnp.asarray(k), jnp.asarray(w), jnp.asarray(g), jnp.asarray(T)))
    np.testing.assert_allclose(kv, sigma * sigma, rtol=2e-3)


@pytest.mark.slow
def test_variance_swap_through_pipeline():
    """local_vol_surface carries var_swap; on a fitted flat surface it
    reproduces sigma^2 within grid-truncation error."""
    sigma = 0.25
    k, iv, T = _flat_surface(B=2, E=4, n=40, sigma=sigma)
    # widen support: flat smile, so take a wide common grid
    k = k * 3.0
    out = fit_eval_surface(k, iv, T, n_grid=201, spline_bc="not-a-knot")
    lv = local_vol_surface(out)
    kv = np.asarray(lv["var_swap"])
    np.testing.assert_allclose(kv, sigma * sigma, rtol=2e-2)


def test_local_vol_ok_matches_per_cell_mask():
    """local_vol_ok must use the SAME tolerance as local_vol_valid: a
    surface whose butterfly g is exactly 0 at one cell passes the grid
    diagnostics (g >= -1e-10) but that cell's local variance is
    eps-clamped garbage — local_vol_ok = True there let consumers read
    it as real (round-3 review finding)."""
    sigma = 0.3
    k, iv, T = _flat_surface(sigma=sigma)
    out = dict(fit_eval_surface(k, iv, T, n_grid=20,
                                spline_bc="not-a-knot"))
    g0 = out["g"].at[0, 1, 7].set(0.0)       # one boundary-exact cell
    out["g"] = g0
    out["butterfly_ok"] = jnp.all(g0 >= -1e-10, axis=(-2, -1))
    lv = local_vol_surface(out)
    assert bool(out["butterfly_ok"][0])       # diagnostics still green
    assert not bool(lv["local_vol_ok"][0])    # but NOT a usable LV cell
    assert not bool(lv["local_vol_valid"][0, 1, 7])
    # all other surfaces/cells unaffected
    assert bool(jnp.all(lv["local_vol_valid"][1:]))
