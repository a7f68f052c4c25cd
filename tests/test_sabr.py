"""SABR: Hagan-formula parity vs an independent NumPy implementation and
calibration round-trips."""

import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine.ops.sabr import fit_sabr, fit_sabr_batched, sabr_vol


def hagan_numpy(alpha, beta, rho, nu, F, K, T):
    """Independent NumPy implementation of Hagan et al. (2002)."""
    K = np.asarray(K, float)
    omb = 1.0 - beta
    logFK = np.log(F / K)
    FKmid = (F * K) ** (omb / 2.0)
    c1 = (omb**2 / 24 * alpha**2 / (F * K) ** omb
          + rho * beta * nu * alpha / (4 * FKmid)
          + (2 - 3 * rho**2) / 24 * nu**2)
    denom = FKmid * (1 + omb**2 / 24 * logFK**2 + omb**4 / 1920 * logFK**4)
    z = nu / alpha * FKmid * logFK
    x = np.log((np.sqrt(1 - 2 * rho * z + z**2) + z - rho) / (1 - rho))
    with np.errstate(invalid="ignore", divide="ignore"):
        zx = np.where(np.abs(z) < 1e-7, 1.0 + rho * z / 2, z / x)
    return alpha / denom * zx * (1 + c1 * T)


PARAMS = (0.3, 0.5, -0.3, 0.8)  # alpha, beta, rho, nu


def test_matches_numpy_hagan():
    F, T = 100.0, 0.5
    K = np.linspace(60, 160, 60)
    got = sabr_vol(jnp.array(PARAMS), jnp.float64(F), jnp.array(K),
                   jnp.float64(T))
    ref = hagan_numpy(*PARAMS, F, K, T)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-12)


def test_atm_limit_continuous():
    F, T = 100.0, 1.0
    eps = np.array([1e-10, 1e-8, 1e-6])
    K = np.concatenate([[F], F * (1 + eps), F * (1 - eps)])
    got = np.asarray(sabr_vol(jnp.array(PARAMS), jnp.float64(F),
                              jnp.array(K), jnp.float64(T)))
    assert np.all(np.isfinite(got))
    # continuity across the z->0 series switch (skew means only infinitesimal
    # moneyness shifts should leave vol unchanged)
    np.testing.assert_allclose(got[1:], got[0], rtol=1e-5)


def test_calibration_roundtrip():
    F, T = 100.0, 0.5
    K = jnp.linspace(70.0, 140.0, 30)
    iv = sabr_vol(jnp.array(PARAMS), jnp.float64(F), K, jnp.float64(T))
    fit = fit_sabr(K, iv, jnp.float64(F), jnp.float64(T), max_iters=200,
                   fix_beta=0.5)
    np.testing.assert_allclose(np.asarray(fit.params), PARAMS, atol=1e-5)
    assert float(fit.cost) < 1e-16


def test_calibration_free_beta_refits_curve(rng):
    F, T = 100.0, 0.5
    K = jnp.linspace(70.0, 140.0, 30)
    iv = sabr_vol(jnp.array(PARAMS), jnp.float64(F), K, jnp.float64(T))
    fit = fit_sabr(K, iv, jnp.float64(F), jnp.float64(T), max_iters=300,
                   fix_beta=None)
    # beta is weakly identified; require curve-level recovery, not params
    iv_fit = sabr_vol(fit.params, jnp.float64(F), K, jnp.float64(T))
    np.testing.assert_allclose(np.asarray(iv_fit), np.asarray(iv), atol=1e-6)


@pytest.mark.slow
def test_batched_calibration(rng):
    B, E, n = 4, 8, 25
    F = 100.0 * (1 + 0.1 * rng.uniform(-1, 1, (B, E)))
    T = np.broadcast_to(np.linspace(0.1, 2.0, E), (B, E)).copy()
    alphas = rng.uniform(0.2, 0.4, (B, E))
    params = np.stack([alphas, np.full((B, E), 0.5),
                       rng.uniform(-0.5, 0.0, (B, E)),
                       rng.uniform(0.4, 1.0, (B, E))], axis=-1)
    K = F[..., None] * np.exp(np.linspace(-0.3, 0.3, n))
    iv = np.stack([
        [hagan_numpy(*params[b, e], F[b, e], K[b, e], T[b, e])
         for e in range(E)] for b in range(B)])
    fit = fit_sabr_batched(jnp.array(K), jnp.array(iv), jnp.array(F),
                           jnp.array(T), max_iters=200)
    iv_fit = np.asarray(sabr_vol(fit.params, jnp.array(F)[..., None] * 0
                                 + jnp.array(F)[..., None],
                                 jnp.array(K), jnp.array(T)[..., None] * 0
                                 + jnp.array(T)[..., None]))
    np.testing.assert_allclose(iv_fit, iv, atol=1e-5)


def test_deep_otm_put_wing_f32_stable():
    """Hagan x(z) for z << 0: the direct numerator sqrt_term + z - rho
    cancels catastrophically (f32 computed <= 0 -> log NaN) on the
    deep-OTM-put wing with large nu/alpha — reachable mid-LM from the
    SABR bounds. The conjugate identity (1-rho^2)/(sqrt_term - z + rho)
    is exact and stable there (round-4 review). x64 agreement pins the
    rewrite's correctness."""
    F, T = 100.0, 1.0
    params = jnp.array([1e-3, 0.5, 0.3, 5.0])  # tiny alpha -> |z| huge
    K = jnp.array([1e-3, 0.01, 0.1, 1.0, 10.0])  # K << F -> z << 0
    got64 = np.asarray(sabr_vol(params, jnp.float64(F), K,
                                jnp.float64(T)))
    assert np.all(np.isfinite(got64)) and np.all(got64 > 0)
    got32 = np.asarray(sabr_vol(params.astype(jnp.float32),
                                jnp.float32(F), K.astype(jnp.float32),
                                jnp.float32(T)))
    assert np.all(np.isfinite(got32)) and np.all(got32 > 0)
    np.testing.assert_allclose(got32, got64, rtol=2e-3)
    # the other wing (z >> 0, where the CONJUGATE cancels) stays on the
    # direct branch and remains finite too
    K_hi = jnp.array([1e3, 1e4, 1e5])
    hi32 = np.asarray(sabr_vol(params.astype(jnp.float32),
                               jnp.float32(F), K_hi.astype(jnp.float32),
                               jnp.float32(T)))
    assert np.all(np.isfinite(hi32)) and np.all(hi32 > 0)
