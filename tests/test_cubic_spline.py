"""Cubic-spline fit/eval parity vs scipy.interpolate.CubicSpline (<=1e-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.interpolate import CubicSpline

from iv_engine.ops.cubic_spline import (
    eval_cubic_spline,
    eval_cubic_spline_deriv,
    eval_cubic_spline_second_deriv,
    fit_cubic_spline,
    fit_eval_smile,
)

BC_MAP = {"natural": "natural", "not-a-knot": "not-a-knot"}


def _smile_chain(rng, n):
    """Synthetic IV smile: strikes + smile-shaped vols with noise."""
    k = np.sort(rng.uniform(0.5, 2.0, n))
    # ensure strictly increasing
    k = k + np.arange(n) * 1e-6
    iv = 0.2 + 0.3 * (np.log(k)) ** 2 + 0.01 * rng.normal(size=n)
    return k, iv


@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
@pytest.mark.parametrize("n", [4, 5, 50])
def test_matches_scipy(rng, bc, n):
    k, iv = _smile_chain(rng, n)
    t = np.linspace(k[0], k[-1], 200)
    M = fit_cubic_spline(jnp.array(k), jnp.array(iv), bc_type=bc)
    got = eval_cubic_spline(jnp.array(k), jnp.array(iv), M, jnp.array(t))
    ref = CubicSpline(k, iv, bc_type=BC_MAP[bc])(t)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-8)


def test_not_a_knot_n3(rng):
    k = np.array([0.8, 1.0, 1.3])
    iv = np.array([0.25, 0.2, 0.24])
    t = np.linspace(0.8, 1.3, 50)
    M = fit_cubic_spline(jnp.array(k), jnp.array(iv), bc_type="not-a-knot")
    got = eval_cubic_spline(jnp.array(k), jnp.array(iv), M, jnp.array(t))
    ref = CubicSpline(k, iv, bc_type="not-a-knot")(t)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-8)


def test_clamped_matches_scipy(rng):
    k, iv = _smile_chain(rng, 30)
    t = np.linspace(k[0], k[-1], 100)
    fp0, fpn = 0.1, -0.2
    M = fit_cubic_spline(jnp.array(k), jnp.array(iv), bc_type="clamped",
                         fp0=fp0, fpn=fpn)
    got = eval_cubic_spline(jnp.array(k), jnp.array(iv), M, jnp.array(t))
    ref = CubicSpline(k, iv, bc_type=((1, fp0), (1, fpn)))(t)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-8)


def test_derivatives_match_scipy(rng):
    k, iv = _smile_chain(rng, 40)
    t = np.linspace(k[0], k[-1], 100)
    cs = CubicSpline(k, iv, bc_type="natural")
    M = fit_cubic_spline(jnp.array(k), jnp.array(iv), bc_type="natural")
    d1 = eval_cubic_spline_deriv(jnp.array(k), jnp.array(iv), M, jnp.array(t))
    d2 = eval_cubic_spline_second_deriv(jnp.array(k), jnp.array(iv), M,
                                        jnp.array(t))
    np.testing.assert_allclose(np.asarray(d1), cs(t, 1), atol=1e-8)
    np.testing.assert_allclose(np.asarray(d2), cs(t, 2), atol=1e-8)


def test_extrapolation_matches_scipy(rng):
    k, iv = _smile_chain(rng, 20)
    t = np.array([k[0] - 0.1, k[-1] + 0.1])
    M = fit_cubic_spline(jnp.array(k), jnp.array(iv), bc_type="natural")
    got = eval_cubic_spline(jnp.array(k), jnp.array(iv), M, jnp.array(t))
    ref = CubicSpline(k, iv, bc_type="natural")(t)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-8)


def test_batched_smiles(rng):
    B, n, m = 32, 50, 50
    ks = np.stack([_smile_chain(rng, n)[0] for _ in range(B)])
    ivs = np.stack([_smile_chain(rng, n)[1] for _ in range(B)])
    ts = np.linspace(ks[:, 0], ks[:, -1], m, axis=-1)
    got = np.asarray(fit_eval_smile(jnp.array(ks), jnp.array(ivs),
                                    jnp.array(ts), bc_type="natural"))
    for i in range(B):
        ref = CubicSpline(ks[i], ivs[i], bc_type="natural")(ts[i])
        np.testing.assert_allclose(got[i], ref, atol=1e-8)


def test_linear_data_gives_linear_spline(rng):
    k = np.linspace(0.5, 2.0, 20)
    iv = 0.1 + 0.05 * k
    M = fit_cubic_spline(jnp.array(k), jnp.array(iv), bc_type="natural")
    np.testing.assert_allclose(np.asarray(M), 0.0, atol=1e-12)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("bc", ["natural", "not-a-knot"])
def test_fuzz_vs_scipy(seed, bc):
    r = np.random.default_rng(1000 + seed)
    n = int(r.integers(4, 80))
    k = np.sort(r.uniform(-2, 2, n))
    k += np.arange(n) * 1e-9
    y = r.normal(size=n)
    t = np.sort(r.uniform(k[0] - 0.5, k[-1] + 0.5, 60))
    M = fit_cubic_spline(jnp.array(k), jnp.array(y), bc_type=bc)
    got = eval_cubic_spline(jnp.array(k), jnp.array(y), M, jnp.array(t))
    ref = CubicSpline(k, y, bc_type=BC_MAP[bc])(t)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-7,
                               err_msg=f"seed={seed} n={n} bc={bc}")


def test_clamped_two_knots_matches_scipy(rng):
    """n=2 clamped: the cubic Hermite honoring BOTH end slopes — the
    n==2 early return used to hand back a flat line, discarding fp0/fpn
    (round-4 review). The general clamped system degenerates to exactly
    SciPy's 2x2 equations."""
    k = np.array([0.0, 1.5])
    iv = np.array([0.4, 0.5])
    fp0, fpn = 0.3, -0.4
    t = np.linspace(0.0, 1.5, 40)
    M = fit_cubic_spline(jnp.array(k), jnp.array(iv), bc_type="clamped",
                         fp0=fp0, fpn=fpn)
    got = eval_cubic_spline(jnp.array(k), jnp.array(iv), M, jnp.array(t))
    ref = CubicSpline(k, iv, bc_type=((1, fp0), (1, fpn)))(t)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-8)
    # natural/not-a-knot n=2 stay the SciPy straight line
    M0 = fit_cubic_spline(jnp.array(k), jnp.array(iv), bc_type="natural")
    np.testing.assert_allclose(np.asarray(M0), 0.0)
