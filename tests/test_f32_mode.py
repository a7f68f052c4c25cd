"""Fast-mode (float32) accuracy envelope.

The parity suite runs in float64; the device fast path runs float32. These
tests document and enforce the f32 deviation envelope against the f64
oracles (SURVEY.md §7.3: "f32 fast mode with documented tolerance").
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.interpolate import CubicSpline

from iv_engine.ops.cubic_spline import fit_eval_smile
from iv_engine.ops.interp import masked_interp
from iv_engine.ops.spline_matrix import (
    apply_spline_operator,
    build_spline_operator,
)
from iv_engine.ops.svi import fit_svi, svi_total_variance


def test_spline_f32_envelope(rng):
    n, m = 50, 80
    x = np.sort(rng.uniform(-1, 1, n))
    y = 0.04 + 0.12 * x**2 + 0.002 * rng.normal(size=n)
    t = np.linspace(x[0], x[-1], m)
    ref = CubicSpline(x, y, bc_type="natural")(t)
    got32 = np.asarray(fit_eval_smile(
        jnp.array(x, jnp.float32)[None], jnp.array(y, jnp.float32)[None],
        jnp.array(t, jnp.float32)[None]))
    assert got32.dtype == np.float32
    # envelope: <=1e-5 relative on smile-scale values
    np.testing.assert_allclose(got32[0], ref, atol=2e-6)


def test_matrix_spline_f32_envelope(rng):
    n, m = 50, 50
    x = np.linspace(-1, 1, n)
    t = np.linspace(-1, 1, m)
    op = build_spline_operator(jnp.array(x, jnp.float32),
                               jnp.array(t, jnp.float32))
    y = (0.04 + 0.12 * x**2).astype(np.float32)
    S, _, _ = apply_spline_operator(op, jnp.array(y)[None])
    ref = CubicSpline(x, y.astype(np.float64), bc_type="natural")(t)
    np.testing.assert_allclose(np.asarray(S)[0], ref, atol=5e-6)


def test_interp_f32_envelope(rng):
    L = 1000
    vals = (rng.normal(size=L) + 20000).astype(np.float32)
    vals[rng.uniform(size=L) < 0.8] = np.nan
    vals[0] = vals[-1] = 20000.0
    import pandas as pd
    ref = pd.Series(vals.astype(np.float64)).interpolate("linear").to_numpy()
    got = np.asarray(masked_interp(jnp.array(vals), jnp.ones(L, bool)))
    assert got.dtype == np.float32
    # price-scale values (~2e4): f32 resolution ~2e-3
    np.testing.assert_allclose(got, ref, atol=5e-3)


def test_svi_f32_envelope():
    k = jnp.linspace(-1.0, 1.0, 50, dtype=jnp.float32)
    true = jnp.array([0.04, 0.4, -0.4, 0.05, 0.3], jnp.float32)
    w = svi_total_variance(true, k)
    fit = fit_svi(k, w, max_iters=100)
    assert fit.params.dtype == jnp.float32
    w_fit = svi_total_variance(fit.params, k)
    np.testing.assert_allclose(np.asarray(w_fit), np.asarray(w), atol=2e-6)
