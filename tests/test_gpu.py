"""Card-only checks: compiled GPU results against NumPy and SciPy x64
references. They skip on the CPU suite (``requires_gpu``);
``python chip_smoke.py`` runs them on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _on(device, fn, *args):
    with jax.default_device(device):
        return jax.tree.map(np.asarray, jax.jit(fn)(
            *(jnp.asarray(a) for a in args)))


def test_contractions_keep_f32_on_the_card(requires_gpu):
    """Spline-operator eval on the card matches SciPy x64, and SVI fits
    on exact smiles reach the f32 floor; a contraction run in TF32 would
    miss either by orders of magnitude."""
    from scipy.interpolate import CubicSpline

    from iv_engine.ops.spline_matrix import (build_surface_operators,
                                             fit_eval_surface_grid)
    from iv_engine.ops.svi import fit_svi_batched, svi_total_variance

    rng = np.random.default_rng(0)
    E, n = 6, 50
    k_row = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    iv = (rng.uniform(0.15, 0.6, (64, 1, 1))
          + 0.2 * k_row * k_row).astype(np.float32)
    iv = np.broadcast_to(iv, (64, E, n)).copy()
    T = np.linspace(0.1, 2.0, E, dtype=np.float32)

    def grid(v, t):
        ops = build_surface_operators(
            jnp.broadcast_to(jnp.asarray(k_row), (E, n)),
            jnp.asarray(k_row), bc_type="not-a-knot")
        return fit_eval_surface_grid(ops, v, t)["w_grid"]

    w_gpu = _on(requires_gpu, grid, iv, T)
    k64 = k_row.astype(np.float64)
    for b in range(0, 64, 9):
        for e in range(E):
            ref = CubicSpline(k64, iv[b, e].astype(np.float64) ** 2
                              * float(T[e]), bc_type="not-a-knot")(k64)
            assert np.abs(w_gpu[b, e] - ref).max() < 1e-6

    # exact SVI smiles: a full-f32 LM reaches the f32 floor (~6e-8);
    # TF32 normal equations stall well above 1e-6
    B, E = 16, 3
    a, b = rng.uniform(0.01, 0.08, (B, E, 1)), rng.uniform(0.05, 0.3, (B, E, 1))
    rho, m = rng.uniform(-0.6, 0.6, (B, E, 1)), rng.uniform(-0.2, 0.2, (B, E, 1))
    sig = rng.uniform(0.1, 0.5, (B, E, 1))
    w = (a + b * (rho * (k_row - m) + np.sqrt((k_row - m) ** 2 + sig ** 2))
         ).astype(np.float32)
    k = np.broadcast_to(k_row, w.shape).astype(np.float32)
    fit = lambda a_, b_: svi_total_variance(fit_svi_batched(
        a_, b_, max_iters=32, init="quasi").params, a_)
    assert np.abs(_on(requires_gpu, fit, k, w) - w).max() < 1e-6


def test_streaming_aggregation_on_the_card(requires_gpu):
    """The streaming step's segment reductions, compiled for the card,
    against direct NumPy reductions: counts and OHLC exact."""
    from iv_engine.pipeline.streaming import _aggregate

    rng = np.random.default_rng(1)
    B, L, ns = 16, 4096, 512
    minute = np.sort(rng.integers(0, ns, (B, L)), -1).astype(np.int32)
    p = rng.normal(100, 1, (B, L)).astype(np.float32)
    v = rng.uniform(0, 5, (B, L)).astype(np.float32)
    ok = rng.random((B, L)) > 0.1
    got = _on(requires_gpu, lambda *a: _aggregate(
        *a, bucket_minutes=1, num_segments=ns, min_count=1),
        minute, p, p, p, p, v, ok)
    for b in range(0, B, 5):
        for s in range(0, ns, 37):
            rows = np.flatnonzero((minute[b] == s) & ok[b])
            assert got.count[b, s] == len(rows)
            if len(rows):
                assert got.open[b, s] == p[b, rows[0]]
                assert got.close[b, s] == p[b, rows[-1]]
                assert got.high[b, s] == p[b, rows].max()
                assert got.low[b, s] == p[b, rows].min()
                np.testing.assert_allclose(
                    got.volume[b, s], v[b, rows].astype(np.float64).sum(),
                    rtol=1e-5)
