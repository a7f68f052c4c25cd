"""Tridiagonal solver parity vs SciPy banded solve (<=1e-12 in f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.linalg import solve_banded

from iv_engine.ops.tridiag import (
    tridiag_matvec,
    tridiag_solve,
    tridiag_solve_batch_last,
)


def _scipy_solve(dl, d, du, b):
    n = len(d)
    ab = np.zeros((3, n))
    ab[0, 1:] = du[:-1]
    ab[1, :] = d
    ab[2, :-1] = dl[1:]
    return solve_banded((1, 1), ab, b)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 50, 257])
def test_matches_scipy(rng, n):
    d = rng.uniform(4.0, 6.0, n)
    dl = rng.uniform(-1.0, 1.0, n)
    du = rng.uniform(-1.0, 1.0, n)
    b = rng.normal(size=n)
    x = tridiag_solve(jnp.array(dl), jnp.array(d), jnp.array(du), jnp.array(b))
    expected = _scipy_solve(dl, d, du, b)
    np.testing.assert_allclose(np.asarray(x), expected, rtol=0, atol=1e-12)


def test_batched(rng):
    n, batch = 50, 64
    d = rng.uniform(4.0, 6.0, (n, batch))
    dl = rng.uniform(-1.0, 1.0, (n, batch))
    du = rng.uniform(-1.0, 1.0, (n, batch))
    b = rng.normal(size=(n, batch))
    x = np.asarray(tridiag_solve(*map(jnp.array, (dl, d, du, b))))
    for j in range(batch):
        expected = _scipy_solve(dl[:, j], d[:, j], du[:, j], b[:, j])
        np.testing.assert_allclose(x[:, j], expected, atol=1e-12)


def test_batch_last_layout(rng):
    n, batch = 17, 5
    d = rng.uniform(4.0, 6.0, (batch, n))
    dl = rng.uniform(-1.0, 1.0, (batch, n))
    du = rng.uniform(-1.0, 1.0, (batch, n))
    b = rng.normal(size=(batch, n))
    x = np.asarray(tridiag_solve_batch_last(*map(jnp.array, (dl, d, du, b))))
    for j in range(batch):
        expected = _scipy_solve(dl[j], d[j], du[j], b[j])
        np.testing.assert_allclose(x[j], expected, atol=1e-12)


def test_matvec_roundtrip(rng):
    n = 33
    d = rng.uniform(4.0, 6.0, n)
    dl = rng.uniform(-1.0, 1.0, n)
    du = rng.uniform(-1.0, 1.0, n)
    x_true = rng.normal(size=n)
    b = tridiag_matvec(*map(jnp.array, (dl, d, du, x_true)))
    x = tridiag_solve(jnp.array(dl), jnp.array(d), jnp.array(du), b)
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-12)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 50, 257])
def test_pcr_matches_scipy(rng, n):
    from iv_engine.ops.tridiag import tridiag_solve_pcr
    d = rng.uniform(4.0, 6.0, n)
    dl = rng.uniform(-1.0, 1.0, n)
    du = rng.uniform(-1.0, 1.0, n)
    b = rng.normal(size=n)
    x = tridiag_solve_pcr(jnp.array(dl), jnp.array(d), jnp.array(du),
                          jnp.array(b))
    expected = _scipy_solve(dl, d, du, b)
    np.testing.assert_allclose(np.asarray(x), expected, rtol=0, atol=1e-10)


def test_pcr_batched(rng):
    from iv_engine.ops.tridiag import tridiag_solve_pcr
    n, batch = 50, 256
    d = rng.uniform(4.0, 6.0, (n, batch))
    dl = rng.uniform(-1.0, 1.0, (n, batch))
    du = rng.uniform(-1.0, 1.0, (n, batch))
    b = rng.normal(size=(n, batch))
    x = np.asarray(tridiag_solve_pcr(*map(jnp.array, (dl, d, du, b))))
    x_scan = np.asarray(tridiag_solve(*map(jnp.array, (dl, d, du, b))))
    np.testing.assert_allclose(x, x_scan, atol=1e-10)
