"""Sequence-parallel interpolation: sharded == single-device numerics."""

import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine.ops.interp import masked_interp
from iv_engine.parallel.mesh import make_mesh
from iv_engine.parallel.sequence import sharded_masked_interp


def _gappy(rng, shape, frac=0.8):
    vals = rng.normal(size=shape) + 5.0
    vals[rng.uniform(size=shape) < frac] = np.nan
    return vals


@pytest.mark.parametrize("method", ["linear", "ffill"])
@pytest.mark.parametrize("frac", [0.5, 0.95])
def test_matches_single_device(rng, method, frac):
    mesh = make_mesh((8, 1))
    L = 1024
    vals = _gappy(rng, (L,), frac)
    vals[L // 3] = 7.0  # ensure at least one valid point
    mask = np.ones(L, bool)
    ref = masked_interp(jnp.array(vals), jnp.array(mask), method=method)
    got = sharded_masked_interp(jnp.array(vals), jnp.array(mask), mesh,
                                method=method)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-12, equal_nan=True)


def test_batched_columns_sharded(rng):
    mesh = make_mesh((8, 1))
    C, L = 5, 512
    vals = _gappy(rng, (C, L), 0.7)
    vals[:, L // 2] = 3.0
    mask = np.ones((C, L), bool)
    ref = masked_interp(jnp.array(vals), jnp.array(mask))
    got = sharded_masked_interp(jnp.array(vals), jnp.array(mask), mesh)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=1e-12, equal_nan=True)


def test_empty_shards_bridge_across_devices(rng):
    """A gap spanning several shards must interpolate seamlessly — the
    failure mode of the reference's seamed chunking (SURVEY.md §2.1.3)."""
    mesh = make_mesh((8, 1))
    L = 800
    vals = np.full(L, np.nan)
    vals[10] = 1.0
    vals[790] = 2.0  # gap crosses ~7 shard boundaries
    mask = np.ones(L, bool)
    got = np.asarray(sharded_masked_interp(jnp.array(vals), jnp.array(mask),
                                           mesh))
    ref = np.asarray(masked_interp(jnp.array(vals), jnp.array(mask)))
    np.testing.assert_allclose(got, ref, atol=1e-12, equal_nan=True)
    # and the bridge is exactly linear
    np.testing.assert_allclose(got[400], 1.0 + (400 - 10) / 780.0, atol=1e-12)


def test_max_gap_respected_across_shards():
    mesh = make_mesh((8, 1))
    L = 800
    vals = np.full(L, np.nan)
    vals[0], vals[50], vals[700] = 1.0, 2.0, 3.0
    mask = np.ones(L, bool)
    got = np.asarray(sharded_masked_interp(
        jnp.array(vals), jnp.array(mask), mesh, max_gap_minutes=100))
    ref = np.asarray(masked_interp(
        jnp.array(vals), jnp.array(mask), max_gap_minutes=100))
    np.testing.assert_allclose(got, ref, atol=1e-12, equal_nan=True)
    assert np.isnan(got[300])      # 50 -> 700 gap masked
    assert np.isfinite(got[25])    # 0 -> 50 bridged


def test_bf16_positions_survive_all_gather(rng):
    """Boundary positions ride an int32 all_gather, not values.dtype:
    bf16 is integer-exact only to 256, so a boundary position like 1000
    used to round and corrupt interpolation weights and has_prev/next
    tests at shard seams (round-4 review)."""
    mesh = make_mesh((8, 1))
    L = 2048  # positions far beyond bf16's exact-integer range
    vals = np.full(L, np.nan)
    vals[700], vals[1500] = 4.0, 8.0  # one bridge spanning shard seams
    mask = np.ones(L, bool)
    v16 = jnp.asarray(vals, jnp.bfloat16)
    ref = masked_interp(v16, jnp.array(mask), method="linear")
    got = sharded_masked_interp(v16, jnp.array(mask), mesh,
                                method="linear")
    np.testing.assert_array_equal(
        np.asarray(got, np.float32), np.asarray(ref, np.float32))
