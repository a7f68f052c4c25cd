"""Native packer: C++ path must agree exactly with the NumPy path."""

import numpy as np
import pytest

from iv_engine import native


requires_native = pytest.mark.skipif(
    not native.native_available(),
    reason="native toolchain unavailable (g++/make)")


@requires_native
def test_scatter_pack_matches_numpy(rng):
    R, C, B, L = 500, 8, 10, 64
    colmat = rng.normal(size=(R, C)).astype(np.float32)
    row_sym = rng.integers(0, B, R).astype(np.int32)
    row_pos = rng.integers(0, L, R).astype(np.int64)
    on_grid = (rng.uniform(size=R) < 0.9).astype(np.uint8)
    # de-duplicate (sym, pos) pairs: scatter order is unspecified
    _, keep = np.unique(row_sym.astype(np.int64) * L + row_pos,
                        return_index=True)
    mask = np.zeros(R, bool)
    mask[keep] = True
    on_grid = (on_grid.astype(bool) & mask).astype(np.uint8)

    v_native = np.full((B, C, L), np.nan, np.float32)
    m_native = np.zeros((B, L), bool)
    assert native.scatter_pack(colmat, row_sym, row_pos, on_grid,
                               v_native, m_native)

    v_np = np.full((B, C, L), np.nan, np.float32)
    m_np = np.zeros((B, L), bool)
    sel = on_grid.astype(bool)
    v_np[row_sym[sel], :, row_pos[sel]] = colmat[sel]
    m_np[row_sym[sel], row_pos[sel]] = True

    np.testing.assert_array_equal(v_native, v_np)
    np.testing.assert_array_equal(m_native, m_np)


@requires_native
def test_gather_unpack_roundtrip(rng):
    B, C, L = 6, 5, 32
    values = rng.normal(size=(B, C, L)).astype(np.float32)
    out_sym = rng.integers(0, B, 40).astype(np.int32)
    out_pos = rng.integers(0, L, 40).astype(np.int64)
    out = native.gather_unpack(values, out_sym, out_pos)
    assert out is not None
    expected = values[out_sym, :, out_pos]
    np.testing.assert_array_equal(out, expected)


def test_ingest_uses_native_or_falls_back(rng):
    """pack_symbols must produce identical batches whichever path runs."""
    import pandas as pd
    from iv_engine.pipeline.ingest import pack_symbols
    from iv_engine.pipeline.sample_data import (
        generate_sample_tickers)
    df = generate_sample_tickers(num_symbols=4, hours=12)
    res32 = pack_symbols(df, (2048,), min_points=2, dtype=np.float32)
    res64 = pack_symbols(df, (2048,), min_points=2, dtype=np.float64)
    b32, b64 = res32.batches[0], res64.batches[0]
    np.testing.assert_array_equal(b32.obs_mask, b64.obs_mask)
    np.testing.assert_allclose(b32.values, b64.values.astype(np.float32),
                               rtol=1e-6, equal_nan=True)
