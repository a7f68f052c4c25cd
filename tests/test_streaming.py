"""Streaming fused pipeline tests: tick->candle->refit in one jit."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from iv_engine.pipeline.streaming import streaming_step


def _ticks(rng, B, n_ticks, n_minutes, sigma_annual=0.5):
    minute = np.sort(rng.integers(0, n_minutes, (B, n_ticks)), axis=-1)
    # GBM *minute path* with known annual vol; ticks sample the path at
    # their minute (so multiple ticks per minute don't inflate variance)
    per_min = sigma_annual / np.sqrt(365.25 * 24 * 60)
    path = 100.0 * np.exp(np.cumsum(rng.normal(0, per_min, (B, n_minutes)),
                                    axis=-1))
    price = np.take_along_axis(path, minute, axis=-1)
    size = rng.uniform(0, 10, (B, n_ticks))
    valid = np.ones((B, n_ticks), bool)
    return (jnp.asarray(minute), jnp.asarray(price), jnp.asarray(size),
            jnp.asarray(valid))


def _chains(rng, B, E=6, n=12):
    k = np.broadcast_to(np.linspace(-0.8, 0.8, n), (B, E, n)).copy()
    T = np.broadcast_to(np.linspace(0.1, 1.5, E), (B, E)).copy()
    iv = 0.5 + 0.05 * k**2
    return jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T)


@pytest.mark.slow
def test_streaming_step_shapes_and_flags(rng):
    B, n_minutes = 8, 256
    tm, tp, tsz, tv = _ticks(rng, B, 2000, n_minutes)
    k, iv, T = _chains(rng, B)
    out = streaming_step(tm, tp, tsz, tv, k, iv, T,
                         n_minutes=n_minutes, n_grid=20)
    assert out.w_grid.shape == (B, 6, 20)
    assert out.iv_grid.shape == (B, 6, 20)
    assert np.asarray(out.butterfly_ok).all()
    assert np.asarray(out.calendar_ok).all()
    # candles chain: 1-min and 5-min buckets populated
    assert np.asarray(out.candles_1m.valid).sum() > 0
    assert np.asarray(out.candles_5m.valid).sum() > 0


@pytest.mark.slow
def test_realized_vol_recovers_input_vol(rng):
    """GBM ticks with sigma=0.5/yr -> realized estimate near 0.5."""
    B, n_minutes = 16, 1024
    tm, tp, tsz, tv = _ticks(rng, B, 8000, n_minutes, sigma_annual=0.5)
    k, iv, T = _chains(rng, B)
    out = streaming_step(tm, tp, tsz, tv, k, iv, T, n_minutes=n_minutes,
                         n_grid=10)
    rv = np.asarray(out.realized_vol)
    assert 0.3 < rv.mean() < 0.7, rv.mean()


@pytest.mark.slow
def test_refit_moves_iv_toward_realized(rng):
    B, n_minutes = 4, 512
    tm, tp, tsz, tv = _ticks(rng, B, 4000, n_minutes, sigma_annual=1.0)
    k, iv, T = _chains(rng, B)  # quoted atm iv = 0.5
    out = streaming_step(tm, tp, tsz, tv, k, iv, T, n_minutes=n_minutes,
                         n_grid=20)
    atm = np.asarray(out.iv_grid)[:, :, 10]
    # realized ~1.0 > quoted 0.5 -> refit IV should rise above the quote
    assert (atm > 0.5).all()


@pytest.mark.slow
def test_single_jit_no_host_roundtrip(rng):
    """The whole chain must be one compiled computation."""
    B, n_minutes = 4, 256
    tm, tp, tsz, tv = _ticks(rng, B, 1000, n_minutes)
    k, iv, T = _chains(rng, B)
    lowered = jax.jit(
        lambda *a: streaming_step(*a, n_minutes=n_minutes, n_grid=10)
    ).lower(tm, tp, tsz, tv, k, iv, T)
    compiled = lowered.compile()
    out = compiled(tm, tp, tsz, tv, k, iv, T)
    assert np.isfinite(np.asarray(out.realized_vol)).all()


@pytest.mark.slow
def test_streaming_step_operator_path_matches_general(rng):
    """spline_ops (precomputed operator refit) == the general spline
    path on the same grids and boundary condition."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from iv_engine.ops.spline_matrix import (
        build_surface_operators_batched)
    from iv_engine.pipeline.streaming import streaming_step

    B, L, n_minutes = 8, 256, 64
    E, n, m = 3, 10, 17
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E), (B, E))
    iv = 0.4 + 0.05 * k * k + 0.01 * jnp.asarray(
        rng.normal(size=(B, 1, 1)))
    minute = jnp.sort(jnp.asarray(
        rng.integers(0, n_minutes, (B, L)).astype(np.int32)), axis=-1)
    price = jnp.asarray(100 + np.cumsum(
        rng.normal(0, 0.01, (B, L)), axis=-1))
    size = jnp.asarray(rng.uniform(0, 5, (B, L)))
    valid = jnp.ones((B, L), bool)

    from iv_engine.surface.surface import common_support_grid
    for bc in ("natural", "not-a-knot"):
        ref = streaming_step(minute, price, size, valid, k, iv, T,
                             n_minutes=n_minutes, n_grid=m, spline_bc=bc)
        ops = build_surface_operators_batched(
            k, common_support_grid(k, m), bc_type=bc)
        fast = streaming_step(minute, price, size, valid, k, iv, T,
                              n_minutes=n_minutes, n_grid=m,
                              spline_ops=ops)
        np.testing.assert_allclose(np.asarray(fast.w_grid),
                                   np.asarray(ref.w_grid),
                                   rtol=1e-8, atol=1e-10)
        np.testing.assert_array_equal(np.asarray(fast.realized_vol),
                                      np.asarray(ref.realized_vol))


@pytest.mark.slow
def test_streaming_session_uses_operator_refit(rng):
    """StreamingSession precomputes the operator stack and its refit
    surfaces stay arbitrage-clean on smooth chains."""
    import jax.numpy as jnp
    import numpy as np
    import pandas as pd
    from iv_engine.pipeline.stream_service import StreamingSession

    B, E, n = 4, 3, 10
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E), (B, E))
    iv = 0.4 + 0.05 * k * k
    unds = [f"u{i}" for i in range(B)]
    sess = StreamingSession(unds, k, iv, T, window_minutes=64,
                            tick_capacity=512, n_grid=17)
    assert sess.spline_ops.E0.shape == (B, E, n, 17)
    frames = []
    for u in unds:
        minutes = np.sort(rng.integers(0, 64, 200))
        frames.append(pd.DataFrame({
            "underlying": u, "minute": minutes,
            "price": 100 + np.cumsum(rng.normal(0, 0.01, 200)),
            "size": rng.uniform(0, 5, 200)}))
    sess.ingest_ticks(pd.concat(frames, ignore_index=True))
    out = sess.refit()
    assert bool(jnp.all(out.butterfly_ok))
    assert np.all(np.isfinite(np.asarray(out.w_grid)))


def test_streaming_session_epoch_scale_minutes(rng):
    """Absolute EPOCH minutes (~29.8M, above float32's 2^24 exact-int
    range) must bucket identically to the same ticks with small
    minutes. Round-4 review: minutes were stored raw in the f32 ring,
    so consecutive epoch minutes rounded to the same even value and
    ticks landed in wrong 1-min candles; the session now rebases
    minutes to the first minute seen before they enter the ring."""
    import pandas as pd
    from iv_engine.pipeline.stream_service import StreamingSession

    B, E, n = 2, 3, 10
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E), (B, E))
    iv = 0.4 + 0.05 * k * k
    unds = [f"u{i}" for i in range(B)]

    minutes = np.sort(rng.integers(0, 64, 300))
    prices = 100 + np.cumsum(rng.normal(0, 0.01, 300))
    sizes = rng.uniform(0.1, 5, 300)
    und_col = [unds[i % B] for i in range(300)]

    outs = {}
    for label, base in (("small", 0), ("epoch", 29_800_000)):
        sess = StreamingSession(unds, k, iv, T, window_minutes=64,
                                tick_capacity=512, n_grid=17)
        ticks = pd.DataFrame({"underlying": und_col,
                              "minute": minutes + base,
                              "price": prices, "size": sizes})
        assert sess.ingest_ticks(ticks) == 300
        assert sess.latest_minute == int(minutes.max()) + base
        outs[label] = sess.refit()

    for field in ("w_grid", "realized_vol", "candles_1m"):
        a, b = getattr(outs["small"], field), getattr(outs["epoch"], field)
        jax.tree.map(lambda x, y: np.testing.assert_array_equal(
            np.asarray(x), np.asarray(y)), a, b)


def test_zero_tick_underlying_keeps_quoted_surface(rng):
    """An underlying with no in-window ticks must keep its quoted IVs
    (scale 1): realized=0 is 'no data', not 'volatility is zero' — the
    blend used to multiply its whole surface by 0.5 (round-4 review)."""
    import pandas as pd
    from iv_engine.pipeline.stream_service import StreamingSession

    B, E, n = 2, 3, 10
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (B, E, n))
    T = jnp.broadcast_to(jnp.linspace(0.1, 1.0, E), (B, E))
    iv = 0.4 + 0.05 * k * k
    sess = StreamingSession(["live", "quiet"], k, iv, T,
                            window_minutes=64, tick_capacity=512,
                            n_grid=17)
    minutes = np.sort(rng.integers(0, 64, 200))
    sess.ingest_ticks(pd.DataFrame({
        "underlying": "live", "minute": minutes,
        "price": 100 + np.cumsum(rng.normal(0, 0.01, 200)),
        "size": np.ones(200)}))
    out = sess.refit()
    assert float(np.asarray(out.realized_vol)[1]) == 0.0
    # quiet underlying's surface equals the pure quoted-IV fit
    from iv_engine.surface.surface import fit_eval_surface
    ref = fit_eval_surface(k[1:2], iv[1:2], T[1:2], n_grid=17,
                           spline_bc="not-a-knot")  # session default
    np.testing.assert_allclose(np.asarray(out.w_grid[1]),
                               np.asarray(ref["w_grid"][0]),
                               rtol=1e-6, atol=1e-8)
    # the live one actually rescaled (its realized differs from quotes)
    assert not np.allclose(np.asarray(out.w_grid[0]),
                           np.asarray(fit_eval_surface(
                               k[:1], iv[:1], T[:1], n_grid=17,
                               spline_bc="not-a-knot")["w_grid"][0]))
