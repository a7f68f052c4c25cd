"""Andreasen-Huge one-step arbitrage-free interpolation tests.

The suite runs at x64 (conftest); the f32 flag test casts explicitly.
Reference: ops/andreasen_huge.py — no analogous reference-repo
component (the reference interpolates linearly in time,
src/interpolation/core.py:58-61, with no arbitrage notion)."""

import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine.ops.andreasen_huge import (
    _price_space_density,
    _step_system,
    ah_step,
    eval_ah,
    fit_ah,
    fit_eval_ah_surface,
    normalized_call,
)
from iv_engine.ops.tridiag import tridiag_matvec


def _chain(B=2, E=4, m=13, dtype=np.float64, skew=0.0):
    k = np.broadcast_to(np.linspace(-0.6, 0.6, m), (B, E, m)).astype(dtype)
    T = np.broadcast_to(np.array([0.1, 0.3, 0.7, 1.2])[:E],
                        (B, E)).astype(dtype)
    iv = (0.25 + 0.1 * k**2 + skew * k
          + 0.02 * np.sqrt(T)[..., None]).astype(dtype)
    return k.copy(), iv, T.copy()


def test_reprices_clean_quotes():
    k, iv, T = _chain()
    # n_grid=129 keeps the quick tier light; the slow tier covers 257
    out = fit_eval_ah_surface(jnp.asarray(k), jnp.asarray(iv),
                              jnp.asarray(T), n_grid=129, n_iters=12)
    assert float(np.asarray(out["fit_rmse"]).max()) < 1e-6  # price space
    # implied vols at the quotes round-trip through the fitted model
    w_at = eval_ah(out["fit"], jnp.asarray(k[:, 2]),
                   jnp.asarray(np.broadcast_to(T[:, 2:3], k[:, 2].shape)))
    iv_at = np.sqrt(np.asarray(w_at) / T[0, 2])
    np.testing.assert_allclose(iv_at, iv[:, 2], atol=2e-4)


def test_arbitrage_free_by_construction():
    """Feed quotes carrying BOTH butterfly and calendar arbitrage; the
    fitted surface must still be clean — that is the method's point."""
    k, iv, T = _chain()
    iv_bad = iv.copy()
    iv_bad[:, :, 6] *= 1.4            # ATM spike: butterfly violation
    iv_bad[:, 2] = iv_bad[:, 1] * 0.5  # collapsing slice: calendar viol.
    out = fit_eval_ah_surface(jnp.asarray(k), jnp.asarray(iv_bad),
                              jnp.asarray(T), n_grid=129, n_iters=12)
    assert np.asarray(out["butterfly_ok"]).all()
    assert np.asarray(out["calendar_ok"]).all()
    # x64 cross-check with raw second divided differences in strike
    c = np.asarray(out["fit"].c)
    x = np.asarray(out["fit"].x)[:, None, :]
    dens = np.asarray(_price_space_density(jnp.asarray(c),
                                           jnp.asarray(x)))
    assert dens.min() > -1e-8
    # calendar in price space
    assert (c[:, 1:] >= c[:, :-1] - 1e-10).all()
    # the repair is visible as repricing error on the impossible quotes
    assert float(np.asarray(out["fit_rmse"]).max()) > 1e-4


def test_step_martingale_kernel_rows():
    """(I - dt*A) applied to functions linear in K = e^x must return
    them unchanged on interior rows (A annihilates constants and K) —
    the property that makes the step a discrete martingale kernel."""
    n = 64
    x = jnp.linspace(-1.5, 1.5, n)
    sig2 = jnp.full((n,), 0.09)
    dl, d, du = _step_system(sig2, x, jnp.asarray(0.4))
    K = jnp.exp(x)
    for vec in (jnp.ones_like(K), K, 2.0 - 0.5 * K):
        y = np.asarray(tridiag_matvec(dl, d, du, vec))
        np.testing.assert_allclose(y[1:-1], np.asarray(vec)[1:-1],
                                   rtol=0, atol=1e-12)


def test_step_matches_dense_numpy_solve():
    """ah_step == numpy x64 dense solve of the assembled system."""
    rng = np.random.default_rng(3)
    n = 48
    x = np.linspace(-1.2, 1.2, n)
    sig2 = (0.2 + 0.1 * rng.random(n)) ** 2
    dt = 0.35
    c_prev = np.maximum(1.0 - np.exp(x), 0.0)
    got = np.asarray(ah_step(jnp.asarray(c_prev), jnp.asarray(sig2),
                             jnp.asarray(x), jnp.asarray(dt)))
    dl, d, du = (np.asarray(a) for a in
                 _step_system(jnp.asarray(sig2), jnp.asarray(x),
                              jnp.asarray(dt)))
    A = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    rhs = c_prev.copy()
    rhs[0] = np.exp(x[1]) - np.exp(x[0])
    rhs[-1] = 0.0
    ref = np.linalg.solve(A, rhs)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)


@pytest.mark.slow
def test_flat_vol_surface():
    """Flat 30% quotes: exact repricing and an implied grid within 20bp
    of 30% across the whole quoted region — including BETWEEN quote
    strikes. theta itself is deliberately NOT asserted flat: the
    piecewise vols absorb the one-step operator's discretisation bias
    (the resolvent is not the exponential), which is how the method is
    meant to work — theta is a calibration device, the surface is the
    product."""
    B, E, m = 1, 3, 11
    k = np.broadcast_to(np.linspace(-0.5, 0.5, m), (B, E, m)).copy()
    T = np.array([[0.25, 0.75, 1.5]])
    iv = np.full((B, E, m), 0.3)
    out = fit_eval_ah_surface(jnp.asarray(k), jnp.asarray(iv),
                              jnp.asarray(T), n_grid=257, n_iters=16)
    assert float(np.asarray(out["fit_rmse"]).max()) < 1e-7
    theta = np.asarray(out["fit"].theta)
    assert (theta > 0.05).all() and (theta < 0.6).all()
    iv_grid = np.asarray(out["iv_grid"])
    xg = np.asarray(out["k_grid"])[0, 0]
    near = np.abs(xg) < 0.4
    np.testing.assert_allclose(iv_grid[0, :, near], 0.3, atol=2e-3)


@pytest.mark.slow
def test_eval_at_quoted_expiry_and_strikes():
    """eval_ah at (quote strike, quoted expiry) returns the input total
    variance (repricing is exact there). Asserted only where the quote
    carries representable time value: a +-7-sigma wing at T=0.1 prices
    at ~1e-14 of notional, below which implied variance is genuinely
    unrecoverable from the price (the inversion clamps to 0 there by
    contract)."""
    k, iv, T = _chain(skew=-0.03)
    fit = fit_ah(jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T),
                 n_grid=257, n_iters=12)
    for j in (0, 1, 3):
        w_true = iv[:, j] ** 2 * T[:, j:j + 1]
        tv = np.asarray(normalized_call(jnp.asarray(k[:, j]),
                                        jnp.asarray(w_true))
                        ) - np.maximum(1 - np.exp(k[:, j]), 0)
        # w is only recoverable where the price carries vega: at a
        # 5-sigma wing a 1e-9 price error maps to ~1e-3 in w, so the
        # tight w assertion holds where time value is material
        live = tv > 1e-4
        # at T=0.1 only the near-ATM quotes carry this much time value
        assert live.sum() >= 4 * k.shape[0]
        w = np.asarray(eval_ah(
            fit, jnp.asarray(k[:, j]),
            jnp.asarray(np.broadcast_to(T[:, j:j + 1], k[:, j].shape))))
        np.testing.assert_allclose(w[live], w_true[live], atol=5e-6)


@pytest.mark.slow
def test_eval_calendar_monotone_between_slices():
    """Total variance along T at fixed k is nondecreasing, INCLUDING at
    in-between maturities (the partial-step interpolation stays
    arbitrage-free — the reference's linear time interpolation has no
    such property)."""
    k, iv, T = _chain()
    fit = fit_ah(jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T),
                 n_grid=257, n_iters=12)
    B = k.shape[0]
    T_q = np.broadcast_to(np.linspace(0.05, 1.4, 40), (B, 40)).copy()
    for kq in (-0.3, 0.0, 0.4):
        w = np.asarray(eval_ah(fit, jnp.full((B, 40), kq),
                               jnp.asarray(T_q)))
        assert (np.diff(w, axis=-1) > -1e-9).all(), kq


@pytest.mark.slow
def test_eval_extrapolates_beyond_last_expiry():
    """T past the last quoted expiry extrapolates with the LAST slice's
    operator: total variance keeps growing (calendar-consistent) and the
    implied vol stays near the last slice's level rather than blowing
    up or collapsing."""
    k, iv, T = _chain()
    fit = fit_ah(jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T),
                 n_grid=257, n_iters=12)
    B = k.shape[0]
    T_ext = np.broadcast_to(np.array([1.2, 1.5, 2.0, 3.0]), (B, 4)).copy()
    w = np.asarray(eval_ah(fit, jnp.zeros((B, 4)), jnp.asarray(T_ext)))
    assert (np.diff(w, axis=-1) > 0).all()
    iv_ext = np.sqrt(w / T_ext)
    iv_last = iv[0, -1, iv.shape[-1] // 2]
    assert (np.abs(iv_ext - iv_last) < 0.05).all()


@pytest.mark.slow
def test_quote_mask_ignores_poisoned_quotes():
    k, iv, T = _chain()
    iv_poison = iv.copy()
    iv_poison[:, :, 4] = 3.0                     # garbage quote
    mask = np.ones_like(iv, bool)
    mask[:, :, 4] = False
    out = fit_eval_ah_surface(jnp.asarray(k), jnp.asarray(iv_poison),
                              jnp.asarray(T), n_grid=257, n_iters=12,
                              quote_mask=jnp.asarray(mask))
    # unmasked quotes still reprice (rmse is masked-aware)
    assert float(np.asarray(out["fit_rmse"]).max()) < 1e-5
    c = np.asarray(out["fit"].c)
    # and the surface near the unmasked quotes matches the clean fit
    clean = fit_eval_ah_surface(jnp.asarray(k), jnp.asarray(iv),
                                jnp.asarray(T), n_grid=257, n_iters=12)
    w_at = eval_ah(out["fit"], jnp.asarray(k[:, 1]),
                   jnp.asarray(np.broadcast_to(T[:, 1:2], k[:, 1].shape)))
    w_clean = eval_ah(clean["fit"], jnp.asarray(k[:, 1]),
                      jnp.asarray(np.broadcast_to(T[:, 1:2],
                                                  k[:, 1].shape)))
    keep = mask[:, 1]
    np.testing.assert_allclose(np.asarray(w_at)[keep],
                               np.asarray(w_clean)[keep], atol=5e-5)


@pytest.mark.slow
def test_f32_flags_stable():
    """The production dtype: flags must hold at f32 across seeds on
    clean AND arb-laden inputs (the step-identity density + 1024-ulp
    price tolerance absorb the measured ~4e-5 PCR solve noise)."""
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        k, iv, T = _chain(B=4, dtype=np.float32)
        iv = (iv + 0.01 * rng.normal(size=(4, 1, 1))).astype(np.float32)
        bad = iv.copy()
        bad[:, :, 6] *= 1.4
        bad[:, 2] = bad[:, 1] * 0.5
        for quotes in (iv, bad):
            out = fit_eval_ah_surface(
                jnp.asarray(k), jnp.asarray(quotes), jnp.asarray(T),
                n_grid=257, n_iters=12)
            assert np.asarray(out["butterfly_ok"]).all(), seed
            assert np.asarray(out["calendar_ok"]).all(), seed


def test_ah_local_vol_matches_theta_cells():
    """ah_local_vol returns theta mapped onto the grid through the
    quote-midpoint cells — exact, piecewise-constant, positive."""
    from iv_engine.ops.andreasen_huge import ah_local_vol

    k, iv, T = _chain(B=1, E=2)
    fit = fit_ah(jnp.asarray(k), jnp.asarray(iv), jnp.asarray(T),
                 n_grid=129, n_iters=6)
    lv = np.asarray(ah_local_vol(fit))
    assert lv.shape == (1, 2, 129)
    assert (lv > 0).all()
    theta = np.asarray(fit.theta)
    x = np.asarray(fit.x)[0]
    kq = k[0, 0]
    mids = 0.5 * (kq[1:] + kq[:-1])
    idx = np.sum(x[:, None] > mids[None, :], axis=1)
    np.testing.assert_allclose(lv[0, 0], theta[0, 0][idx], rtol=1e-12)
    # each grid value IS one of the calibrated cell vols
    assert set(np.round(lv[0, 1], 10)) <= set(np.round(theta[0, 1], 10))


@pytest.mark.slow
def test_high_vol_long_dated_inversion_not_capped():
    """iv=2.0 at T=5y gives total variance w=20 — inside the model's
    own vol box (_VOL_HI=5 allows up to 125) but above the old fixed
    inversion bracket hi=16, which silently reported iv=1.79 with green
    flags (round-3 review finding). The bracket now scales with T."""
    B, E, m = 1, 2, 9
    k = np.broadcast_to(np.linspace(-0.4, 0.4, m), (B, E, m)).copy()
    T = np.array([[3.0, 5.0]])
    iv = np.full((B, E, m), 2.0)
    # n_grid=1025: the pad scales as ~7 sqrt(w) (span ~48 here), so the
    # default 257 leaves h ~ 0.19 — too coarse for 0.1-spaced vol cells
    # (rmse 6.8e-3); 1025 resolves them (5.2e-4)
    out = fit_eval_ah_surface(jnp.asarray(k), jnp.asarray(iv),
                              jnp.asarray(T), n_grid=1025, n_iters=16)
    assert float(np.asarray(out["fit_rmse"]).max()) < 1e-3
    w = np.asarray(eval_ah(out["fit"], jnp.zeros((B, 1)),
                           jnp.full((B, 1), 5.0)))
    np.testing.assert_allclose(w[0, 0], 20.0, rtol=1e-2)
    xg = np.asarray(out["k_grid"])[0, 0]
    atm = np.argmin(np.abs(xg))
    np.testing.assert_allclose(
        np.asarray(out["iv_grid"])[0, 1, atm], 2.0, rtol=5e-3)


@pytest.mark.slow
def test_quote_mask_sentinel_strike_and_nan_iv():
    """Masked slots carrying a sentinel strike (k=-9, still finite) and
    NaN iv must stay inert: the grid spans the UNMASKED strikes, every
    output stays finite, and unmasked quotes reprice (round-3 review
    finding: the old grid bounds used masked strikes and NaN market
    variance leaked through zero weights as NaN*0)."""
    k, iv, T = _chain()
    k_bad = k.copy(); iv_bad = iv.copy()
    k_bad[:, :, 0] = -9.0
    iv_bad[:, :, 0] = np.nan
    mask = np.ones_like(iv, bool)
    mask[:, :, 0] = False
    out = fit_eval_ah_surface(jnp.asarray(k_bad), jnp.asarray(iv_bad),
                              jnp.asarray(T), n_grid=257, n_iters=12,
                              quote_mask=jnp.asarray(mask))
    assert np.isfinite(np.asarray(out["fit_rmse"])).all()
    assert float(np.asarray(out["fit_rmse"]).max()) < 1e-5
    assert np.isfinite(np.asarray(out["fit"].c)).all()
    # grid bounded by the real strikes (plus pad), not the sentinel
    assert np.asarray(out["fit"].x).min() > -9.0 + 5.0
    assert np.asarray(out["butterfly_ok"]).all()
    assert np.asarray(out["calendar_ok"]).all()


def test_normalized_call_limits():
    k = jnp.asarray([-5.0, 0.0, 5.0])
    w = jnp.asarray([0.04, 0.04, 0.04])
    c = np.asarray(normalized_call(k, w))
    assert abs(c[0] - (1 - np.exp(-5.0))) < 1e-10   # deep ITM intrinsic
    assert c[2] < 1e-10                              # deep OTM zero
    # zero variance -> intrinsic exactly
    c0 = np.asarray(normalized_call(k, jnp.zeros(3)))
    np.testing.assert_allclose(c0, np.maximum(1 - np.exp(np.asarray(k)), 0))


def test_density_diagnostics_scale_parity():
    """The step-identity density and the divided-difference density
    measure the SAME quantity, d2C/dK2: (I - dt*A)c = c_prev gives
    A c = (c - c_prev)/dt exactly, and A's interior rows ARE the
    divided differences times sig2 K^2/2 — so at x64 the two must agree
    to rounding on interior columns (round-3 advisor: they disagreed by
    exactly 2x before the convention fix)."""
    k, iv, T = _chain()
    out = fit_eval_ah_surface(jnp.asarray(k), jnp.asarray(iv),
                              jnp.asarray(T), n_grid=129, n_iters=12)
    c = out["fit"].c                                   # (B, E, n)
    x = jnp.broadcast_to(out["fit"].x[:, None, :], c.shape)
    dd = np.asarray(_price_space_density(c, x))        # (B, E, n-2)
    g_int = np.asarray(out["g"])[..., 1:-1]            # same columns
    scale = np.abs(dd).max()
    np.testing.assert_allclose(g_int, dd, rtol=1e-6, atol=1e-9 * scale)
