"""RBF surface fitting parity vs scipy.interpolate.RBFInterpolator."""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.interpolate import RBFInterpolator

from iv_engine.ops.rbf import eval_rbf, fit_eval_rbf_batched, fit_rbf


def _scattered_quotes(rng, n):
    """Scattered (log-moneyness, maturity) quotes with a smooth vol surface."""
    k = rng.uniform(-1.0, 1.0, n)
    T = rng.uniform(0.05, 2.0, n)
    w = (0.04 + 0.3 * k**2) * T  # smile * maturity -> total variance
    w += 1e-4 * rng.normal(size=n)
    return np.stack([k, T], axis=1), w


@pytest.mark.parametrize("smoothing", [0.0, 1e-6, 1e-3])
def test_thin_plate_matches_scipy(rng, smoothing):
    pts, w = _scattered_quotes(rng, 200)
    q, _ = _scattered_quotes(rng, 50)
    fit = fit_rbf(jnp.array(pts), jnp.array(w), smoothing=smoothing)
    got = eval_rbf(fit, jnp.array(q))
    ref = RBFInterpolator(pts, w, kernel="thin_plate_spline",
                          smoothing=smoothing)(q)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-8)


def test_gaussian_matches_scipy(rng):
    pts, w = _scattered_quotes(rng, 150)
    q, _ = _scattered_quotes(rng, 40)
    fit = fit_rbf(jnp.array(pts), jnp.array(w), smoothing=1e-10,
                  kernel="gaussian", epsilon=2.0)
    got = eval_rbf(fit, jnp.array(q), kernel="gaussian", epsilon=2.0)
    ref = RBFInterpolator(pts, w, kernel="gaussian", epsilon=2.0,
                          smoothing=1e-10)(q)
    np.testing.assert_allclose(np.asarray(got), ref, atol=1e-7)


def test_multiquadric_matches_scipy(rng):
    pts, w = _scattered_quotes(rng, 150)
    q, _ = _scattered_quotes(rng, 40)
    fit = fit_rbf(jnp.array(pts), jnp.array(w), kernel="multiquadric",
                  epsilon=1.5)
    got = eval_rbf(fit, jnp.array(q), kernel="multiquadric", epsilon=1.5)
    ref = RBFInterpolator(pts, w, kernel="multiquadric", epsilon=1.5)(q)
    # multiquadric Gram systems are ill-conditioned (~1e9); LU pivoting
    # differences between LAPACK and XLA show up at ~2e-8 on extrapolated
    # queries, so the bound here is looser than the 1e-8 used elsewhere.
    np.testing.assert_allclose(np.asarray(got), ref, atol=5e-8)


def test_interpolates_exactly_at_sites(rng):
    pts, w = _scattered_quotes(rng, 100)
    fit = fit_rbf(jnp.array(pts), jnp.array(w), smoothing=0.0)
    got = eval_rbf(fit, jnp.array(pts))
    np.testing.assert_allclose(np.asarray(got), w, atol=1e-8)


def test_batched(rng):
    B, n, m = 4, 120, 30
    pts = np.stack([_scattered_quotes(rng, n)[0] for _ in range(B)])
    ws = np.stack([0.04 + 0.3 * p[:, 0] ** 2 * p[:, 1] for p in pts])
    qs = pts[:, :m, :]
    got = np.asarray(fit_eval_rbf_batched(jnp.array(pts), jnp.array(ws),
                                          jnp.array(qs)))
    for i in range(B):
        ref = RBFInterpolator(pts[i], ws[i], kernel="thin_plate_spline")(qs[i])
        np.testing.assert_allclose(got[i], ref, atol=1e-8)


def _arb_quotes(rng, n, wiggle=0.02):
    """Scattered quotes whose total variance carries butterfly arbitrage
    (high-frequency wiggles) but is calendar-clean in expectation."""
    k = rng.uniform(-1.0, 1.0, n)
    T = rng.uniform(0.05, 2.0, n)
    w = (0.04 + 0.3 * k**2) * T + wiggle * np.sin(8 * k) * T
    return np.stack([k, T], axis=1), w


def test_arbfree_zero_penalty_matches_scipy_2048(rng):
    """North-star config #4 scale: 2,048 scattered quotes. At zero
    penalty weights the stationarity of the penalized objective reduces
    to SciPy's smoothing-RBF system (see ops/rbf.py derivation), so one
    Gauss-Newton step must reproduce RBFInterpolator."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 2048)
    q, _ = _scattered_quotes(rng, 64)
    fit = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-6,
                          butterfly_weight=0.0, calendar_weight=0.0)
    got = eval_rbf(fit, jnp.array(q))
    ref = RBFInterpolator(pts, w, kernel="thin_plate_spline",
                          smoothing=1e-6)(q)
    np.testing.assert_allclose(np.asarray(got), ref, atol=5e-7)


def test_arbfree_penalty_clears_flags(rng):
    """Arbitrage-laden quotes: the plain fit flags butterfly violations;
    the penalized fit is arbitrage-free on the penalty grid while still
    fitting the (arbitrageable) data to within the wiggle amplitude."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _arb_quotes(rng, 512)
    plain = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-8,
                            butterfly_weight=0.0, calendar_weight=0.0)
    assert not bool(plain["butterfly_ok"])  # the data IS arbitrageable

    fit = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-8,
                          n_iters=32)  # default weights/margins
    assert bool(fit["butterfly_ok"]) and bool(fit["calendar_ok"])
    assert float(fit["pen_g"].min()) >= -1e-8
    dw = np.diff(np.asarray(fit["pen_w"]), axis=0)
    assert dw.min() >= -1e-10
    got = np.asarray(eval_rbf(fit, jnp.array(pts)))
    rmse = float(np.sqrt(np.mean((got - w) ** 2)))
    assert rmse < 0.08  # de-arbitraged, not collapsed


@pytest.mark.slow
def test_arbfree_penalty_2048_sites(rng):
    """Full production scale: 2,048 quotes, penalties on — flags green."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _arb_quotes(rng, 2048, wiggle=0.01)
    fit = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-8,
                          n_iters=24)
    assert bool(fit["butterfly_ok"]) and bool(fit["calendar_ok"])


def test_arbfree_weights_drop_padding(rng):
    """weight-0 quotes must not perturb the fit: garbage values on
    padded rows give the same surface as the unpadded fit (to solver
    tolerance)."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 200)
    q, _ = _scattered_quotes(rng, 40)
    base = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-4,
                           butterfly_weight=0.0, calendar_weight=0.0)
    w_base = np.asarray(eval_rbf(base, jnp.array(q)))
    # append garbage quotes with weight 0 (coordinates inside the box so
    # the penalty grid is unchanged)
    pad_pts = np.stack([rng.uniform(-0.9, 0.9, 32),
                        rng.uniform(0.1, 1.9, 32)], axis=1)
    pts2 = np.concatenate([pts, pad_pts])
    w2 = np.concatenate([w, np.full(32, 17.0)])
    wts = np.concatenate([np.ones(200), np.zeros(32)])
    padded = fit_rbf_arbfree(jnp.array(pts2), jnp.array(w2),
                             weights=jnp.array(wts), smoothing=1e-4,
                             butterfly_weight=0.0, calendar_weight=0.0)
    w_pad = np.asarray(eval_rbf(padded, jnp.array(q)))
    np.testing.assert_allclose(w_pad, w_base, atol=1e-4)


def test_arbfree_nonbinary_weights_match_direct_path(rng):
    """Non-binary weights: the penalized Gauss-Newton path (with a
    vanishing hinge weight) must optimise the SAME sum w_i r_i^2
    objective as the zero-penalty direct saddle solve. The old code
    squared pre-multiplied w*r (a w^2-weighted objective), diverging
    from the direct path by ~2% of typical w at smoothing=1e-2
    (round-3 review finding)."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 160)
    wts = np.where(np.arange(160) % 2 == 0, 3.0, 1.0)
    q, _ = _scattered_quotes(rng, 50)
    direct = fit_rbf_arbfree(jnp.array(pts), jnp.array(w),
                             weights=jnp.array(wts), smoothing=1e-2,
                             butterfly_weight=0.0, calendar_weight=0.0)
    gn = fit_rbf_arbfree(jnp.array(pts), jnp.array(w),
                         weights=jnp.array(wts), smoothing=1e-2,
                         butterfly_weight=1e-12, calendar_weight=0.0,
                         n_iters=32)
    w_direct = np.asarray(eval_rbf(direct, jnp.array(q)))
    w_gn = np.asarray(eval_rbf(gn, jnp.array(q)))
    np.testing.assert_allclose(w_gn, w_direct, atol=2e-4)


def test_arbfree_padding_outside_box_is_inert(rng):
    """Weight-0 sites OUTSIDE the live quotes' range (how the pipeline
    pads strike ladders) must not stretch the penalty grid and their
    centers must stay pinned even with the hinge on (round-3 review
    findings: the bbox used all points, and padded centers were free
    basis functions in the penalized path)."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _arb_quotes(rng, 256)
    pad_pts = np.stack([rng.uniform(4.0, 9.0, 32),       # far outside
                        rng.uniform(5.0, 9.0, 32)], axis=1)
    pts2 = np.concatenate([pts, pad_pts])
    w2 = np.concatenate([w, np.full(32, 17.0)])
    wts = np.concatenate([np.ones(256), np.zeros(32)])
    fit = fit_rbf_arbfree(jnp.array(pts2), jnp.array(w2),
                          weights=jnp.array(wts), smoothing=1e-8,
                          n_iters=32)
    # penalty grid spans the LIVE quotes only
    assert float(fit["pen_k_grid"].max()) <= float(pts[:, 0].max()) + 1e-6
    assert float(fit["pen_t_grid"].max()) <= float(pts[:, 1].max()) + 1e-6
    # padded centers pinned to ~0 even with the hinge active
    assert float(np.abs(np.asarray(fit["coef"])[256:]).max()) < 1e-3
    assert bool(fit["butterfly_ok"]) and bool(fit["calendar_ok"])


def test_arbfree_degenerate_strike_range_is_finite(rng):
    """All live quotes at ONE strike: h_k would be 0 (NaN stencils, the
    zero surface returned silently). The guard keeps outputs finite."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    T = rng.uniform(0.05, 2.0, 64)
    pts = np.stack([np.zeros(64), T], axis=1)
    w = 0.04 * T
    fit = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-6,
                          n_iters=8)
    assert np.isfinite(np.asarray(fit["coef"])).all()
    assert np.isfinite(np.asarray(fit["pen_w"])).all()
    got = np.asarray(eval_rbf(fit, jnp.array(pts)))
    assert np.isfinite(got).all()


def test_arbfree_unknown_kernel_raises_value_error():
    from iv_engine.ops.rbf import fit_rbf_arbfree

    with pytest.raises(ValueError, match="unknown RBF kernel"):
        fit_rbf_arbfree(jnp.zeros((8, 2)), jnp.zeros(8), kernel="cubic")


# ------------------------------------------------------------ reduced basis
def test_arbfree_reduced_centers_tracks_full_fit(rng):
    """Least-squares RBF (n_centers = N/4) on smooth quotes: the reduced
    surface must track the full every-site-a-center fit to within the
    basis approximation error (measured ~3e-3 RMS at c=128 over 512
    sites of this surface family; the full fit sits at the 1e-4 noise
    floor — the 13x solve speedup trades exactly this gap)."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 512)
    q, _ = _scattered_quotes(rng, 200)
    full = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-6,
                           butterfly_weight=0.0, calendar_weight=0.0)
    red = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-6,
                          butterfly_weight=0.0, calendar_weight=0.0,
                          n_centers=128)
    assert red["coef"].shape == (128,)
    got_f = np.asarray(eval_rbf(full, jnp.array(q)))
    got_r = np.asarray(eval_rbf(red, jnp.array(q)))
    dev = np.abs(got_f - got_r)
    # deviation concentrates at the quote-box corners (least-squares
    # RBF has no centers beyond the hull edge; measured ~0.04 at the
    # (k=-1, T=2) corner, flat in c) — the INTERIOR, where the pipeline
    # evaluates, tracks tightly
    interior = ((np.abs(q[:, 0]) < 0.8)
                & (q[:, 1] > 0.25) & (q[:, 1] < 1.8))
    assert float(dev[interior].max()) < 2e-2
    assert float(np.sqrt(np.mean(dev ** 2))) < 1e-2
    # data-term quality: reduced fit reproduces the quotes to the
    # basis approximation error (verified against an unconstrained
    # numpy lstsq on the same 131-column basis: 1.9e-3)
    at_sites = np.asarray(eval_rbf(red, jnp.array(pts)))
    assert float(np.sqrt(np.mean((at_sites - w) ** 2))) < 6e-3


def test_arbfree_reduced_centers_clears_flags(rng):
    """The hinge machinery is basis-agnostic: arbitrage-laden quotes are
    repaired with the reduced basis too."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _arb_quotes(rng, 512)
    fit = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-8,
                          n_iters=32, n_centers=128)
    assert bool(fit["butterfly_ok"]) and bool(fit["calendar_ok"])
    got = np.asarray(eval_rbf(fit, jnp.array(pts)))
    assert float(np.sqrt(np.mean((got - w) ** 2))) < 0.08


def test_arbfree_reduced_centers_skip_padding(rng):
    """Centers are rank-strided over LIVE sites only: garbage weight-0
    padding (inside the box, extreme values) must not change the reduced
    fit, exactly like the full path's padding test."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 256)
    base = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-4,
                           weights=jnp.ones(256), n_iters=8, n_centers=64)
    pad_pts = np.stack([rng.uniform(-0.9, 0.9, 64),
                        rng.uniform(0.1, 1.9, 64)], axis=1)
    pts2 = np.concatenate([pts, pad_pts])
    w2 = np.concatenate([w, np.full(64, 37.0)])
    wts2 = jnp.concatenate([jnp.ones(256), jnp.zeros(64)])
    padded = fit_rbf_arbfree(jnp.array(pts2), jnp.array(w2), weights=wts2,
                             smoothing=1e-4, n_iters=8, n_centers=64)
    q, _ = _scattered_quotes(rng, 100)
    got_b = np.asarray(eval_rbf(base, jnp.array(q)))
    got_p = np.asarray(eval_rbf(padded, jnp.array(q)))
    np.testing.assert_allclose(got_p, got_b, atol=5e-4)


def test_arbfree_single_slice_penalty_grid(rng):
    """n_pen_t=1 (single-expiry bucket) must work with the calendar
    penalty off — it used to ZeroDivisionError at trace time on the
    unconditional 1/((n_pen_t-1)*n_pen_k) — and raise a descriptive
    error when a calendar penalty is requested (round-4 review)."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 96)
    fit = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), smoothing=1e-4,
                          n_iters=4, n_pen_t=1, calendar_weight=0.0)
    assert np.isfinite(np.asarray(fit["coef"])).all()
    assert fit["pen_w"].shape[0] == 1
    with pytest.raises(ValueError, match="calendar"):
        fit_rbf_arbfree(jnp.array(pts), jnp.array(w), n_pen_t=1,
                        calendar_weight=1.0)
    with pytest.raises(ValueError, match="penalty grid"):
        fit_rbf_arbfree(jnp.array(pts), jnp.array(w), n_pen_k=2)


def test_arbfree_zero_centers_means_exact_path(rng):
    """n_centers=0 follows the config's '0 disables' convention: the
    exact full-center fit, bitwise-equal to n_centers=None. Before the
    round-4 review fix, 0 entered the reduced path with a ZERO-center
    basis and silently fit a polynomial-only plane."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 96)
    exact = fit_rbf_arbfree(jnp.array(pts), jnp.array(w),
                            smoothing=1e-4, n_iters=4, n_centers=None)
    zero = fit_rbf_arbfree(jnp.array(pts), jnp.array(w),
                           smoothing=1e-4, n_iters=4, n_centers=0)
    np.testing.assert_array_equal(np.asarray(exact["coef"]),
                                  np.asarray(zero["coef"]))


def test_arbfree_more_centers_than_live_sites_is_finite(rng):
    """n_centers > live count duplicates ranks; the reduced-path ridge
    must keep the (rank-deficient) normal equations finite."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 96)
    wts = jnp.concatenate([jnp.ones(32), jnp.zeros(64)])
    fit = fit_rbf_arbfree(jnp.array(pts), jnp.array(w), weights=wts,
                          smoothing=1e-6, n_centers=64,
                          butterfly_weight=0.0, calendar_weight=0.0)
    assert np.isfinite(np.asarray(fit["coef"])).all()
    got = np.asarray(eval_rbf(fit, jnp.array(pts[:32])))
    assert np.isfinite(got).all()
    assert float(np.sqrt(np.mean((got - w[:32]) ** 2))) < 5e-3


def test_arbfree_reduced_centers_f32(rng):
    """Device regime: the reduced path must survive float32 — the
    un-ridged normal equations measured cond ~8e9 (NaN f32 Cholesky);
    the 1e-6-relative ridge floor keeps both the direct solve and the
    penalized LM finite and accurate."""
    from iv_engine.ops.rbf import fit_rbf_arbfree

    pts, w = _scattered_quotes(rng, 512)
    red = fit_rbf_arbfree(jnp.asarray(pts, jnp.float32),
                          jnp.asarray(w, jnp.float32), smoothing=1e-6,
                          butterfly_weight=0.0, calendar_weight=0.0,
                          n_centers=128)
    assert red["coef"].dtype == jnp.float32
    at = np.asarray(eval_rbf(red, jnp.asarray(pts, jnp.float32)))
    assert np.isfinite(at).all()
    assert float(np.sqrt(np.mean((at - w) ** 2))) < 8e-3

    pts2, w2 = _arb_quotes(rng, 512)
    fit = fit_rbf_arbfree(jnp.asarray(pts2, jnp.float32),
                          jnp.asarray(w2, jnp.float32), smoothing=1e-8,
                          n_iters=32, n_centers=128)
    assert np.isfinite(np.asarray(fit["pen_w"])).all()
    assert bool(fit["butterfly_ok"]) and bool(fit["calendar_ok"])
