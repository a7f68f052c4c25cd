"""eSSVI global surface calibration (ops.essvi).

Coverage: closed-form derivative parity (autodiff oracle), transform
guarantees (every iterate butterfly-free + theta increasing), round-trip
recovery of known surfaces, calendar repair on deliberately crossing
input slices, and the surface-API integration (method='essvi')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine.ops.essvi import (
    EssviFit,
    _transform,
    essvi_g,
    essvi_init,
    essvi_w,
    essvi_w_derivs,
    fit_essvi,
    fit_essvi_batched,
    psi_butterfly_cap,
)
from iv_engine.surface.surface import fit_eval_surface, fit_surface


@pytest.fixture
def rng():
    return np.random.default_rng(20260816)


def _mk_surface(rng, E=6, n=21, B=None, consistent=True):
    """Random admissible eSSVI params + sampled (k, w).

    ``consistent=True`` draws calendar-consistent surfaces (constant rho
    per surface, psi growing with the butterfly cap — the
    Hendriks-Martini same-rho sufficient condition theta up + psi up);
    ``consistent=False`` draws per-slice rho freely, so slices may cross
    off-ATM (calendar arbitrage IN the data)."""
    shape = (E,) if B is None else (B, E)
    theta = np.cumsum(rng.uniform(0.01, 0.05, shape), axis=-1)
    if consistent:
        rho_shape = (1,) if B is None else (B, 1)
        rho = np.broadcast_to(rng.uniform(-0.6, 0.6, rho_shape),
                              shape).copy()
        frac = np.broadcast_to(rng.uniform(0.2, 0.7, rho_shape),
                               shape).copy()
    else:
        rho = rng.uniform(-0.6, 0.6, shape)
        frac = rng.uniform(0.2, 0.7, shape)
    psi = (np.asarray(psi_butterfly_cap(jnp.asarray(theta),
                                        jnp.asarray(rho))) * frac)
    params = jnp.asarray(np.stack([theta, rho, psi], axis=-1))
    k = np.broadcast_to(np.linspace(-1.0, 1.0, n), shape + (n,)).copy()
    w = essvi_w(params, jnp.asarray(k))
    return params, jnp.asarray(k), w


@pytest.mark.slow
def test_derivs_match_autodiff(rng):
    params, k, _ = _mk_surface(rng)
    kq = jnp.asarray(np.linspace(-0.9, 0.9, 17))
    w, w1, w2 = essvi_w_derivs(params[2], kq)
    f = lambda x: essvi_w(params[2], x[None])[0]
    w1_ad = jax.vmap(jax.grad(f))(kq)
    w2_ad = jax.vmap(jax.grad(jax.grad(f)))(kq)
    np.testing.assert_allclose(np.asarray(w1), np.asarray(w1_ad),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(w2), np.asarray(w2_ad),
                               rtol=1e-4, atol=1e-6)


def test_atm_identities(rng):
    """w(0)=theta, w'(0)=rho*psi, w''(0)=psi^2(1-rho^2)/(2 theta)."""
    params, _, _ = _mk_surface(rng)
    k0 = jnp.zeros((1,))
    w, w1, w2 = essvi_w_derivs(params, k0)
    theta, rho, psi = params[..., 0], params[..., 1], params[..., 2]
    np.testing.assert_allclose(np.asarray(w[..., 0]), np.asarray(theta),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(w1[..., 0]),
                               np.asarray(rho * psi), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        np.asarray(w2[..., 0]),
        np.asarray(psi * psi * (1 - rho * rho) / (2 * theta)),
        rtol=1e-4, atol=1e-8)


def test_transform_guarantees(rng):
    """ANY z maps to increasing theta + butterfly-free slices — the
    property that makes every LM iterate admissible."""
    E = 8
    kg = jnp.asarray(np.linspace(-3.0, 3.0, 201))
    for _ in range(20):
        z = jnp.asarray(rng.normal(0, 3, 3 * E).astype(np.float32))
        p = _transform(z, E)
        theta = np.asarray(p[:, 0])
        assert np.all(np.diff(theta) > 0)
        assert np.all(np.abs(np.asarray(p[:, 1])) < 1.0)
        cap = np.asarray(psi_butterfly_cap(p[:, 0], p[:, 1]))
        assert np.all(np.asarray(p[:, 2]) <= cap + 1e-6)
        g = np.asarray(essvi_g(p, kg))
        assert g.min() > -1e-6, "slice must be butterfly-free"


def test_roundtrip_recovery(rng):
    """Exact calendar-consistent eSSVI data -> fit recovers the surface
    to high accuracy (penalty active but zero on consistent data)."""
    params, k, w = _mk_surface(rng)
    fit = fit_essvi(k, w, max_iters=96)
    w_fit = essvi_w(fit.params, k)
    rmse = float(jnp.sqrt(jnp.mean((w_fit - w) ** 2)))
    assert rmse < 5e-5, f"rmse={rmse:.2e}"
    # ATM variance (theta) is identified; recover it tightly
    np.testing.assert_allclose(np.asarray(fit.params[:, 0]),
                               np.asarray(params[:, 0]),
                               rtol=5e-3, atol=5e-5)


def test_roundtrip_free_rho_without_penalty(rng):
    """Per-slice rho data (slices may cross): with the calendar penalty
    OFF, the fit is E independent-in-effect slice problems and should
    still reproduce the quotes."""
    params, k, w = _mk_surface(rng, consistent=False)
    fit = fit_essvi(k, w, max_iters=96, calendar_weight=0.0)
    w_fit = essvi_w(fit.params, k)
    rmse = float(jnp.sqrt(jnp.mean((w_fit - w) ** 2)))
    assert rmse < 5e-4, f"rmse={rmse:.2e}"


@pytest.mark.slow
def test_batched_matches_single(rng):
    params, k, w = _mk_surface(rng, B=3)
    fb = fit_essvi_batched(k, w, max_iters=48)
    f0 = fit_essvi(k[1], w[1], max_iters=48)
    np.testing.assert_allclose(np.asarray(fb.params[1]),
                               np.asarray(f0.params), rtol=1e-5, atol=1e-7)


def test_noisy_fit_stays_arbitrage_free(rng):
    """Noisy quotes: the fitted surface keeps its structural guarantees
    even though the data does not satisfy them."""
    _, k, w = _mk_surface(rng, E=8, n=25)
    w_noisy = w + 2e-4 * jnp.asarray(rng.normal(size=w.shape))
    fit = fit_essvi(k, w_noisy, max_iters=64)
    theta = np.asarray(fit.params[:, 0])
    assert np.all(np.diff(theta) > 0)
    kg = jnp.asarray(np.linspace(-2.0, 2.0, 201))
    g = np.asarray(essvi_g(fit.params, kg))
    assert g.min() > -1e-6


def test_calendar_repair_on_crossing_slices(rng):
    """Input slices that CROSS (calendar arbitrage in the data): the
    eSSVI fit cannot reproduce the crossing at ATM (theta increasing by
    construction) and the penalty keeps the wings ordered too."""
    E, n = 4, 21
    k = np.broadcast_to(np.linspace(-0.8, 0.8, n), (E, n)).copy()
    # slice 2 sits BELOW slice 1 everywhere — blatant calendar arb
    base = np.array([0.04, 0.06, 0.03, 0.08])[:, None]
    w = base + 0.02 * k ** 2
    # the off-ATM ordering is a soft (hinge) constraint: measured
    # residual crossing vs calendar_weight: 1.5e-4 @ 10, 5.9e-6 @ 50,
    # 5.6e-8 @ 200 (ATM ordering is exact at ANY weight — theta is
    # increasing by construction)
    fit = fit_essvi(jnp.asarray(k), jnp.asarray(w), max_iters=96,
                    calendar_weight=200.0)
    kg = jnp.broadcast_to(jnp.asarray(np.linspace(-0.8, 0.8, 41)), (E, 41))
    w_fit = np.asarray(essvi_w(fit.params, kg))
    assert np.all(np.diff(w_fit, axis=0) >= -1e-6), \
        "fitted surface must not inherit the data's calendar arbitrage"
    # ATM: exact ordering regardless of the data
    theta = np.asarray(fit.params[:, 0])
    assert np.all(np.diff(theta) > 0)


@pytest.mark.slow
def test_surface_api_essvi(rng):
    """fit_eval_surface(method='essvi'): diagnostics clean on admissible
    data; maturity interpolation works via eval path."""
    params, k, w = _mk_surface(rng, E=6, n=21, B=2)
    T = jnp.asarray(np.broadcast_to(
        np.linspace(0.1, 1.1, 6), (2, 6)).copy())
    iv = jnp.sqrt(w / T[..., None])
    out = fit_eval_surface(k, iv, T, method="essvi", n_grid=33,
                           svi_iters=64)
    assert bool(jnp.all(out["butterfly_ok"]))
    assert bool(jnp.all(out["calendar_ok"]))
    # grid eval matches direct param eval
    w_direct = essvi_w(out["fit"].coefs, out["k_grid"])
    np.testing.assert_allclose(np.asarray(out["w_grid"]),
                               np.asarray(w_direct), rtol=1e-6)


def test_eval_surface_maturity_interp(rng):
    from iv_engine.surface.surface import eval_surface
    params, k, w = _mk_surface(rng, E=6, n=21, B=2)
    T = jnp.asarray(np.broadcast_to(
        np.linspace(0.1, 1.1, 6), (2, 6)).copy())
    iv = jnp.sqrt(w / T[..., None])
    fit = fit_surface(k, iv, T, method="essvi", svi_iters=64)
    kq = jnp.zeros((2, 5))
    Tq = jnp.asarray(np.broadcast_to(
        np.linspace(0.15, 1.0, 5), (2, 5)).copy())
    wq = eval_surface(fit, kq, Tq)
    # between slices, linear-in-w at fixed k: bounded by the brackets
    w_atm = fit.coefs[..., 0]  # theta per slice = ATM w
    assert float(jnp.min(wq)) >= float(jnp.min(w_atm)) - 1e-6
    assert float(jnp.max(wq)) <= float(jnp.max(w_atm)) + 1e-6
    # monotone in T at fixed k (theta increasing + linear interp)
    assert bool(jnp.all(jnp.diff(wq, axis=-1) >= -1e-7))


def test_init_reasonable(rng):
    """The quadratic-fit init lands close enough that LM converges in
    few iterations (guards against init regressions)."""
    params, k, w = _mk_surface(rng)
    z0 = essvi_init(k, w)
    E = k.shape[0]
    p0 = _transform(z0, E)
    w0 = essvi_w(p0, k)
    rel = float(jnp.sqrt(jnp.mean((w0 - w) ** 2))
                / jnp.sqrt(jnp.mean(w ** 2)))
    assert rel < 0.5, f"init rel err {rel:.2f}"


def test_essvi_slice_is_svi_slice(rng):
    """Every eSSVI slice is a raw-SVI slice under the closed-form map
    (a, b, rho, m, sigma) = (theta(1-rho^2)/2, psi/2, rho, -theta rho/psi,
    theta sqrt(1-rho^2)/psi) — cross-checks both models' w AND g."""
    from iv_engine.ops.svi import svi_g, svi_total_variance
    params, k, w = _mk_surface(rng, E=5, n=31)
    theta, rho, psi = params[..., 0], params[..., 1], params[..., 2]
    a = theta * (1 - rho**2) / 2
    b = psi / 2
    m = -theta * rho / psi
    sig = theta * jnp.sqrt(1 - rho**2) / psi
    svi_params = jnp.stack([a, b, rho, m, sig], axis=-1)  # (E, 5)
    w_svi = svi_total_variance(svi_params, k)
    np.testing.assert_allclose(np.asarray(w), np.asarray(w_svi),
                               rtol=1e-12, atol=1e-14)
    kg = jnp.asarray(np.linspace(-2.0, 2.0, 101))
    g_e = essvi_g(params, kg[None, :])
    g_s = svi_g(svi_params, kg[None, :])
    np.testing.assert_allclose(np.asarray(g_e), np.asarray(g_s),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.slow
def test_block_solver_matches_dense(rng):
    """solver='block' (slice-space block-tridiagonal GN) converges to
    the same fit as the dense ops.lm path: same rmse to float precision
    and all structural guarantees intact. The iterate paths differ
    (damping acts in different metrics) so parameters are compared by
    fit quality, not elementwise."""
    import jax.numpy as jnp
    import numpy as np
    from iv_engine.ops.essvi import (essvi_w, fit_essvi_batched,
                                     psi_butterfly_cap)

    B, E, n = 4, 10, 30
    k = jnp.broadcast_to(jnp.linspace(-1.0, 1.0, n), (B, E, n))
    theta = jnp.asarray(np.cumsum(rng.uniform(0.005, 0.03, (B, E)),
                                  axis=-1))
    rho = jnp.asarray(np.broadcast_to(rng.uniform(-0.5, 0.5, (B, 1)),
                                      (B, E)))
    psi = psi_butterfly_cap(theta, rho) * 0.4
    w = essvi_w(jnp.stack([theta, rho, psi], axis=-1), k)
    w = w + 1e-4 * jnp.asarray(rng.normal(size=(B, E, n)))

    fits = {s: fit_essvi_batched(k, w, max_iters=32, solver=s)
            for s in ("dense", "block")}
    rmse = {s: float(jnp.sqrt(jnp.mean((essvi_w(f.params, k) - w) ** 2)))
            for s, f in fits.items()}
    assert rmse["block"] < 1.5 * rmse["dense"] + 1e-6, rmse
    assert rmse["block"] < 5e-4
    th = np.asarray(fits["block"].params[..., 0])
    assert (np.diff(th, axis=-1) > 0).all()      # theta stays monotone
    cap = np.asarray(psi_butterfly_cap(fits["block"].params[..., 0],
                                       fits["block"].params[..., 1]))
    assert (np.asarray(fits["block"].params[..., 2]) <= cap + 1e-9).all()


def test_init_and_block_solver_survive_masked_garbage_slice(rng):
    """Round-3 review findings: (a) essvi_init ignored weights, so one
    masked slice of garbage w inflated its theta estimate and the
    running max dragged every LATER slice's init up with it; (b) a
    fully-masked slice gives a zero J^T J block whose lam*1e-12 damping
    underflows the f32 3x3 determinant -> NaN steps, every iteration
    rejected. Both paths must now fit the live slices cleanly."""
    E, n = 5, 15
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (E, n))
    theta = jnp.cumsum(jnp.asarray(rng.uniform(0.01, 0.04, E)))
    w = theta[:, None] * (1.0 + 0.08 * k * k)
    w_bad = w.at[2].set(50.0)                    # garbage placeholder
    wts = jnp.ones((E, n)).at[2].set(0.0)        # ... fully masked
    for solver in ("block", "dense"):
        fit = fit_essvi(k, w_bad, weights=wts, max_iters=48,
                        solver=solver)
        params = np.asarray(fit.params)
        assert np.isfinite(params).all(), solver
        assert int(fit.n_accepted) > 0, solver
        pred = np.asarray(essvi_w(fit.params, k))
        live = [0, 1, 3, 4]
        rmse = float(np.sqrt(np.mean(
            (pred[live] - np.asarray(w)[live]) ** 2)))
        assert rmse < 5e-3, (solver, rmse)
        # the masked slice's theta must NOT have been dragged to ~50
        assert params[2, 0] < 1.0, solver


def test_static_float_knobs_accept_numpy_scalars(rng):
    """calendar_weight/huber_delta are jit-static; numpy/JAX scalar
    values raised unhashable-static TypeErrors before the coercing
    wrappers (round-3 review finding)."""
    E, n = 3, 9
    k = jnp.broadcast_to(jnp.linspace(-0.5, 0.5, n), (2, E, n))
    theta = jnp.cumsum(jnp.asarray(rng.uniform(0.01, 0.04, (2, E))), -1)
    w = theta[..., None] * (1.0 + 0.1 * k * k)
    fit = fit_essvi_batched(k, w, max_iters=8,
                            calendar_weight=np.float32(10.0),
                            huber_delta=np.float64(1e-3))
    assert np.isfinite(np.asarray(fit.params)).all()


def test_penalty_grid_ignores_padded_sentinel_strikes(rng):
    """The calendar-penalty grid k_pen must span the QUOTED strike
    range: a zero-weight sentinel strike in the last column used to
    collapse min(k[..., -1]) and move the hinge off the quoted region
    (round-4 review). The padded fit must match the clean fit."""
    E, n = 4, 12
    k = jnp.broadcast_to(jnp.linspace(-0.6, 0.6, n), (E, n))
    theta = jnp.cumsum(jnp.asarray(rng.uniform(0.01, 0.04, E)))
    w = theta[:, None] * (1.0 + 0.1 * k * k)

    clean = fit_essvi(k, w, max_iters=48)

    # pad one extra column with a sentinel strike, weight 0
    k_pad = jnp.concatenate([k, jnp.full((E, 1), -999.0)], axis=-1)
    w_pad = jnp.concatenate([w, jnp.full((E, 1), 7.0)], axis=-1)
    wts = jnp.concatenate([jnp.ones((E, n)), jnp.zeros((E, 1))], axis=-1)
    padded = fit_essvi(k_pad, w_pad, weights=wts, max_iters=48)

    np.testing.assert_allclose(np.asarray(padded.params),
                               np.asarray(clean.params),
                               rtol=1e-4, atol=1e-6)
