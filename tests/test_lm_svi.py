"""Levenberg-Marquardt and SVI calibration tests.

LM is checked against scipy.optimize.least_squares solutions; SVI fits
must recover known ground-truth parameters from clean slices and achieve
small residuals on noisy ones (batched over surfaces x expiries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import least_squares

from iv_engine.ops.lm import (
    levenberg_marquardt,
    levenberg_marquardt_batched,
)
from iv_engine.ops.svi import (
    fit_svi,
    fit_svi_batched,
    svi_g,
    svi_init,
    svi_is_butterfly_free,
    svi_total_variance,
)


def test_lm_exponential_fit_matches_scipy(rng):
    t = np.linspace(0, 3, 40)
    true = np.array([2.5, 1.3, 0.4])
    y = true[0] * np.exp(-true[1] * t) + true[2]

    def resid_np(p):
        return p[0] * np.exp(-p[1] * t) + p[2] - y

    def resid_jx(p, t_, y_):
        return p[0] * jnp.exp(-p[1] * t_) + p[2] - y_

    p0 = np.array([1.0, 1.0, 0.0])
    ref = least_squares(resid_np, p0, method="lm")
    got = levenberg_marquardt(resid_jx, jnp.array(p0), jnp.array(t),
                              jnp.array(y), max_iters=100)
    np.testing.assert_allclose(np.asarray(got.params), ref.x, atol=1e-8)
    assert float(got.cost) < 1e-16


def test_lm_respects_bounds():
    def resid(p, x):
        return p - x  # optimum at p = x

    target = jnp.array([5.0, -5.0])
    got = levenberg_marquardt(resid, jnp.array([0.0, 0.0]), target,
                              lower=jnp.array([-1.0, -1.0]),
                              upper=jnp.array([1.0, 1.0]), max_iters=50)
    np.testing.assert_allclose(np.asarray(got.params), [1.0, -1.0], atol=1e-10)


def test_lm_batched(rng):
    B = 16
    t = np.linspace(0, 2, 30)
    trues = rng.uniform(0.5, 2.0, (B, 3))
    ys = trues[:, :1] * np.exp(-trues[:, 1:2] * t) + trues[:, 2:3]

    def resid(p, t_, y_):
        return p[0] * jnp.exp(-p[1] * t_) + p[2] - y_

    p0 = jnp.ones((B, 3))
    got = levenberg_marquardt_batched(
        resid, p0, jnp.broadcast_to(jnp.array(t), (B, 30)), jnp.array(ys),
        max_iters=100)
    np.testing.assert_allclose(np.asarray(got.params), trues, atol=1e-6)


TRUE_SVI = np.array([0.04, 0.4, -0.4, 0.05, 0.3])  # (a, b, rho, m, sigma)


def test_svi_recovers_ground_truth():
    k = jnp.linspace(-1.0, 1.0, 50)
    w = svi_total_variance(jnp.array(TRUE_SVI), k)
    fit = fit_svi(k, w, max_iters=200)
    assert float(fit.cost) < 1e-16
    np.testing.assert_allclose(np.asarray(fit.params), TRUE_SVI, atol=1e-4)


def test_svi_noisy_fit_small_residual(rng):
    k = jnp.linspace(-1.5, 1.5, 50)
    w_clean = svi_total_variance(jnp.array(TRUE_SVI), k)
    noise = 1e-4 * rng.normal(size=50)
    fit = fit_svi(k, w_clean + jnp.array(noise), max_iters=200)
    resid = svi_total_variance(fit.params, k) - w_clean
    assert float(jnp.max(jnp.abs(resid))) < 1e-3


def test_svi_batched_30_slices(rng):
    B, E, n = 4, 30, 50
    params = np.tile(TRUE_SVI, (B, E, 1))
    params[..., 0] += rng.uniform(0, 0.02, (B, E))   # vary a
    params[..., 3] += rng.uniform(-0.1, 0.1, (B, E))  # vary m
    k = jnp.broadcast_to(jnp.linspace(-1.0, 1.0, n), (B, E, n))
    w = svi_total_variance(jnp.array(params), k)
    fit = fit_svi_batched(k, w, max_iters=150)
    assert fit.params.shape == (B, E, 5)
    w_fit = svi_total_variance(fit.params, k)
    np.testing.assert_allclose(np.asarray(w_fit), np.asarray(w), atol=1e-5)


def test_svi_g_nonneg_for_sane_params():
    k = jnp.linspace(-2, 2, 200)
    assert bool(svi_is_butterfly_free(jnp.array(TRUE_SVI), k))


def test_svi_g_detects_arbitrage():
    # Extreme params that violate butterfly no-arbitrage
    bad = jnp.array([-0.01, 2.0, 0.99, 0.0, 0.01])
    k = jnp.linspace(-2, 2, 200)
    assert not bool(svi_is_butterfly_free(bad, k))


@pytest.mark.slow
def test_svi_g_matches_finite_differences():
    """g(k) uses closed-form w', w''; verify against autodiff."""
    params = jnp.array(TRUE_SVI)
    k = jnp.linspace(-1, 1, 21)
    w_fn = lambda kk: svi_total_variance(params, kk[None]).squeeze()
    w = jax.vmap(w_fn)(k)
    w1 = jax.vmap(jax.grad(w_fn))(k)
    w2 = jax.vmap(jax.grad(jax.grad(w_fn)))(k)
    expected = (1 - k * w1 / (2 * w)) ** 2 - (w1**2 / 4) * (1 / w + 0.25) + w2 / 2
    got = svi_g(params, k)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expected), atol=1e-10)


def test_svi_butterfly_penalty_restores_no_arb(rng):
    """Fit to arbitrageable data with penalty on: result must be
    butterfly-free on the grid."""
    k = jnp.linspace(-1.0, 1.0, 50)
    bad = jnp.array([-0.005, 1.2, 0.95, 0.0, 0.05])
    w_bad = jnp.maximum(svi_total_variance(bad, k), 1e-6)
    g_free = svi_g(fit_svi(k, w_bad, max_iters=200).params, k)
    assert float(jnp.min(g_free)) < -1.0  # unconstrained fit keeps the arb
    fit = fit_svi(k, w_bad, max_iters=200, butterfly_penalty=100.0)
    g = svi_g(fit.params, k)
    # soft penalty: violation shrinks ~1/weight; 100x weight -> <=1e-3
    assert float(jnp.min(g)) > -1e-3


def test_vega_weights_shape_and_peak():
    from iv_engine.ops.svi import vega_weights
    k = jnp.linspace(-1.5, 1.5, 31)
    w = jnp.full(31, 0.09)
    wt = vega_weights(k, w)
    # peak near d1=0 -> k = w/2 ~ 0.045, i.e. just right of ATM
    assert int(jnp.argmax(wt)) in (15, 16)
    assert float(jnp.mean(wt)) == pytest.approx(1.0, rel=1e-6)


def test_vega_weighted_fit_prioritises_atm(rng):
    from iv_engine.surface.surface import fit_surface
    from iv_engine.ops.svi import svi_total_variance
    B, E, n = 1, 2, 50
    p = jnp.tile(jnp.array([0.04, 0.4, -0.4, 0.05, 0.3]), (B, E, 1))
    k = jnp.broadcast_to(jnp.linspace(-1.5, 1.5, n), (B, E, n))
    w = svi_total_variance(p, k)
    # corrupt the far wings heavily
    noise = jnp.zeros((B, E, n)).at[..., :4].set(0.05).at[..., -4:].set(-0.02)
    w_noisy = jnp.maximum(w + noise, 1e-6)
    T = jnp.broadcast_to(jnp.array([0.5, 1.0]), (B, E))
    iv_noisy = jnp.sqrt(w_noisy / T[..., None])
    atm = slice(20, 30)
    errs = {}
    for weighting in ("uniform", "vega"):
        fit = fit_surface(k, iv_noisy, T, method="svi", svi_iters=150,
                          svi_weighting=weighting)
        w_fit = svi_total_variance(fit.coefs, k)
        errs[weighting] = float(jnp.mean(jnp.abs(w_fit - w)[..., atm]))
    assert errs["vega"] < errs["uniform"]


@pytest.mark.slow
def test_quasi_init_beats_heuristic_on_hard_slice(rng):
    """Quasi-explicit initialisation (grid over (m, sigma) + linear solve)
    must start closer than the heuristic on a skewed, wide-wing slice and
    let LM converge with fewer iterations."""
    from iv_engine.ops.svi import svi_quasi_init
    hard = jnp.array([0.002, 0.9, 0.85, -0.6, 0.05])  # strong skew, sharp
    k = jnp.linspace(-1.5, 1.5, 60)
    w = svi_total_variance(hard, k)

    def start_cost(p0):
        r = svi_total_variance(p0, k) - w
        return float(jnp.sum(r * r))

    from iv_engine.ops.svi import svi_init
    assert start_cost(svi_quasi_init(k, w)) < start_cost(svi_init(k, w))

    fit_q = fit_svi_batched(k[None], w[None], max_iters=30, init="quasi")
    fit_h = fit_svi_batched(k[None], w[None], max_iters=30)
    assert float(fit_q.cost[0]) <= float(fit_h.cost[0])
    assert float(fit_q.cost[0]) < 1e-10


def test_quasi_init_recovers_clean_slice():
    """The initializer alone should already track the curve closely
    (SVI params are degenerate — (m, sigma) trade off against (a, b, rho)
    — so assert curve-level error, not parameter recovery)."""
    from iv_engine.ops.svi import svi_quasi_init
    k = jnp.linspace(-1.0, 1.0, 50)
    w = svi_total_variance(jnp.array(TRUE_SVI), k)
    p0 = svi_quasi_init(k, w)
    w0 = svi_total_variance(p0, k)
    assert float(jnp.max(jnp.abs(w0 - w))) < 0.05 * float(jnp.max(w))


@pytest.mark.parametrize("seed", range(5))
def test_svi_fuzz_random_params(seed):
    """Random admissible SVI params round-trip through quasi-init + LM."""
    r = np.random.default_rng(2000 + seed)
    p_true = jnp.array([
        r.uniform(0.001, 0.1),   # a
        r.uniform(0.05, 0.8),    # b
        r.uniform(-0.9, 0.9),    # rho
        r.uniform(-0.5, 0.5),    # m
        r.uniform(0.05, 0.8),    # sigma
    ])
    k = jnp.linspace(-1.5, 1.5, 50)
    w = svi_total_variance(p_true, k)
    fit = fit_svi_batched(k[None], w[None], max_iters=150, init="quasi")
    w_fit = svi_total_variance(fit.params[0], k)
    np.testing.assert_allclose(np.asarray(w_fit), np.asarray(w), atol=5e-6,
                               err_msg=f"seed={seed}: {np.asarray(p_true)}")


@pytest.mark.slow
def test_huber_loss_resists_outlier_quote(rng):
    """One poisoned quote in a smile: the least-squares fit is dragged
    (wing/level distortion), the pseudo-Huber fit stays near truth."""
    import jax.numpy as jnp
    from iv_engine.ops.svi import (fit_svi_batched,
                                   svi_total_variance)
    n = 25
    k = np.linspace(-1.0, 1.0, n)
    p_true = jnp.asarray([0.04, 0.12, -0.3, 0.05, 0.2])
    w = np.asarray(svi_total_variance(p_true, jnp.asarray(k)))
    w_bad = w.copy()
    w_bad[3] *= 3.0  # fat-fingered quote
    kb = jnp.asarray(k)[None]
    wb = jnp.asarray(w_bad)[None]
    ls = fit_svi_batched(kb, wb, max_iters=64, init="quasi")
    hu = fit_svi_batched(kb, wb, max_iters=64, init="quasi",
                         loss="huber", huber_delta=1e-3)
    w_clean = jnp.asarray(w)[None]
    err_ls = float(jnp.sqrt(jnp.mean(
        (svi_total_variance(ls.params, kb) - w_clean) ** 2)))
    err_hu = float(jnp.sqrt(jnp.mean(
        (svi_total_variance(hu.params, kb) - w_clean) ** 2)))
    assert err_hu < err_ls / 5, (err_ls, err_hu)
    assert err_hu < 5e-4


def test_robustify_matches_linear_for_small_residuals():
    """Below the Huber scale the robust residual is ~identical to the
    raw residual (quadratic regime), so clean fits are unchanged."""
    import jax.numpy as jnp
    from iv_engine.ops.lm import robustify
    f = lambda p: p * jnp.asarray([1e-6, -3e-6, 2e-7])
    rf = robustify(f, delta=1e-3)
    r = np.asarray(f(jnp.asarray(1.0)))
    rr = np.asarray(rf(jnp.asarray(1.0)))
    np.testing.assert_allclose(rr, r, rtol=1e-5)
    # smooth at zero: jacfwd finite and ~identity scale
    import jax
    J = np.asarray(jax.jacfwd(rf)(jnp.asarray(0.0)))
    np.testing.assert_allclose(J, np.asarray([1e-6, -3e-6, 2e-7]),
                               rtol=1e-5)


@pytest.mark.slow
def test_essvi_huber_loss_smoke(rng):
    from iv_engine.ops.essvi import essvi_w, fit_essvi
    E, n = 4, 15
    k = jnp.broadcast_to(jnp.linspace(-0.8, 0.8, n), (E, n))
    theta = jnp.cumsum(jnp.asarray(rng.uniform(0.02, 0.05, E)))
    w = theta[:, None] * (1.0 + 0.1 * np.asarray(k) ** 2)
    fit = fit_essvi(k, jnp.asarray(w), max_iters=48, loss="huber",
                    huber_delta=1e-3)
    w_fit = essvi_w(fit.params, k)
    assert float(jnp.sqrt(jnp.mean((w_fit - w) ** 2))) < 2e-3
