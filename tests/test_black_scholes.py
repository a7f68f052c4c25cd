"""Black-Scholes Greeks parity vs the reference's SciPy formulas (<=1e-8)
plus an autodiff cross-check."""

import jax
import jax.numpy as jnp
import numpy as np
from scipy.stats import norm

from iv_engine.ops.black_scholes import bs_greeks, bs_price, implied_vol


def _reference_greeks(S, K, T, r, sigma, option_type):
    """The exact formulas at reference greeks.py:21-35 (NumPy/SciPy)."""
    d1 = (np.log(S / K) + (r + 0.5 * sigma**2) * T) / (sigma * np.sqrt(T))
    d2 = d1 - sigma * np.sqrt(T)
    if option_type == "call":
        delta = norm.cdf(d1)
        theta = (-S * norm.pdf(d1) * sigma / (2 * np.sqrt(T))
                 - r * K * np.exp(-r * T) * norm.cdf(d2)) / 365
    else:
        delta = norm.cdf(d1) - 1
        theta = (-S * norm.pdf(d1) * sigma / (2 * np.sqrt(T))
                 + r * K * np.exp(-r * T) * norm.cdf(-d2)) / 365
    gamma = norm.pdf(d1) / (S * sigma * np.sqrt(T))
    vega = S * norm.pdf(d1) * np.sqrt(T) / 100
    rho = K * T * np.exp(-r * T) * norm.cdf(d2 if option_type == "call" else -d2) / 100
    if option_type != "call":
        rho = -rho
    return dict(delta=delta, gamma=gamma, theta=theta, vega=vega, rho=rho)


def test_greeks_match_reference_formulas(rng):
    n = 256
    S = rng.uniform(1000, 50000, n)
    K = rng.uniform(1000, 50000, n)
    T = rng.uniform(0.01, 2.0, n)
    r = rng.uniform(0.0, 0.1, n)
    sigma = rng.uniform(0.1, 1.5, n)
    for opt, is_call in (("call", True), ("put", False)):
        got = bs_greeks(*map(jnp.array, (S, K, T, r, sigma)),
                        jnp.full(n, is_call))
        ref = _reference_greeks(S, K, T, r, sigma, opt)
        for g in ("delta", "gamma", "theta", "vega", "rho"):
            np.testing.assert_allclose(np.asarray(got[g]), ref[g], atol=1e-8,
                                       err_msg=f"{opt} {g}")


def test_greeks_match_autodiff(rng):
    S, K, T, r, sigma = 25000.0, 24000.0, 0.25, 0.03, 0.6
    args = tuple(map(jnp.float64, (S, K, T, r, sigma)))
    for is_call in (True, False):
        price_fn = lambda S_, sig_: bs_price(S_, args[1], args[2], args[3],
                                             sig_, is_call)
        delta_ad = jax.grad(price_fn, argnums=0)(args[0], args[4])
        gamma_ad = jax.grad(jax.grad(price_fn, argnums=0), argnums=0)(args[0], args[4])
        vega_ad = jax.grad(price_fn, argnums=1)(args[0], args[4]) / 100.0
        got = bs_greeks(*args, is_call)
        np.testing.assert_allclose(got["delta"], delta_ad, atol=1e-8)
        np.testing.assert_allclose(got["gamma"], gamma_ad, atol=1e-10)
        np.testing.assert_allclose(got["vega"], vega_ad, atol=1e-8)


def test_put_call_parity(rng):
    n = 128
    S = rng.uniform(100, 1000, n)
    K = rng.uniform(100, 1000, n)
    T = rng.uniform(0.05, 1.0, n)
    r = rng.uniform(0.0, 0.08, n)
    sigma = rng.uniform(0.1, 1.0, n)
    call = bs_price(*map(jnp.array, (S, K, T, r, sigma)), jnp.full(n, True))
    put = bs_price(*map(jnp.array, (S, K, T, r, sigma)), jnp.full(n, False))
    np.testing.assert_allclose(np.asarray(call - put),
                               S - K * np.exp(-r * T), atol=1e-8)


def test_implied_vol_roundtrip(rng):
    n = 512
    S = rng.uniform(100, 1000, n)
    K = S * rng.uniform(0.7, 1.3, n)
    T = rng.uniform(0.05, 1.5, n)
    r = rng.uniform(0.0, 0.05, n)
    sigma = rng.uniform(0.05, 2.0, n)
    is_call = rng.uniform(size=n) < 0.5
    price = bs_price(*map(jnp.array, (S, K, T, r, sigma)), jnp.array(is_call))
    iv = implied_vol(price, *map(jnp.array, (S, K, T, r)), jnp.array(is_call))
    np.testing.assert_allclose(np.asarray(iv), sigma, atol=1e-7)
