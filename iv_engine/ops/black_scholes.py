"""Vectorised Black-Scholes pricing and Greeks.

The reference shipped a Greeks module that was never imported (dead code:
src/interpolation/greeks.py, noted "Not required before 10 June") and
reserved delta/gamma/theta/vega/rho schema columns it never populated
(src/database/schema.py:36-41). Here Greeks are a first-class, jitted,
batched op, with the same unit conventions as the reference formulas
(greeks.py:21-35): theta per-day (/365), vega and rho per-1% (/100).

``jax.grad`` of :func:`bs_price` cross-checks the closed forms in
tests/test_black_scholes.py.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm


def _d1_d2(S, K, T, r, sigma):
    sqrtT = jnp.sqrt(T)
    d1 = (jnp.log(S / K) + (r + 0.5 * sigma**2) * T) / (sigma * sqrtT)
    d2 = d1 - sigma * sqrtT
    return d1, d2


@jax.jit
def bs_price(S, K, T, r, sigma, is_call) -> jax.Array:
    """Black-Scholes European option price; ``is_call`` is a bool array."""
    d1, d2 = _d1_d2(S, K, T, r, sigma)
    disc = jnp.exp(-r * T)
    call = S * norm.cdf(d1) - K * disc * norm.cdf(d2)
    put = K * disc * norm.cdf(-d2) - S * norm.cdf(-d1)
    return jnp.where(is_call, call, put)


@jax.jit
def bs_greeks(S, S_, T, r, sigma, is_call):
    """Closed-form Greeks matching reference greeks.py:21-35 conventions.

    Args (all broadcastable arrays):
      S: underlying price; S_: strike (named K in the reference);
      T: time to maturity (years); r: rate; sigma: implied vol;
      is_call: bool array.

    Returns:
      dict with delta, gamma, theta (per-day), vega (per-1%), rho (per-1%).
    """
    K = S_
    d1, d2 = _d1_d2(S, K, T, r, sigma)
    sqrtT = jnp.sqrt(T)
    pdf_d1 = norm.pdf(d1)
    disc = jnp.exp(-r * T)

    delta = jnp.where(is_call, norm.cdf(d1), norm.cdf(d1) - 1.0)
    gamma = pdf_d1 / (S * sigma * sqrtT)
    theta_call = (-S * pdf_d1 * sigma / (2 * sqrtT) - r * K * disc * norm.cdf(d2))
    theta_put = (-S * pdf_d1 * sigma / (2 * sqrtT) + r * K * disc * norm.cdf(-d2))
    theta = jnp.where(is_call, theta_call, theta_put) / 365.0
    vega = S * pdf_d1 * sqrtT / 100.0
    rho = jnp.where(
        is_call,
        K * T * disc * norm.cdf(d2),
        -K * T * disc * norm.cdf(-d2),
    ) / 100.0
    return {"delta": delta, "gamma": gamma, "theta": theta,
            "vega": vega, "rho": rho}


@partial(jax.jit, static_argnames=("max_iters",))
def implied_vol(price, S, K, T, r, is_call, sigma0=0.5, max_iters: int = 64):
    """Batched implied-vol inversion via safeguarded Newton (vega step,
    bisection fallback), fully vectorised under ``lax.while_loop``-free
    fixed iteration count for vmap/jit friendliness."""
    lo = jnp.full_like(price, 1e-4)
    hi = jnp.full_like(price, 5.0)
    sigma = jnp.broadcast_to(jnp.asarray(sigma0, price.dtype), price.shape)

    def body(i, state):
        sigma, lo, hi = state
        p = bs_price(S, K, T, r, sigma, is_call)
        d1, _ = _d1_d2(S, K, T, r, sigma)
        vega = S * norm.pdf(d1) * jnp.sqrt(T)
        too_high = p > price
        lo = jnp.where(too_high, lo, sigma)
        hi = jnp.where(too_high, sigma, hi)
        newton = sigma - (p - price) / jnp.maximum(vega, 1e-12)
        ok = (newton > lo) & (newton < hi) & jnp.isfinite(newton)
        sigma = jnp.where(ok, newton, 0.5 * (lo + hi))
        return sigma, lo, hi

    sigma, _, _ = jax.lax.fori_loop(0, max_iters, body, (sigma, lo, hi))
    return sigma
