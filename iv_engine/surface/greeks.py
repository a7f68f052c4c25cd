"""Greek surfaces: Black-Scholes risk grids from fitted vol surfaces.

Closes the loop the reference left open: it reserved delta/gamma/theta/
vega/rho columns (src/database/schema.py:36-41) and shipped a dead Greeks
module (greeks.py). Here a fitted surface evaluates straight into price
and Greek grids — the risk view a desk actually consumes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from iv_engine.ops.black_scholes import bs_greeks, bs_price


@jax.jit
def greek_surfaces(k_grid: jax.Array, iv_grid: jax.Array,
                   expiries: jax.Array, spot: jax.Array,
                   rate: jax.Array, is_call=True):
    """Price + Greeks on an evaluated surface grid.

    Args:
      k_grid: (..., E, m) log-moneyness grid (from fit_eval_surface*).
      iv_grid: (..., E, m) implied vols on the grid.
      expiries: (..., E) maturities in years.
      spot: (...,) underlying price per surface.
      rate: (...,) or scalar risk-free rate.
      is_call: bool or bool array broadcastable to the grid.

    Returns dict of (..., E, m) grids: price, delta, gamma, theta (per
    day), vega (per 1%), rho (per 1%) — same unit conventions as the
    reference formulas (greeks.py:21-35).
    """
    S = spot[..., None, None]
    K = S * jnp.exp(k_grid)
    T = expiries[..., None]
    r = jnp.asarray(rate)
    if r.ndim:
        r = r[..., None, None]
    is_call = jnp.asarray(is_call)
    out = bs_greeks(S, K, jnp.maximum(T, 1e-12), r,
                    jnp.maximum(iv_grid, 1e-12), is_call)
    out["price"] = bs_price(S, K, jnp.maximum(T, 1e-12), r,
                            jnp.maximum(iv_grid, 1e-12), is_call)
    return out
