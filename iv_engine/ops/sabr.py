"""SABR smile model: Hagan lognormal-vol expansion + batched calibration.

Second parametric smile family next to SVI (``ops.svi``): the reference's
data model carries per-option IV/strike/expiry (src/database/schema.py:
21-52) but no smile model at all; SABR is the standard desk
parameterisation for rates/crypto smiles and exercises the same batched-LM
machinery (``ops.lm``).

Hagan et al. (2002) lognormal implied vol sigma_B(F, K) to O(T):

    z   = (nu/alpha) * (F K)^((1-beta)/2) * ln(F/K)
    x(z)= ln( (sqrt(1 - 2 rho z + z^2) + z - rho) / (1 - rho) )
    sigma = alpha / ( (FK)^((1-beta)/2) * (1 + (1-beta)^2/24 ln^2(F/K)
            + (1-beta)^4/1920 ln^4(F/K)) ) * z/x(z) * (1 + c1 T)
    c1  = (1-beta)^2/24 * alpha^2/(FK)^(1-beta)
          + rho beta nu alpha / (4 (FK)^((1-beta)/2)) + (2-3rho^2)/24 nu^2

ATM limit (K -> F) handled analytically. Parity oracle: a NumPy
re-implementation in tests/test_sabr.py (no SciPy SABR exists), plus
round-trip calibration recovery.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from iv_engine.ops.lm import LMResult, levenberg_marquardt

# parameter order: (alpha, beta, rho, nu); beta usually fixed in [0, 1]
# numpy on purpose — see ops/svi.py note on trace-linked module constants
SABR_LOWER = np.array([1e-6, 0.0, -0.9999, 1e-6])
SABR_UPPER = np.array([10.0, 1.0, 0.9999, 10.0])


def sabr_vol(params: jax.Array, F, K, T) -> jax.Array:
    """Hagan lognormal implied vol; broadcasts over K.

    params: (..., 4) = (alpha, beta, rho, nu); F, T scalars or (...,);
    K: (..., n).
    """
    alpha, beta, rho, nu = (params[..., i:i + 1] for i in range(4))
    F = jnp.asarray(F)[..., None] if jnp.ndim(F) == params.ndim - 1 else F
    T = jnp.asarray(T)[..., None] if jnp.ndim(T) == params.ndim - 1 else T

    omb = 1.0 - beta
    logFK = jnp.log(F / K)
    FKmid = (F * K) ** (omb / 2.0)

    c1 = (omb**2 / 24.0 * alpha**2 / (F * K) ** omb
          + rho * beta * nu * alpha / (4.0 * FKmid)
          + (2.0 - 3.0 * rho**2) / 24.0 * nu**2)

    denom = FKmid * (1.0 + omb**2 / 24.0 * logFK**2
                     + omb**4 / 1920.0 * logFK**4)

    z = (nu / alpha) * FKmid * logFK
    sqrt_term = jnp.sqrt(1.0 - 2.0 * rho * z + z * z)
    # x(z) = log((sqrt_term + z - rho)/(1 - rho)). The direct numerator
    # N = sqrt_term + z - rho cancels catastrophically for z << 0
    # (true value ~ (1-rho^2)/(2|z|); f32 computes <= 0 and log NaNs —
    # reachable on the deep-OTM-put wing mid-LM, where every step then
    # rejects and the fit silently returns the init). Conjugate
    # identity: N * (sqrt_term - z + rho) = 1 - rho^2 exactly, and the
    # conjugate C is large+stable precisely where N cancels (z < 0) —
    # while N is the stable one where C cancels (z >> 0). Select by
    # sign (round-4 review).
    N = sqrt_term + z - rho
    C = jnp.where(z < 0.0, sqrt_term - z + rho, 1.0)  # safe denominator:
    #   the unselected branch must not divide by a cancelling C (the
    #   where-grad NaN trap)
    num = jnp.where(z < 0.0, (1.0 - rho * rho) / C, N)
    x = jnp.log(num / (1.0 - rho))
    # z/x -> 1 as z -> 0; series z/x ~ 1 + rho z/2 + ... keeps grads finite
    small = jnp.abs(z) < 1e-7
    z_safe = jnp.where(small, 1.0, z)
    x_safe = jnp.where(small, 1.0, x)
    zx = jnp.where(small, 1.0 + rho * z / 2.0, z_safe / x_safe)

    return alpha / denom * zx * (1.0 + c1 * T)


def sabr_init(k_strikes: jax.Array, iv: jax.Array, F, T,
              beta: float = 0.5) -> jax.Array:
    """Initial guess: alpha from ATM vol level, modest rho/nu."""
    atm_idx = jnp.argmin(jnp.abs(jnp.log(k_strikes / F)))
    atm_vol = iv[atm_idx]
    alpha0 = atm_vol * F ** (1.0 - beta)
    return jnp.array([alpha0, beta, 0.0, 0.5], iv.dtype)


def _sabr_residual(params, K, iv, F, T, weights, fix_beta):
    p = params
    if fix_beta is not None:
        p = p.at[1].set(fix_beta)
    return (sabr_vol(p, F, K, T) - iv) * weights


@partial(jax.jit, static_argnames=("max_iters", "fix_beta"))
def fit_sabr(K: jax.Array, iv: jax.Array, F, T,
             weights: jax.Array | None = None, params0=None,
             max_iters: int = 64, fix_beta: float | None = 0.5) -> LMResult:
    """Calibrate one SABR slice (strikes K -> lognormal vols iv).

    ``fix_beta`` pins beta (standard practice); pass None to free it.
    """
    if weights is None:
        weights = jnp.ones_like(iv)
    if params0 is None:
        params0 = sabr_init(K, iv, F, T,
                            beta=0.5 if fix_beta is None else fix_beta)
    res = levenberg_marquardt(
        partial(_sabr_residual, fix_beta=fix_beta),
        params0, K, iv, F, T, weights,
        max_iters=max_iters,
        lower=SABR_LOWER.astype(iv.dtype), upper=SABR_UPPER.astype(iv.dtype))
    if fix_beta is not None:
        res = res._replace(params=res.params.at[1].set(fix_beta))
    return res


@partial(jax.jit, static_argnames=("max_iters", "fix_beta"))
def fit_sabr_batched(K: jax.Array, iv: jax.Array, F: jax.Array,
                     T: jax.Array, max_iters: int = 64,
                     fix_beta: float | None = 0.5) -> LMResult:
    """Batched calibration: K/iv (..., n), F/T (...,)."""
    batch_shape = iv.shape[:-1]
    n = iv.shape[-1]
    Kf = K.reshape((-1, n))
    ivf = iv.reshape((-1, n))
    Ff = F.reshape((-1,))
    Tf = T.reshape((-1,))
    fit = jax.vmap(
        lambda k_, i_, f_, t_: fit_sabr(k_, i_, f_, t_, max_iters=max_iters,
                                        fix_beta=fix_beta)
    )(Kf, ivf, Ff, Tf)
    reshape = lambda a: a.reshape(batch_shape + a.shape[1:])
    return LMResult(*map(reshape, fit))
