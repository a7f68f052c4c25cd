"""eSSVI global vol-surface calibration (Gatheral-Jacquier SSVI, extended
per-expiry as in Hendriks-Martini).

The per-slice SVI path (``ops.svi``) treats every expiry independently:
nothing ties slice i to slice i+1, so calendar arbitrage is only
*diagnosed* after the fact. eSSVI is the industry-standard answer: one
global surface with per-expiry parameters (theta, rho, psi),

    w_i(k) = 1/2 * ( theta_i + rho_i psi_i k
                     + sqrt((psi_i k + theta_i rho_i)^2
                            + theta_i^2 (1 - rho_i^2)) ),

where theta_i = w_i(0) is the ATM total variance. Structural guarantees
baked into the parameter transform (so every LM iterate satisfies them,
not just the converged fit):

  * theta strictly increasing in expiry  -> no ATM calendar arbitrage
    (cumulative-softplus parameterisation);
  * |rho| < 1, psi in (0, psi_cap] with
    psi_cap = min(4 / (1+|rho|), sqrt(4 theta / (1+|rho|)))
    -> each slice is butterfly-arbitrage free (the Gatheral-Jacquier
    sufficient conditions theta phi (1+|rho|) <= 4 and
    theta phi^2 (1+|rho|) <= 4 with phi = psi/theta).

Off-ATM calendar crossings between slices with different (rho, psi) are
not excluded by those conditions alone; a hinge penalty on
w_{i+1} - w_i over a dense common k-grid is part of the LM residual
(``calendar_weight``), and the usual grid diagnostics still run in
``surface.fit_eval_surface``.

No reference analogue — the reference interpolates IV linearly in time
per symbol (src/interpolation/core.py:58-61) and has no surface model;
this extends the north-star SVI capability (BASELINE.json config #3) to
a calendar-consistent global fit. Accelerator-first: the whole surface is ONE
Levenberg-Marquardt problem over 3E transformed parameters, vmapped over
thousands of surfaces; all constraints are smooth transforms, so there
is no data-dependent control flow anywhere.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from iv_engine.ops.lm import levenberg_marquardt
from iv_engine.ops.svi import _solve3x3

_RHO_MAX = 0.999
_PSI_FRAC = 0.999     # keep psi strictly inside the butterfly cap
_THETA_MIN = 1e-6     # floor on the first slice's ATM variance
_DTHETA_MIN = 1e-8    # floor on theta increments (strict monotonicity)


class EssviFit(NamedTuple):
    params: jax.Array     # (..., E, 3) per-expiry (theta, rho, psi)
    cost: jax.Array       # (...,) final 0.5*sum(r^2)
    n_accepted: jax.Array  # (...,) accepted LM steps
    converged: jax.Array  # (...,) bool


def essvi_w(params: jax.Array, k: jax.Array) -> jax.Array:
    """Total variance for eSSVI ``params`` (..., 3) against k (..., n)."""
    w, _, _ = essvi_w_derivs(params, k)
    return w


def essvi_w_derivs(params: jax.Array, k: jax.Array):
    """(w, dw/dk, d2w/dk2) — all closed-form, for the butterfly g.

    ``params``: (..., 3) = (theta, rho, psi); ``k``: (..., n) with the
    leading dims broadcastable against params' batch dims.
    """
    theta = params[..., 0:1]
    rho = params[..., 1:2]
    psi = params[..., 2:3]
    u = psi * k + theta * rho
    R = jnp.sqrt(u * u + theta * theta * (1.0 - rho * rho))
    R = jnp.maximum(R, 1e-12)
    w = 0.5 * (theta + rho * psi * k + R)
    w1 = 0.5 * psi * (rho + u / R)
    w2 = 0.5 * psi * psi * theta * theta * (1.0 - rho * rho) / (R * R * R)
    return w, w1, w2


def essvi_g(params: jax.Array, k: jax.Array) -> jax.Array:
    """Gatheral's butterfly g on a slice — closed-form derivatives."""
    from iv_engine.surface.arbitrage import butterfly_g
    w, w1, w2 = essvi_w_derivs(params, k)
    return butterfly_g(k, w, w1, w2)


def psi_butterfly_cap(theta: jax.Array, rho: jax.Array) -> jax.Array:
    """Largest psi keeping the slice butterfly-free (sufficient
    conditions, Gatheral-Jacquier Thm 4.2 with phi = psi/theta):
    psi (1+|rho|) <= 4 and psi^2 (1+|rho|) <= 4 theta."""
    one_r = 1.0 + jnp.abs(rho)
    return jnp.minimum(4.0 / one_r, jnp.sqrt(4.0 * theta / one_r))


# --- unconstrained z (3E,) <-> constrained (theta, rho, psi) (E, 3) ---

def _transform(z: jax.Array, E: int):
    """z = [z_theta (E,), z_rho (E,), z_psi (E,)] -> (E, 3) params with
    theta strictly increasing, |rho| < 1, 0 < psi <= butterfly cap."""
    z_th, z_rho, z_psi = z[:E], z[E:2 * E], z[2 * E:]
    d = jax.nn.softplus(z_th) + _DTHETA_MIN
    theta = jnp.cumsum(d) + _THETA_MIN
    rho = _RHO_MAX * jnp.tanh(z_rho)
    psi = _PSI_FRAC * psi_butterfly_cap(theta, rho) * jax.nn.sigmoid(z_psi)
    return jnp.stack([theta, rho, psi], axis=-1)


def _inv_softplus(y: jax.Array) -> jax.Array:
    # stable log(expm1(y)); y > 0
    y = jnp.maximum(y, 1e-8)
    return y + jnp.log(-jnp.expm1(-y))


def _inv_transform(theta: jax.Array, rho: jax.Array,
                   psi: jax.Array) -> jax.Array:
    """Best-effort inverse of :func:`_transform` for initialisation."""
    d = jnp.diff(theta, prepend=jnp.zeros((1,), theta.dtype))
    d = jnp.maximum(d - _DTHETA_MIN, 1e-6)
    d = d.at[0].set(jnp.maximum(theta[0] - _THETA_MIN, 1e-6))
    z_th = _inv_softplus(d)
    z_rho = jnp.arctanh(jnp.clip(rho / _RHO_MAX, -0.995, 0.995))
    frac = psi / jnp.maximum(_PSI_FRAC * psi_butterfly_cap(theta, rho),
                             1e-12)
    frac = jnp.clip(frac, 0.01, 0.99)
    z_psi = jnp.log(frac) - jnp.log1p(-frac)
    return jnp.concatenate([z_th, z_rho, z_psi])


def essvi_init(k: jax.Array, w: jax.Array,
               weights: jax.Array | None = None) -> jax.Array:
    """Initial z from per-slice quadratic fits.

    At k=0: w(0) = theta, w'(0) = rho psi,
    w''(0) = psi^2 (1 - rho^2) / (2 theta), so a least-squares quadratic
    w ~ a0 + a1 k + a2 k^2 per slice gives
    psi = sqrt(a1^2 + 4 a2 theta), rho = a1 / psi. The 3x3 normal
    equations are solved closed-form (``ops.svi._solve3x3``).
    ``k``/``w``: (E, n); ``weights`` (E, n) match the fit's residual
    weights (squared here — the residual form multiplies r by the
    weight), so masked/padded quotes cannot steer the init: a slice of
    garbage placeholder w would otherwise inflate its theta estimate
    and the running max below would drag every LATER slice's init up
    with it.
    """
    ones = jnp.ones_like(k)
    X = jnp.stack([ones, k, k * k], axis=-1)            # (E, n, 3)
    hp = jax.lax.Precision.HIGHEST
    sq = (jnp.ones_like(w) if weights is None else weights * weights)
    A = jnp.einsum("en,eni,enj->eij", sq, X, X, precision=hp)
    A = A + 1e-8 * jnp.eye(3, dtype=w.dtype)
    rhs = jnp.einsum("eni,en->ei", X, sq * w, precision=hp)
    sol = _solve3x3(A, rhs)                              # (E, 3)
    theta = jnp.maximum(sol[:, 0], 1e-5)
    # fully-masked slices carry no information: park them at the floor
    # so the running max below takes the preceding live slice's level
    if weights is not None:
        live = jnp.sum(sq, axis=-1) > 1e-12
        theta = jnp.where(live, theta, 1e-5)
        sol = jnp.where(live[:, None], sol, 0.0)
    # enforce increasing ATM variance before inversion (running max)
    theta = jax.lax.associative_scan(jnp.maximum, theta)
    theta = theta + 1e-6 * jnp.arange(theta.shape[0], dtype=theta.dtype)
    s = sol[:, 1]                                        # ATM skew
    c = jnp.maximum(2.0 * sol[:, 2], 0.0)                # ATM curvature
    # psi^2 rho^2 = s^2 and psi^2 (1-rho^2) = 2 c theta
    psi = jnp.sqrt(s * s + 2.0 * c * theta)
    cap = _PSI_FRAC * psi_butterfly_cap(
        theta, jnp.clip(s / jnp.maximum(psi, 1e-8), -0.9, 0.9))
    psi = jnp.clip(psi, 0.05 * cap, 0.95 * cap)
    rho = jnp.clip(s / jnp.maximum(psi, 1e-8), -0.95, 0.95)
    return _inv_transform(theta, rho, psi)


def _residual(z, k, w, weights, k_pen, calendar_weight, E):
    params = _transform(z, E)                            # (E, 3)
    r = (essvi_w(params, k) - w) * weights               # (E, n)
    r = r.reshape(-1)
    if calendar_weight > 0.0:
        # hinge on adjacent-slice crossings over the common dense grid
        wp = essvi_w(params, jnp.broadcast_to(k_pen, (E, k_pen.shape[-1])))
        gap = wp[1:] - wp[:-1]                           # (E-1, m)
        r = jnp.concatenate([
            r, calendar_weight * jnp.minimum(gap, 0.0).reshape(-1)])
    return r


# --- block-tridiagonal Gauss-Newton machinery (solver='block') -------------
#
# The generic LM path (ops.lm) forms the dense (3E, 3E) normal equations
# and Cholesky-factorises them — the dominant cost of the step at
# E=30. But the problem is block-structured in SLICE space:
# data residuals of slice e depend only on that slice's (theta, rho,
# psi), and the calendar hinge couples only adjacent slices, so
# B = J_s^T J_s is block-TRIDIAGONAL with 3x3 blocks. The z-space
# Jacobian is J_z = J_s Phi with Phi = d(slice params)/dz (triangular
# through the cumsum theta-transform, invertible since softplus' > 0),
# and the undamped GN step satisfies
#   (Phi^T B Phi) dz = -Phi^T g_s  <=>  dz = Phi^{-1} B^{-1} (-g_s),
# i.e. solve the BLOCK-TRIDIAGONAL system in slice space, then pull the
# step back through Phi^{-1} (a diagonal+differencing map — O(E)).
# Marquardt damping is applied to B's diagonal blocks — damping in the
# slice metric rather than the z metric, which changes the iterate path
# but not the fixed points; acceptance still tests the true z-space
# cost, so every structural guarantee of the transform is preserved.
# O(E) 3x3 solves replace the O((3E)^3) dense factorisation.


def _inv3x3(A: jax.Array) -> jax.Array:
    """Closed-form 3x3 inverse via the shared adjugate/cofactor block
    (``ops.svi.adjugate3x3``) — computed ONCE per block so the forward
    elimination's two solves against the same Schur complement (and the
    backward pass's re-solve) share one determinant/cofactor set."""
    from iv_engine.ops.svi import adjugate3x3
    adj, det = adjugate3x3(A)
    return adj / det[..., None, None]


def _block_thomas(D: jax.Array, U: jax.Array, b: jax.Array) -> jax.Array:
    """Solve the symmetric block-tridiagonal system with diagonal blocks
    ``D`` (E, 3, 3), superdiagonal blocks ``U`` (E-1, 3, 3) (subdiagonal
    = U^T), RHS ``b`` (E, 3). Unrolled block Thomas — E is static and
    tiny, so this is straight-line code with closed-form 3x3 inverses
    (a loop would add E dependent device steps).
    Each Schur complement is inverted exactly once and reused by the
    forward elimination (two products) and the backward substitution."""
    E = D.shape[-3]
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    S_inv = [_inv3x3(D[0])]
    y = [b[0]]
    for e in range(1, E):
        # L = U_{e-1}^T S_{e-1}^{-1}
        SinvU = mm(S_inv[e - 1], U[e - 1])
        Sinvy = mm(S_inv[e - 1], y[e - 1][..., None])[..., 0]
        S_e = D[e] - mm(U[e - 1].swapaxes(-1, -2), SinvU)
        S_inv.append(_inv3x3(S_e))
        y.append(b[e] - mm(U[e - 1].swapaxes(-1, -2), Sinvy[..., None])[..., 0])
    x = [None] * E
    x[E - 1] = mm(S_inv[E - 1], y[E - 1][..., None])[..., 0]
    for e in range(E - 2, -1, -1):
        rhs = y[e] - mm(U[e], x[e + 1][..., None])[..., 0]
        x[e] = mm(S_inv[e], rhs[..., None])[..., 0]
    return jnp.stack(x)


def _pullback_step(z, d_slice, E):
    """Map a slice-space step (E, 3) = (dtheta, drho, dpsi) to the exact
    z-space step via Phi^{-1} (the transform's inverse tangent map)."""
    z_th, z_rho, z_psi = z[:E], z[E:2 * E], z[2 * E:]
    params = _transform(z, E)
    theta, rho = params[:, 0], params[:, 1]
    d_th, d_rho, d_psi = d_slice[:, 0], d_slice[:, 1], d_slice[:, 2]
    # theta = cumsum(softplus(z_th) + eps): dz = diff(dtheta)/sigmoid
    d_incr = jnp.diff(d_th, prepend=jnp.zeros((1,), d_th.dtype))
    dz_th = d_incr / jnp.maximum(jax.nn.sigmoid(z_th), 1e-8)
    # rho = RHO_MAX tanh(z_rho)
    dz_rho = d_rho / jnp.maximum(
        _RHO_MAX * (1.0 - jnp.tanh(z_rho) ** 2), 1e-8)
    # psi = PSI_FRAC cap(theta, rho) sigmoid(z_psi): remove the induced
    # (theta, rho) motion, then invert the sigmoid factor
    cap = psi_butterfly_cap(theta, rho)
    cap_th, cap_rho = jax.vmap(
        jax.grad(psi_butterfly_cap, argnums=(0, 1)))(theta, rho)
    sig = jax.nn.sigmoid(z_psi)
    induced = _PSI_FRAC * sig * (cap_th * d_th + cap_rho * d_rho)
    dz_psi = (d_psi - induced) / jnp.maximum(
        _PSI_FRAC * cap * sig * (1.0 - sig), 1e-8)
    return jnp.concatenate([dz_th, dz_rho, dz_psi])


def _fit_essvi_block(k, w, weights, k_pen, max_iters, calendar_weight,
                     unroll, tol=1e-12):
    """Block-tridiagonal LM for one surface (see banner comment)."""
    E = k.shape[-2]
    dtype = w.dtype
    cw = jnp.asarray(calendar_weight, dtype)

    def slice_resid(p_e, k_e, w_e, wt_e):
        return (essvi_w(p_e, k_e) - w_e) * wt_e            # (n,)

    def slice_pen(p_e):
        return essvi_w(p_e, k_pen)                         # (m,)

    hp = jax.lax.Precision.HIGHEST  # full f32: the default may run TF32

    def cost_of(z):
        r = _residual(z, k, w, weights, k_pen, calendar_weight, E)
        return 0.5 * jnp.sum(r * r)

    def body(_, state):
        z, lam, cost, n_acc, converged = state
        params = _transform(z, E)                          # (E, 3)
        r_d = jax.vmap(slice_resid)(params, k, w, weights)  # (E, n)
        J_d = jax.vmap(jax.jacfwd(slice_resid))(params, k, w,
                                                weights)    # (E, n, 3)
        g = jnp.einsum("enp,en->ep", J_d, r_d, precision=hp)
        D = jnp.einsum("enp,enq->epq", J_d, J_d, precision=hp)
        if calendar_weight > 0.0:
            wp = jax.vmap(slice_pen)(params)               # (E, m)
            Dp = jax.vmap(jax.jacfwd(slice_pen))(params)   # (E, m, 3)
            gap = wp[1:] - wp[:-1]
            r_c = cw * jnp.minimum(gap, 0.0)               # (E-1, m)
            mask = (gap < 0.0).astype(dtype)[..., None]
            J_lo = -cw * mask * Dp[:-1]                    # d r_c/d theta_e
            J_hi = cw * mask * Dp[1:]                      # d r_c/d theta_{e+1}
            g = g.at[:-1].add(
                jnp.einsum("emp,em->ep", J_lo, r_c, precision=hp))
            g = g.at[1:].add(
                jnp.einsum("emp,em->ep", J_hi, r_c, precision=hp))
            D = D.at[:-1].add(
                jnp.einsum("emp,emq->epq", J_lo, J_lo, precision=hp))
            D = D.at[1:].add(
                jnp.einsum("emp,emq->epq", J_hi, J_hi, precision=hp))
            U = jnp.einsum("emp,emq->epq", J_lo, J_hi, precision=hp)
        else:
            U = jnp.zeros((E - 1, 3, 3), dtype)

        diag = jnp.diagonal(D, axis1=-2, axis2=-1)         # (E, 3)
        # absolute floor keyed to the SURFACE's diagonal scale: a fully
        # masked slice has D = 0, and a lam-proportional damp alone
        # (lam * 1e-12) underflows the f32 3x3 determinant -> NaN step
        # -> every iteration rejected while lam grows (review finding)
        floor = 1e-8 * jnp.maximum(jnp.max(diag), 1.0)
        damp = lam * jnp.maximum(diag, 1e-12) + floor
        D_lam = D + damp[..., None] * jnp.eye(3, dtype=dtype)
        d_slice = _block_thomas(D_lam, U, -g)              # (E, 3)
        dz = _pullback_step(z, d_slice, E)
        z_new = z + dz
        cost_new = cost_of(z_new)
        accept = (cost_new < cost) & jnp.all(jnp.isfinite(z_new))
        z = jnp.where(accept & ~converged, z_new, z)
        cost_next = jnp.where(accept & ~converged, cost_new, cost)
        lam = jnp.where(converged, lam,
                        jnp.where(accept, lam / 3.0, lam * 3.0))
        lam = jnp.clip(lam, 1e-12, 1e12)
        n_acc = n_acc + (accept & ~converged)
        # convergence bookkeeping mirrors ops/lm.py; small_step is gated
        # on acceptance (unlike lm.py historically) so a rejection
        # streak that drives lam to its cap — shrinking the damped step
        # towards zero — cannot latch converged=True at a non-optimum
        small_step = accept & (
            jnp.max(jnp.abs(d_slice)) < tol * (1.0 + jnp.max(jnp.abs(z))))
        small_impr = accept & (cost - cost_new < tol * jnp.maximum(cost, 1.0))
        converged = converged | small_step | small_impr
        return z, lam, cost_next, n_acc, converged

    z0 = essvi_init(k, w, weights)
    state0 = (z0, jnp.asarray(1e-3, dtype), cost_of(z0),
              jnp.zeros((), jnp.int32), jnp.zeros((), bool))
    z, lam, cost, n_acc, converged = jax.lax.fori_loop(
        0, max_iters, body, state0, unroll=max_iters if unroll else 1)
    return EssviFit(params=_transform(z, E), cost=cost,
                    n_accepted=n_acc, converged=converged)


@partial(jax.jit, static_argnames=("max_iters", "calendar_weight",
                                   "n_penalty_grid", "unroll", "loss",
                                   "huber_delta", "solver"))
def _fit_essvi_jit(k: jax.Array, w: jax.Array,
                   weights: jax.Array | None = None,
                   max_iters: int = 64,
                   calendar_weight: float = 10.0,
                   n_penalty_grid: int = 33,
                   unroll: bool = False,
                   loss: str = "linear",
                   huber_delta: float = 1e-3,
                   solver: str = "block") -> EssviFit:
    """Calibrate one eSSVI surface: ``k``/``w`` (E, n) -> params (E, 3).

    One global LM over 3E transformed parameters — every iterate is
    butterfly-free per slice with increasing ATM variance by
    construction. Batch with :func:`fit_essvi_batched`.
    ``loss='huber'`` makes the data term (and penalty) pseudo-Huber with
    scale ``huber_delta`` so outlier quotes cannot dominate the joint
    fit (``ops.lm.robustify``).
    ``solver='block'`` (default) exploits the block-tridiagonal
    structure of the normal equations in slice space — O(E) 3x3 solves
    instead of the dense (3E)^3 Cholesky that dominated the step (see
    the banner comment above ``_block_thomas``); ``solver='dense'`` is
    the generic ``ops.lm`` path (also used for ``loss='huber'``, whose
    row reweighting breaks the block assembly).
    """
    E = k.shape[-2]
    if weights is None:
        weights = jnp.ones_like(w)
    # calendar-penalty grid over the intersection of the QUOTED strike
    # ranges — masked via weights, not the raw first/last columns:
    # zero-weight padded/sentinel strikes would collapse the range and
    # move the hinge off the quoted region (round-4 review; essvi_init
    # applies the same masked-quote discipline)
    live = weights > 0
    big = jnp.asarray(jnp.inf, k.dtype)
    k_lo = jnp.min(jnp.where(live, k, big), axis=-1)    # (E,)
    k_hi = jnp.max(jnp.where(live, k, -big), axis=-1)
    has = jnp.any(live, axis=-1)
    k_lo = jnp.where(has, k_lo, k[..., 0])
    k_hi = jnp.where(has, k_hi, k[..., -1])
    k_pen = jnp.linspace(jnp.max(k_lo), jnp.min(k_hi),
                         n_penalty_grid).astype(k.dtype)
    if solver not in ("block", "dense"):
        raise ValueError(f"unknown solver: {solver!r}")
    if solver == "block" and loss == "linear":
        return _fit_essvi_block(k, w, weights, k_pen, max_iters,
                                calendar_weight, unroll)
    z0 = essvi_init(k, w, weights)
    residual = partial(_residual, calendar_weight=calendar_weight, E=E)
    if loss == "huber":
        from iv_engine.ops.lm import robustify
        residual = robustify(residual, huber_delta)
    elif loss != "linear":
        raise ValueError(f"unknown loss: {loss!r}")
    res = levenberg_marquardt(
        residual,
        z0, k, w, weights, k_pen, max_iters=max_iters, unroll=unroll)
    return EssviFit(params=_transform(res.params, E), cost=res.cost,
                    n_accepted=res.n_accepted, converged=res.converged)


def fit_essvi(k, w, weights=None, max_iters: int = 64,
              calendar_weight: float = 10.0, n_penalty_grid: int = 33,
              unroll: bool = False, loss: str = "linear",
              huber_delta: float = 1e-3,
              solver: str = "block") -> EssviFit:
    """See :func:`_fit_essvi_jit` — this thin wrapper coerces the
    float-valued jit-static knobs to Python floats so numpy/JAX scalars
    do not raise unhashable-static errors and value-equal calls share a
    compile cache entry."""
    return _fit_essvi_jit(k, w, weights, max_iters=int(max_iters),
                          calendar_weight=float(calendar_weight),
                          n_penalty_grid=int(n_penalty_grid),
                          unroll=bool(unroll), loss=loss,
                          huber_delta=float(huber_delta), solver=solver)


@partial(jax.jit, static_argnames=("max_iters", "calendar_weight",
                                   "n_penalty_grid", "unroll", "loss",
                                   "huber_delta", "solver"))
def _fit_essvi_batched_jit(k: jax.Array, w: jax.Array,
                           weights: jax.Array | None = None,
                           max_iters: int = 64,
                           calendar_weight: float = 10.0,
                           n_penalty_grid: int = 33,
                           unroll: bool = False,
                           loss: str = "linear",
                           huber_delta: float = 1e-3,
                           solver: str = "block") -> EssviFit:
    if weights is None:
        weights = jnp.ones_like(w)
    batch = w.shape[:-2]
    E, n = w.shape[-2:]
    kf = k.reshape((-1, E, n))
    wf = w.reshape((-1, E, n))
    wtf = weights.reshape((-1, E, n))
    fit = jax.vmap(partial(_fit_essvi_jit, max_iters=max_iters,
                           calendar_weight=calendar_weight,
                           n_penalty_grid=n_penalty_grid,
                           unroll=unroll, loss=loss,
                           huber_delta=huber_delta,
                           solver=solver))(kf, wf, wtf)
    reshape = lambda a: a.reshape(batch + a.shape[1:])
    return EssviFit(*map(reshape, fit))


def fit_essvi_batched(k, w, weights=None, max_iters: int = 64,
                      calendar_weight: float = 10.0,
                      n_penalty_grid: int = 33, unroll: bool = False,
                      loss: str = "linear", huber_delta: float = 1e-3,
                      solver: str = "block") -> EssviFit:
    """Batched eSSVI: ``k``/``w`` (..., E, n) -> params (..., E, 3).

    Unlike ``fit_svi_batched`` (which flattens surfaces x expiries into
    independent 5-param problems), each SURFACE here is one joint
    3E-parameter problem; only the surface axis is vmapped. Float-
    valued jit-static knobs are coerced to Python floats here (numpy/
    JAX scalars would raise unhashable-static errors).
    """
    return _fit_essvi_batched_jit(
        k, w, weights, max_iters=int(max_iters),
        calendar_weight=float(calendar_weight),
        n_penalty_grid=int(n_penalty_grid), unroll=bool(unroll),
        loss=loss, huber_delta=float(huber_delta), solver=solver)
