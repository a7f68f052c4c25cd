"""RBF / thin-plate-spline surface fitting on scattered quotes.

North-star capability (BASELINE.json config #4): "RBF/thin-plate surface
on ~2k scattered quotes with no-arbitrage penalty smoothing". No reference
analogue exists (the reference never fit surfaces); the SciPy oracle is
``scipy.interpolate.RBFInterpolator`` (tests/test_rbf.py, <=1e-8 in f64).

Design: one Gram-matrix factorisation per surface, batched with ``vmap``.
The Gram solve is dense linear algebra that XLA maps onto the matrix units — for
N~2k sites the (N+3)^2 system is ~16MB in f32, comfortably device-resident
per surface; throughput comes from batching surfaces, not from sharding a
single solve.

Kernels:
  * ``thin_plate``   phi(r) = r^2 log r, with degree-1 polynomial tail
                     (conditionally positive definite)
  * ``gaussian``     phi(r) = exp(-(eps r)^2)   (PD; still gets SciPy's
                     degree-0 tail, so the bordered system is indefinite)
  * ``multiquadric`` phi(r) = -sqrt(1 + (eps r)^2)  (CPD order 1)

All kernels solve the same bordered saddle system with a general LU —
there is no PD fast path (the polynomial border makes every system
indefinite).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _pairwise_r(a: jax.Array, b: jax.Array) -> jax.Array:
    """Euclidean distances between point sets (N,2) x (M,2) -> (N,M)."""
    d = a[:, None, :] - b[None, :, :]
    return jnp.sqrt(jnp.sum(d * d, axis=-1) + 1e-300)


def _kernel(r: jax.Array, kind: str, eps: float) -> jax.Array:
    if kind == "thin_plate":
        # r^2 log r, with the r=0 limit 0 (r clamped in _pairwise_r)
        return jnp.where(r > 1e-100, r * r * jnp.log(jnp.maximum(r, 1e-100)), 0.0)
    if kind == "gaussian":
        return jnp.exp(-((eps * r) ** 2))
    if kind == "multiquadric":
        return -jnp.sqrt(1.0 + (eps * r) ** 2)
    raise ValueError(f"unknown RBF kernel: {kind!r}")


# polynomial-tail degree per kernel, matching SciPy RBFInterpolator defaults:
# thin_plate -> degree 1 ([1, x, y]); gaussian/multiquadric -> degree 0 ([1])
_POLY_TERMS = {"thin_plate": 3, "gaussian": 1, "multiquadric": 1}


@partial(jax.jit, static_argnames=("kernel",))
def fit_rbf(points: jax.Array, values: jax.Array, smoothing: float = 0.0,
            kernel: str = "thin_plate", epsilon: float = 1.0):
    """Fit an RBF surface through scattered ``points`` -> ``values``.

    Args:
      points: (N, 2) quote coordinates (e.g. log-moneyness, maturity).
      values: (N,) observed values (e.g. total variance).
      smoothing: ridge term on the kernel block (SciPy ``smoothing``).
      kernel/epsilon: kernel family and shape parameter.

    Returns:
      dict with ``coef`` (N,), ``poly`` (3,) (zeros if the kernel needs no
      tail), plus the inputs needed for evaluation.
    """
    n = points.shape[0]
    r = _pairwise_r(points, points)
    A = _kernel(r, kernel, epsilon) + smoothing * jnp.eye(n, dtype=values.dtype)

    p = _POLY_TERMS[kernel]
    ones = jnp.ones((n, 1), values.dtype)
    P = ones if p == 1 else jnp.concatenate([ones, points], axis=1)
    top = jnp.concatenate([A, P], axis=1)
    bot = jnp.concatenate([P.T, jnp.zeros((p, p), values.dtype)], axis=1)
    lhs = jnp.concatenate([top, bot], axis=0)
    rhs = jnp.concatenate([values, jnp.zeros((p,), values.dtype)])
    sol = jnp.linalg.solve(lhs, rhs)
    coef, poly_c = sol[:n], sol[n:]
    poly = jnp.zeros((3,), values.dtype).at[:p].set(poly_c)
    return {"points": points, "coef": coef, "poly": poly}


@partial(jax.jit, static_argnames=("kernel",))
def eval_rbf(fit: dict, query: jax.Array, kernel: str = "thin_plate",
             epsilon: float = 1.0) -> jax.Array:
    """Evaluate a fitted RBF surface at ``query`` (M, 2) -> (M,)."""
    r = _pairwise_r(query, fit["points"])
    K = _kernel(r, kernel, epsilon)
    hp = jax.lax.Precision.HIGHEST  # full f32: the default may run TF32
    out = jnp.matmul(K, fit["coef"], precision=hp)
    poly = fit["poly"]
    return out + poly[0] + jnp.matmul(query, poly[1:], precision=hp)


def fit_eval_rbf_batched(points, values, query, smoothing=0.0,
                         kernel="thin_plate", epsilon=1.0):
    """Batched fit+eval: leading batch dim on points/values/query."""
    def one(p, v, q):
        f = fit_rbf(p, v, smoothing=smoothing, kernel=kernel, epsilon=epsilon)
        return eval_rbf(f, q, kernel=kernel, epsilon=epsilon)
    return jax.vmap(one)(points, values, query)


# ---------------------------------------------------------------------------
# No-arbitrage penalty smoothing (BASELINE.json config #4: "RBF/thin-plate
# surface on ~2k scattered quotes with no-arbitrage penalty smoothing").
#
# The plain ``fit_rbf`` ridge only smooths; nothing stops the fitted total-
# variance surface from carrying butterfly (negative risk-neutral density)
# or calendar (w decreasing in T) arbitrage. Here the fit itself minimises
#
#   ||w(x_i) - y_i||^2  +  s * c^T K c            (native-space seminorm)
#   + lam_b * sum min(g_fd(w_grid), 0)^2          (butterfly hinge)
#   + lam_c * sum min(dw/dT_grid, 0)^2            (calendar hinge)
#   subject to  P^T c = 0                          (CPD side condition)
#
# over a dense uniform (E_pen, m_pen) penalty grid, mirroring the SVI
# hinge design (ops/svi.py ``_svi_residual``). The surface is LINEAR in
# the coefficients, so each Gauss-Newton step is a penalized linear
# least-squares with the hinge handled by an active-set mask — a fixed
# iteration count with masks instead of data-dependent branches, like
# every other solver in this package (SURVEY.md §7.3). The butterfly g
# uses the same finite-difference stencils as the post-hoc diagnostic
# (``surface.arbitrage.butterfly_g_fd``), so the penalty targets exactly
# the quantity the pipeline flags.
#
# At lam_b = lam_c = 0 the objective's stationarity reduces to SciPy's
# smoothing-RBF system ((K + sI)c + Pp = y, P^T c = 0): the minimiser of
# ||Kc + Pp - y||^2 + s c^T K c on {P^T c = 0} satisfies
# K(Kc+Pp-y) + sKc + P nu = 0, and substituting the SciPy solution gives
# Kc+Pp-y = -sc, hence nu = 0 — verified to ~1e-7 in tests/test_rbf.py.
# ---------------------------------------------------------------------------


def _fd1(w: jax.Array, h) -> jax.Array:
    """First-derivative FD stencil along the last axis, uniform spacing
    ``h`` — the exact stencil of ``butterfly_g_fd`` (midpoint-slope
    average interior, one-sided ends)."""
    mid = (w[..., 1:] - w[..., :-1]) / h
    return jnp.concatenate([
        mid[..., :1],
        (mid[..., 1:] + mid[..., :-1]) / 2.0,
        mid[..., -1:],
    ], axis=-1)


def _fd2(w: jax.Array, h) -> jax.Array:
    """Second-derivative FD stencil along the last axis (uniform ``h``),
    endpoints copying their neighbours — matches ``butterfly_g_fd``."""
    mid = (w[..., 1:] - w[..., :-1]) / h
    inner = (mid[..., 1:] - mid[..., :-1]) / h
    return jnp.concatenate([inner[..., :1], inner, inner[..., -1:]],
                           axis=-1)


def _g_partials(k, w, w1, w2, eps=1e-12):
    """(g, dg/dw, dg/dw1) of Gatheral's butterfly g — closed-form partials
    for the Gauss-Newton Jacobian (dg/dw2 = 1/2 is constant). All inputs
    elementwise-broadcast arrays."""
    sw = w > eps
    ws = jnp.maximum(w, eps)
    u = 1.0 - k * w1 / (2.0 * ws)
    g = u * u - (w1 * w1 / 4.0) * (1.0 / ws + 0.25) + w2 / 2.0
    inv_w2 = 1.0 / (ws * ws)
    dg_dw = jnp.where(sw, (u * k * w1 + w1 * w1 / 4.0) * inv_w2, 0.0)
    dg_dw1 = -u * k / ws - (w1 / 2.0) * (1.0 / ws + 0.25)
    return g, dg_dw, dg_dw1


@partial(jax.jit, static_argnames=("kernel", "n_pen_t", "n_pen_k",
                                   "n_iters", "butterfly_weight",
                                   "calendar_weight", "n_centers"))
def fit_rbf_arbfree(points: jax.Array, values: jax.Array,
                    weights: jax.Array | None = None,
                    smoothing: float = 1e-8,
                    kernel: str = "thin_plate", epsilon: float = 1.0,
                    butterfly_weight: float = 1000.0,
                    calendar_weight: float = 1000.0,
                    butterfly_margin: float = 1e-3,
                    calendar_margin: float = 3e-3,
                    n_pen_t: int = 12, n_pen_k: int = 33,
                    n_iters: int = 16,
                    n_centers: int | None = None):
    """Fit an RBF total-variance surface with no-arbitrage hinge penalties.

    Args:
      points: (N, 2) scattered (log-moneyness k, maturity T) quote sites.
      values: (N,) observed total variance w = iv^2 T.
      weights: optional (N,) per-quote data weights (0 drops a padded
        quote from the data term while keeping shapes static).
      smoothing: native-space seminorm weight ``s`` (SciPy-equivalent
        smoothing at zero penalty weights).
      butterfly_weight / calendar_weight: hinge weights lam_b / lam_c
        on the NORMALISED objective (data term averaged over quotes,
        hinges over penalty points, so the weights are N-independent);
        ~1e3 reliably cleans severely arbitrageable data at 200-2k
        sites (measured across seeds). Either 0 disables that penalty,
        and with both 0 the exact weighted saddle system is solved
        directly (SciPy-parity path; full basis only — a reduced basis
        runs the damped scan on the quadratic objective instead, see
        the f32-robustness routing note at the solve site).
      butterfly_margin / calendar_margin: hinge safety margins — the
        penalty activates below the margin and pushes the linearised
        constraint TO the margin, so the converged surface clears zero
        with room instead of converging onto the boundary from below.
      n_pen_t / n_pen_k: penalty-grid shape over the quote bounding box.
      n_iters: damped Gauss-Newton iterations (static; masked active
        set, accept/reject with a proximal mu like ``ops.lm``).
      n_centers: optional reduced RBF basis size. ``None`` (default)
        keeps every quote site as a center — the exact smoothing-RBF
        estimator, SciPy-parity at zero penalty. An int ``c < N``
        switches to the LEAST-SQUARES RBF: ``c`` centers spread evenly
        over the live quote sites (rank-strided over input order), the
        data term fit over ALL quotes, and the seminorm taken on the
        center Gram. The per-iteration KKT factorization drops from
        (N+p)^3 to (c+p)^3 — ~64x fewer solve FLOPs at c=N/4 — while
        the hinge machinery is unchanged; the trade is basis
        approximation power, negligible once c comfortably exceeds the
        surface's effective degrees of freedom.

    Returns:
      dict as :func:`fit_rbf` (``points``/``coef``/``poly`` — evaluable
      with :func:`eval_rbf`) plus penalty-grid diagnostics:
      ``pen_k_grid``/``pen_t_grid`` (m,)/(E,), ``pen_w`` (E, m) fitted
      grid, ``pen_g`` (E, m) butterfly g, ``butterfly_ok``/``calendar_ok``
      scalars on the penalty grid.
    """
    if kernel not in _POLY_TERMS:  # friendly error, matching fit_rbf
        raise ValueError(f"unknown RBF kernel: {kernel!r}")
    if n_pen_t < 1 or n_pen_k < 3:
        # the butterfly FD stencils need >= 3 strike points; one T row
        # is fine (calendar pairs are simply empty then)
        raise ValueError(f"penalty grid too small: n_pen_t={n_pen_t} "
                         f"(>= 1), n_pen_k={n_pen_k} (>= 3)")
    if calendar_weight > 0.0 and n_pen_t < 2:
        raise ValueError("calendar_weight > 0 needs n_pen_t >= 2 "
                         "(calendar pairs compare adjacent T slices)")
    dtype = values.dtype
    n = points.shape[0]
    p = _POLY_TERMS[kernel]
    wts = jnp.ones((n,), dtype) if weights is None else weights.astype(dtype)
    live = wts > 0

    # 0 (or negative) follows the config convention "0 disables":
    # exact full-center path, NOT a degenerate zero-center basis that
    # would silently fit a polynomial-only plane (round-4 review).
    reduced = n_centers is not None and 0 < n_centers < n
    if reduced:
        # evenly rank-strided over the LIVE sites (padded weight-0 tails
        # must not eat the center budget, and strided-over-input-order
        # would collapse onto one corner of a sorted (k, T) ladder): the
        # j-th center is the site holding live-rank round(j*(L-1)/(c-1)).
        # If there are fewer live sites than centers the clip duplicates
        # ranks; the duplicated Gram columns are absorbed by the
        # reduced-path ridge below.
        csum = jnp.cumsum(live.astype(jnp.int32))          # 1-based ranks
        n_live = jnp.maximum(csum[-1], 1)
        ranks = 1 + jnp.clip(jnp.round(
            jnp.linspace(0.0, 1.0, n_centers)
            * (n_live - 1).astype(dtype)).astype(jnp.int32), 0, n_live - 1)
        cidx = jnp.clip(jnp.searchsorted(csum, ranks, side="left"),
                        0, n - 1)
        centers = points[cidx]
        cw = wts[cidx]
    else:
        centers = points
        cw = wts
    c = n_centers if reduced else n

    # data operator A_d = [K_dc | P_d]  (N, c+p); with full centers
    # K_dc IS the quote-site Gram K_dd (one kernel evaluation, shared)
    K_dc = _kernel(_pairwise_r(points, centers), kernel, epsilon)
    K_cc = (_kernel(_pairwise_r(centers, centers), kernel, epsilon)
            if reduced else K_dc)
    ones = jnp.ones((n, 1), dtype)
    P_d = ones if p == 1 else jnp.concatenate([ones, points], axis=1)
    P_c = (P_d if not reduced else
           (jnp.ones((c, 1), dtype) if p == 1
            else jnp.concatenate([jnp.ones((c, 1), dtype), centers],
                                 axis=1)))
    A_d = jnp.concatenate([K_dc, P_d], axis=1)

    # uniform penalty grid over the LIVE quotes' bounding box: padded
    # weight-0 sites (the pipeline extends strike ladders beyond the
    # real range) must not stretch the grid, or the hinge budget drains
    # into pure extrapolation while violations between the coarsened
    # nodes over the real quotes go unpenalized
    k_lo = jnp.min(jnp.where(live, points[:, 0], jnp.inf))
    k_hi = jnp.max(jnp.where(live, points[:, 0], -jnp.inf))
    t_lo = jnp.min(jnp.where(live, points[:, 1], jnp.inf))
    t_hi = jnp.max(jnp.where(live, points[:, 1], -jnp.inf))
    kg = jnp.linspace(0.0, 1.0, n_pen_k).astype(dtype) * (k_hi - k_lo) + k_lo
    tg = jnp.linspace(0.0, 1.0, n_pen_t).astype(dtype) * (t_hi - t_lo) + t_lo
    # degenerate k-range guard (all live quotes at one strike): h_k = 0
    # would NaN the FD stencils and silently return the zero surface
    h_k = jnp.maximum((k_hi - k_lo) / (n_pen_k - 1), 1e-6)
    qk = jnp.tile(kg, n_pen_t)
    qt = jnp.repeat(tg, n_pen_k)
    q = jnp.stack([qk, qt], axis=1)                       # (G, 2)
    K_g = _kernel(_pairwise_r(q, centers), kernel, epsilon)
    P_g = (jnp.ones((q.shape[0], 1), dtype) if p == 1
           else jnp.concatenate([jnp.ones((q.shape[0], 1), dtype), q],
                                axis=1))
    A_g = jnp.concatenate([K_g, P_g], axis=1)             # (G, c+p)

    hp = jax.lax.Precision.HIGHEST  # full f32: the default may run TF32
    mm = partial(jnp.matmul, precision=hp)

    # FD-stencil-transformed operators (fixed): columns of A_g reshaped
    # per slice, differentiated along k. (E, m, P) with P = c+p.
    A3 = A_g.reshape(n_pen_t, n_pen_k, c + p)
    W1A = _fd1(jnp.swapaxes(A3, -1, -2), h_k)            # (E, P, m)
    W1A = jnp.swapaxes(W1A, -1, -2).reshape(-1, c + p)
    W2A = _fd2(jnp.swapaxes(A3, -1, -2), h_k)
    W2A = jnp.swapaxes(W2A, -1, -2).reshape(-1, c + p)

    # calendar difference operator rows: CA = A_g[e+1] - A_g[e]
    CA = (A3[1:] - A3[:-1]).reshape(-1, c + p)           # ((E-1) m, P)

    # fixed quadratic part: (weighted) data + seminorm + tiny ridge.
    # The penalized objective is NORMALISED — data term by the effective
    # quote count, each hinge term by its penalty-point count — so the
    # penalty weights mean the same thing at 200 quotes as at 2k
    # (sum-form objectives silently rebalance with N; measured: the
    # weight that cleans 512 sites leaves 2k-site fits arbitrageable).
    # The data term is sum w_i r_i^2, i.e. residuals scaled by SQRT(w):
    # squaring pre-multiplied w*r would optimise the w^2-weighted
    # objective and diverge from the zero-penalty direct path (which
    # solves the W-weighted saddle system) for any non-binary weights.
    inv_nd = 1.0 / jnp.maximum(jnp.sum(wts), 1.0)
    inv_gb = 1.0 / (n_pen_t * n_pen_k)
    # max(...) keeps n_pen_t=1 (no calendar pairs; CA has zero rows)
    # from dividing by zero at trace time — round-4 review
    inv_gc = 1.0 / max((n_pen_t - 1) * n_pen_k, 1)
    sqw = jnp.sqrt(wts)
    A_dw = sqw[:, None] * A_d
    y_w = sqw * values
    K_pad = jnp.zeros((c + p, c + p), dtype).at[:c, :c].set(K_cc)
    # reduced path: duplicated centers (fewer live sites than centers)
    # make exact zero Gram directions — a 1e-7 ridge absorbs them; full
    # path keeps the original 1e-12 (SciPy-parity territory). These
    # floors are ABSOLUTE constants in the normalized coordinate
    # convention (log-moneyness k, T in years — where phi(0) is 0/±1
    # for every supported kernel, so a diag(K)-relative scale is
    # identically 1 and was deleted as dead weight, round-4 review);
    # the quantity that actually tracks problem magnitude is the
    # per-iteration max-diag-relative ridge inside lm_step.
    ridge = 1e-7 if reduced else 1e-12
    H0 = inv_nd * (mm(A_dw.T, A_dw) + smoothing * K_pad) \
        + ridge * jnp.eye(c + p, dtype=dtype)
    # pin weight-0 quotes' RBF coefficients to ~0 (the direct path's
    # s_eff row does this exactly): without the pin, padded sites'
    # centers stay FREE basis functions the hinge solver can deploy, so
    # the fitted surface would depend on padding contents — and near-
    # duplicate padded centers degrade KKT conditioning. Strength is
    # relative to H0's own diagonal so it dominates the Gram coupling.
    # (Reduced centers are drawn from live sites, so cw>0 there unless
    # every site is padded — then all centers pin, as they should.)
    pin = jnp.zeros((c + p,), dtype).at[:c].set(
        jnp.where(cw > 0, 0.0, 1.0))
    H0 = H0 + jnp.diag(pin) * 1e6 * jnp.max(jnp.diag(H0))
    b0 = inv_nd * mm(A_dw.T, y_w)

    # CPD side condition P^T c = 0 via KKT rows (exact, not penalized)
    Pt = jnp.concatenate([P_c, jnp.zeros((p, p), dtype)], axis=0)  # (c+p, p)

    kg_row = jnp.broadcast_to(kg, (n_pen_t, n_pen_k))

    # static: both weights are static_argnames, so the zero-penalty
    # program contains no hinge/feasibility work at all (the reduced
    # basis rides this scan for f32 robustness only — round-4 review:
    # the untracked feasibility state was threaded through the carry,
    # which XLA cannot dead-code-eliminate)
    penalized = butterfly_weight > 0.0 or calendar_weight > 0.0

    def hinge_parts(u):
        """Penalty-grid pieces at coefficients u: (g flattened,
        dg/dw, dg/dw1 — the Gauss-Newton Jacobian partials, both
        flattened — and the calendar slice differences dw)."""
        w = mm(A_g, u).reshape(n_pen_t, n_pen_k)
        g, dg_dw, dg_dw1 = _g_partials(kg_row, w, _fd1(w, h_k),
                                       _fd2(w, h_k))
        gf = g.reshape(-1)
        dw = mm(CA, u)
        return gf, dg_dw.reshape(-1), dg_dw1.reshape(-1), dw

    def cost_of(u):
        """(total cost, smooth data+seminorm cost, feasible on the raw
        margin-free no-arb constraints — feasibility only evaluated on
        the penalized route; the zero-penalty contract ignores it)."""
        r_d = sqw * (mm(A_d, u) - values)
        smooth_c = inv_nd * (jnp.sum(r_d * r_d)
                             + smoothing * jnp.dot(u, mm(K_pad, u), precision=hp))
        c = smooth_c
        if not penalized:
            return c, smooth_c, jnp.ones((), bool)
        gf, _, _, dw = hinge_parts(u)
        if butterfly_weight > 0.0:
            c = c + butterfly_weight * inv_gb * jnp.sum(
                jnp.minimum(gf - butterfly_margin, 0.0) ** 2)
        if calendar_weight > 0.0:
            c = c + calendar_weight * inv_gc * jnp.sum(
                jnp.minimum(dw - calendar_margin, 0.0) ** 2)
        feas = jnp.all(gf >= -1e-8) & jnp.all(dw >= -1e-10)
        return c, smooth_c, feas

    def lm_step(state, _):
        # damped Gauss-Newton with acceptance, mirroring ops/lm.py: the
        # hinge makes the objective nonconvex (g divides by w), and an
        # undamped active-set GN step overshoots and oscillates — the
        # proximal term mu*diag(H) plus reject-and-regrow-mu is LM's
        # standard cure, with masks instead of branches so the whole
        # loop stays one traced program.
        if penalized:
            u, mu, cost, u_best, best_smooth, any_feas = state
            gf, dg_dw, dg_dw1, dw = hinge_parts(u)
        else:  # slim carry: no hinge or feasibility state to drag along
            u, mu, cost = state

        H = H0
        rhs = b0
        if butterfly_weight > 0.0:
            act_b = (gf < butterfly_margin).astype(dtype)  # active hinges
            # J = diag(dg/dw) A + diag(dg/dw1) W1A + (1/2) W2A, rows masked
            J = (dg_dw[:, None] * A_g
                 + dg_dw1[:, None] * W1A + 0.5 * W2A)
            Jm = act_b[:, None] * J
            H = H + butterfly_weight * inv_gb * mm(Jm.T, Jm)
            # linearised target g + J (u' - u) = margin on the active set
            rhs = rhs + butterfly_weight * inv_gb * mm(
                Jm.T, act_b * (mm(J, u) - (gf - butterfly_margin)))
        if calendar_weight > 0.0:
            act_c = (dw < calendar_margin).astype(dtype)
            Cm = act_c[:, None] * CA                # linear: target margin
            H = H + calendar_weight * inv_gc * mm(Cm.T, Cm)
            rhs = rhs + calendar_weight * inv_gc * mm(
                Cm.T, act_c * calendar_margin)

        damp = mu * jnp.maximum(jnp.diag(H), 1e-12)
        H = H + jnp.diag(damp)
        rhs = rhs + damp * u                               # proximal at u

        # KKT saddle solve keeps P^T c = 0 exact every iteration.
        # Solved by Cholesky + a p x p Schur complement instead of a
        # dense LU of the (P+p)-bordered system (round-3 verdict: this
        # solve dominated the ~7 surf/s rate). H is PD on the
        # constraint manifold (CPD kernel seminorm + PSD data/penalty
        # terms + damping); the augmented-Lagrangian shift
        # rho * Pt Pt^T makes it PD everywhere WITHOUT changing the
        # saddle's u (Pt^T u = 0 at the solution, so the shift's
        # contribution vanishes there — standard identity). Net: the
        # 2/3 P^3 LU becomes a 1/3 P^3 Cholesky + triangular solves,
        # both better-mapped to matrix units than LU's pivoted panels. A
        # failed factorization (NaN) is caught by the accept gate
        # below: the step is rejected and mu regrows, same self-heal
        # as a singular LU.
        rho = jnp.maximum(jnp.max(jnp.diag(H)), 1.0)
        Hal = H + rho * mm(Pt, Pt.T)
        if reduced:
            # least-squares normal equations square the data operator's
            # condition number; measured cond ~1e10 at c=N/4 NaNs the
            # f32 Cholesky outright (ok in x64). A 1e-6-relative ridge
            # floor bounds cond at ~1e7 — and the accept gate evaluates
            # the TRUE cost, so the slightly-perturbed step direction
            # cannot corrupt convergence, only re-route it.
            Hal = Hal + 1e-6 * jnp.max(jnp.diag(Hal)) \
                * jnp.eye(c + p, dtype=dtype)
        L = jnp.linalg.cholesky(Hal)
        X = jax.scipy.linalg.cho_solve(
            (L, True), jnp.concatenate([rhs[:, None], Pt], axis=1))
        x0, Y = X[:, 0], X[:, 1:]                 # (P,), (P, p)
        S = mm(Pt.T, Y)                           # (p, p) Schur block
        lam = jnp.linalg.solve(S, mm(Pt.T, x0)[:, None])[:, 0]
        u_new = x0 - mm(Y, lam)
        cost_new, smooth_new, feas_new = cost_of(u_new)
        accept = (cost_new < cost) & jnp.all(jnp.isfinite(u_new))
        u = jnp.where(accept, u_new, u)
        cost = jnp.where(accept, cost_new, cost)
        mu = jnp.clip(jnp.where(accept, mu / 3.0, mu * 5.0), 1e-8, 1e12)
        if not penalized:
            return (u, mu, cost), None
        # track the best FEASIBLE iterate seen (hinge active sets can
        # cycle near the boundary; the returned fit should not depend on
        # which side of the fence the final iterate landed)
        better = feas_new & ((~any_feas) | (smooth_new < best_smooth))
        u_best = jnp.where(better, u_new, u_best)
        best_smooth = jnp.where(better, smooth_new, best_smooth)
        any_feas = any_feas | feas_new
        return (u, mu, cost, u_best, best_smooth, any_feas), None

    # The reduced basis always goes through the damped-LM scan, even at
    # zero penalty: its least-squares normal equations are too ill-
    # conditioned for a single un-damped f32 Cholesky on an accelerator
    # (the 1e-6-ridged direct solve that passes CPU-f32 NaN'd in a
    # blocked device factorization at n=1024, c=256). The LM
    # accept gate rejects non-finite steps and regrows mu, so the scan
    # degrades gracefully where a one-shot solve dies; on a quadratic
    # objective it converges geometrically to the same minimiser.
    if penalized or reduced:
        # u0 = 0, NOT the smooth unpenalized fit: warm-starting from the
        # data-optimal surface was tried and stalls — its deep butterfly
        # violations (g ~ -0.7) sit where the g-linearisation is ill-
        # conditioned, LM rejects steps and mu grows until progress
        # stops (~-0.6 after 24 iters vs full repair from zero).
        u0 = jnp.zeros((c + p,), dtype)
        cost0, smooth0, _ = cost_of(u0)
        if penalized:
            state0 = (u0, jnp.asarray(1e-4, dtype), cost0, u0,
                      jnp.asarray(jnp.inf, dtype), jnp.zeros((), bool))
            (u_last, _, _, u_best, _, any_feas), _ = jax.lax.scan(
                lm_step, state0, None, length=n_iters)
            # best-FEASIBLE tracking is the penalized solver's contract
            u = jnp.where(any_feas, u_best, u_last)
        else:
            # zero penalty, reduced basis: routed through the damped
            # scan for f32 robustness only. The caller asked for the
            # plain data-optimal fit — the converged iterate — like
            # fit_rbf/SciPy, so no feasibility state is carried (or
            # computed) at all.
            state0 = (u0, jnp.asarray(1e-4, dtype), cost0)
            (u, _, _), _ = jax.lax.scan(
                lm_step, state0, None, length=n_iters)
    else:
        # zero penalty: the objective is quadratic and its stationarity
        # is the WEIGHTED smoothing-RBF saddle system
        #   (W K + s_eff I) c + W P p = W y,   P^T c = 0
        # (substitute W(Kc+Pp-y) = -s c into the KKT conditions) —
        # solved directly, which avoids squaring the Gram's condition
        # number the way the normal-equations path would. Uniform
        # weights reduce it to SciPy RBFInterpolator's system exactly.
        s_eff = smoothing + 1e-12  # weight-0 rows need s > 0
        lhs = jnp.concatenate([
            jnp.concatenate([wts[:, None] * K_dc
                             + s_eff * jnp.eye(n, dtype=dtype),
                             wts[:, None] * P_d], axis=1),
            jnp.concatenate([P_d.T, jnp.zeros((p, p), dtype)], axis=1),
        ], axis=0)
        rhs = jnp.concatenate([wts * values, jnp.zeros((p,), dtype)])
        u = jnp.linalg.solve(lhs, rhs)

    coef, poly_c = u[:c], u[c:]
    poly = jnp.zeros((3,), dtype).at[:p].set(poly_c)
    w_fit = mm(A_g, u).reshape(n_pen_t, n_pen_k)
    g_fit, _, _ = _g_partials(kg_row, w_fit, _fd1(w_fit, h_k),
                              _fd2(w_fit, h_k))
    return {
        "points": centers, "coef": coef, "poly": poly,
        "pen_k_grid": kg, "pen_t_grid": tg,
        "pen_w": w_fit, "pen_g": g_fit,
        "butterfly_ok": jnp.all(g_fit >= -1e-8),
        "calendar_ok": jnp.all(w_fit[1:] - w_fit[:-1] >= -1e-10),
    }


def fit_eval_rbf_arbfree_batched(points, values, query, weights=None,
                                 **kw):
    """Batched arbitrage-penalized fit+eval: leading batch dim on
    points/values/query (and optional weights). Returns (w_query (B, M),
    butterfly_ok (B,), calendar_ok (B,)) — flags measured on the penalty
    grid."""
    kernel = kw.get("kernel", "thin_plate")
    epsilon = kw.get("epsilon", 1.0)

    def one(p, v, q, wt):
        f = fit_rbf_arbfree(p, v, weights=wt, **kw)
        return (eval_rbf(f, q, kernel=kernel, epsilon=epsilon),
                f["butterfly_ok"], f["calendar_ok"])

    if weights is None:
        weights = jnp.ones_like(values)
    return jax.vmap(one)(points, values, query, weights)
