"""Every contraction inside the LM fits states full f32 precision.

An f32 ``dot_general`` at DEFAULT precision may run in TF32 on Hopper
tensor cores (about three decimal digits), which silently degrades the
fitted parameters while the fit still converges. The jaxpr is the same on
every backend, so this CPU check pins the policy the GPU relies on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iv_engine.ops.essvi import fit_essvi_batched
from iv_engine.ops.rbf import fit_eval_rbf_arbfree_batched
from iv_engine.ops.svi import fit_svi_batched


def _default_precision_dots(jaxpr):
    """Names of dot_general equations (recursively, through scans,
    loops, conds and nested jits) that leave precision at DEFAULT."""
    bad = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            prec = eqn.params.get("precision")
            if prec is None or any(
                    p in (None, jax.lax.Precision.DEFAULT)
                    for p in (prec if isinstance(prec, tuple) else (prec,))):
                bad.append(str(eqn))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            bad += _default_precision_dots(sub)
    return bad


def _svi(k, w):
    return fit_svi_batched(k, w, max_iters=2, init="quasi")


def _essvi(k, w):
    return fit_essvi_batched(k, w, max_iters=2)


def _rbf(k, w):
    T = jnp.linspace(0.1, 1.0, 3, dtype=k.dtype)
    pts = jnp.stack([k.reshape(-1), jnp.repeat(T, k.shape[-1])], axis=-1)
    return fit_eval_rbf_arbfree_batched(
        pts[None], w.reshape(1, -1), pts[None, :8], n_iters=2)


@pytest.mark.parametrize("fit", [_svi, _essvi, _rbf],
                         ids=["svi", "essvi", "rbf"])
def test_fit_contractions_run_at_highest_precision(fit):
    k = jnp.broadcast_to(jnp.linspace(-0.5, 0.5, 8, dtype=jnp.float32),
                         (1, 3, 8))
    T = jnp.linspace(0.1, 1.0, 3, dtype=jnp.float32)
    w = (0.04 + 0.1 * k * k) * T[None, :, None]
    jaxpr = jax.make_jaxpr(fit)(k, w)
    bad = _default_precision_dots(jaxpr.jaxpr)
    assert not bad, "\n".join(bad[:5])
    assert np.isfinite(np.asarray(jax.tree.leaves(fit(k, w))[0])).all()
