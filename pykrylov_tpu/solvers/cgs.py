"""Conjugate Gradient Squared (CGS) as a fused ``lax.while_loop``.

JAX-native redesign of the reference CGS
(``/root/reference/pykrylov/cgs/cgs.py:8-123``, Sonneveld '89).  Two matvecs
with A, three dots, seven axpys per iteration, no adjoint products.  The
host loop becomes one ``lax.while_loop`` whose convergence predicate runs on
device.

Preserved semantics (SURVEY §2.3):
  * stopping threshold ``max(abstol, reltol * ||r0||)`` (``cgs.py:65``);
  * ``matvec_max`` cap (default 2n);
  * the preconditioner is applied to ``p`` and to ``u + q``
    (``cgs.py:78-91``);
  * quirk kept for matvec-count parity: the extra matvec used to form
    ``r0 = b - A x0`` when a guess is supplied is **not** counted
    (``cgs.py:59-60`` increments nothing, unlike Bi-CGSTAB).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import (as_operator, apply_op, threshold_of, history_init,
                     history_push, promote_rhs, require_square, dotu)
from .result import SolveResult

__all__ = ["cgs", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    3: "breakdown: rho or sigma vanished / residual not finite",
}


@partial(jax.jit, static_argnames=("maxiter", "matvec_max", "store_history"))
def _cgs(A, b, x0, M, rtol, atol, maxiter, matvec_max, store_history):
    dtype = b.dtype
    n = b.shape[0]

    if x0 is None:
        x = jnp.zeros(n, dtype=dtype)
        r0 = b
    else:
        x = x0.astype(dtype)
        r0 = b - apply_op(A, x)  # not counted (cgs.py:59-60)

    # Unconjugated dots throughout (reference np.dot semantics) so the
    # recurrence is correct for complex unsymmetric systems too; the
    # residual norms stay real.
    rho = dotu(r0, r0)
    resid0 = jnp.abs(jnp.sqrt(rho)).real  # |sqrt(rho)| as in cgs.py:63
    thresh = threshold_of(resid0, rtol, atol)
    hist = history_init(store_history, maxiter, resid0.dtype)
    hist = history_push(hist, 0, resid0)

    bad0 = ~jnp.isfinite(resid0)  # ||b|| overflowed: nothing to solve
    state0 = dict(
        x=x, r=r0, u=r0, p=r0, rho=rho, resid=resid0,
        k=jnp.zeros((), jnp.int32), nmv=jnp.zeros((), jnp.int32),
        broken=bad0, done=(resid0 <= thresh) | bad0, hist=hist)

    def cond(s):
        return ~s["done"]

    def body(s):
        y = apply_op(M, s["p"]) if M is not None else s["p"]
        v = apply_op(A, y)
        sigma = dotu(r0, v)
        alpha = s["rho"] / sigma
        q = s["u"] - alpha * v
        z = apply_op(M, s["u"] + q) if M is not None else s["u"] + q
        x = s["x"] + alpha * z
        Az = apply_op(A, z)
        nmv = s["nmv"] + 2
        r = s["r"] - alpha * Az
        resid = jnp.linalg.norm(r)
        # Breakdown: a zero rho/sigma or a non-finite residual means the
        # recurrence is dead; stop with the best iterate so far instead of
        # spinning NaNs to the matvec cap (the reference spins,
        # cgs.py:85-118; scipy reports info=-10 on the same systems).
        broken = (sigma == 0) | ~jnp.isfinite(sigma) | ~jnp.isfinite(resid)
        rho_next = dotu(r0, r)
        broken = broken | (rho_next == 0)
        done = (resid <= thresh) | (nmv >= matvec_max) | broken
        # Direction updates (harmless when done; loop exits before use).
        beta = rho_next / s["rho"]
        u = r + beta * q
        p = u + beta * (q + beta * s["p"])
        keep = ~jnp.isfinite(resid)
        x = jnp.where(keep, s["x"], x)
        resid_out = jnp.where(keep, s["resid"], resid)
        return dict(x=x, r=r, u=u, p=p, rho=rho_next, resid=resid_out,
                    k=s["k"] + 1, nmv=nmv, broken=broken, done=done,
                    hist=history_push(s["hist"], s["k"] + 1, resid_out))

    s = jax.lax.while_loop(cond, body, state0)
    converged = s["resid"] <= thresh
    istop = jnp.where(converged, 0,
                      jnp.where(s["broken"], 3, 1)).astype(jnp.int32)
    return SolveResult(
        x=s["x"], converged=converged, istop=istop,
        n_iter=s["k"], n_matvec=s["nmv"],
        resid_norm=s["resid"], resid_norm0=resid0,
        resid_history=s["hist"], info={})


def cgs(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
        matvec_max=None, store_history=False, verify_final=False):
    """Solve unsymmetric ``A x = b`` by the CGS method.

    Parameters mirror :func:`pykrylov_tpu.solvers.cg`; no products with the
    adjoint of ``A`` are required (``cgs.py:18-19``).

    ``verify_final=True`` appends the verified true-residual 2-norm
    as ``info["true_resid_norm"]`` (one uncounted diagnostic matvec,
    compensated when the operator storage supports it) — an f32
    recurrence can claim convergence the true residual does not
    support; see docs/cg.md.

    Returns :class:`SolveResult`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "cgs")
    n = b.shape[0]
    if matvec_max is None:
        matvec_max = 2 * n
    maxiter = max(1, int(matvec_max) // 2)
    x0 = jnp.asarray(x0) if x0 is not None else None
    res = _cgs(A, b, x0, M, rtol, atol, maxiter, int(matvec_max),
                bool(store_history))
    if verify_final:
        from .common import attach_true_residual
        res = attach_true_residual(A, b, res)
    return res
