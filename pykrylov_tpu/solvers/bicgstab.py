"""Bi-CGSTAB as a fused ``lax.while_loop``.

JAX-native redesign of the reference Bi-CGSTAB
(``/root/reference/pykrylov/bicgstab/bicgstab.py:9-151``, Van der Vorst '92
in Kelley's preconditioned form).  The reference runs a host loop with 2
matvecs, 6 dots and 6 axpys per iteration and can exit *mid-iteration* when
the intermediate residual ``s`` is already small
(``bicgstab.py:107-114``: ``x += alpha*q`` and stop).  Here the whole
iteration is one device program: the mid-iteration exit is a ``lax.cond``
that skips the second half-step (and its matvec), so the on-device matvec
count matches the reference exactly.

Preserved semantics (SURVEY §2.3):
  * stopping threshold ``max(abstol, reltol * ||r0||)``;
  * ``matvec_max`` cap (default 2n), checked after each matvec;
  * an initial guess costs one extra *counted* matvec
    (``bicgstab.py:61-63`` — unlike CGS/TFQMR, Bi-CGSTAB counts it);
  * ``rho_next = -omega * (r0' t)`` update rule (``bicgstab.py:127``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import (as_operator, apply_op, threshold_of, history_init,
                     history_push, default_maxiter, promote_rhs, require_square,
                     dotu)
from .result import SolveResult

__all__ = ["bicgstab", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    3: "breakdown: rho, r0'v or t't vanished / residual not finite",
}


@partial(jax.jit, static_argnames=("maxiter", "matvec_max", "store_history"))
def _bicgstab(A, b, x0, M, rtol, atol, maxiter, matvec_max, store_history):
    dtype = b.dtype
    n = b.shape[0]

    if x0 is None:
        x = jnp.zeros(n, dtype=dtype)
        r0 = b
        nmv0 = 0
    else:
        x = x0.astype(dtype)
        r0 = b - apply_op(A, x)
        nmv0 = 1

    # Unconjugated dots (reference np.dot semantics): correct for complex
    # unsymmetric systems; residual norms stay real.
    rho_next = dotu(r0, r0)
    resid0 = jnp.abs(jnp.sqrt(rho_next)).real
    thresh = threshold_of(resid0, rtol, atol)
    hist = history_init(store_history, maxiter, resid0.dtype)
    hist = history_push(hist, 0, resid0)

    one = jnp.ones((), dtype)
    state0 = dict(
        x=x, r=r0, p=jnp.zeros(n, dtype), v=jnp.zeros(n, dtype),
        rho=one, rho_next=rho_next, alpha=one, omega=one,
        resid=resid0, k=jnp.zeros((), jnp.int32),
        nmv=jnp.asarray(nmv0, jnp.int32),
        broken=~jnp.isfinite(resid0),
        done=(resid0 <= thresh) | (nmv0 >= matvec_max)
             | ~jnp.isfinite(resid0),
        hist=hist)

    def cond(s):
        return ~s["done"]

    def body(s):
        beta = (s["rho_next"] / s["rho"]) * (s["alpha"] / s["omega"])
        rho = s["rho_next"]
        p = s["r"] + beta * (s["p"] - s["omega"] * s["v"])
        q = apply_op(M, p) if M is not None else p
        v = apply_op(A, q)
        nmv = s["nmv"] + 1
        denom = dotu(r0, v)
        alpha = rho / denom
        svec = s["r"] - alpha * v
        resid_s = jnp.linalg.norm(svec)

        # Breakdown guard: zero shadow products or non-finite residuals
        # mean the recurrence is dead; stop with the best iterate instead
        # of spinning NaNs to the matvec cap (the reference spins; scipy
        # reports info=-10 on the same systems, e.g. jpwh_991 with r0=b).
        broken1 = ((denom == 0) | ~jnp.isfinite(denom) | (rho == 0)
                   | ~jnp.isfinite(resid_s))

        def on_break(_):
            return dict(s, k=s["k"] + 1, nmv=nmv, broken=True, done=True)

        early = resid_s <= thresh
        capped = nmv >= matvec_max

        def finish_early(_):
            # ``bicgstab.py:107-114``: accept the half-step and stop.
            x2 = jnp.where(early, s["x"] + alpha * q, s["x"])
            return dict(s, x=x2, r=svec, p=p, v=v, rho=rho, alpha=alpha,
                        resid=resid_s, k=s["k"] + 1, nmv=nmv, done=True,
                        hist=history_push(s["hist"], s["k"] + 1, resid_s))

        def second_half(_):
            z = apply_op(M, svec) if M is not None else svec
            t = apply_op(A, z)
            nmv2 = nmv + 1
            tt = dotu(t, t)
            omega = dotu(t, svec) / tt
            rho_next = -omega * dotu(r0, t)
            r = svec - omega * t
            x2 = s["x"] + omega * z + alpha * q
            resid = jnp.linalg.norm(r)
            broken2 = (tt == 0) | ~jnp.isfinite(resid)
            keep = ~jnp.isfinite(resid)
            x2 = jnp.where(keep, s["x"], x2)
            resid = jnp.where(keep, s["resid"], resid)
            done = (resid <= thresh) | (nmv2 >= matvec_max) | broken2
            return dict(x=x2, r=r, p=p, v=v, rho=rho, rho_next=rho_next,
                        alpha=alpha, omega=omega, resid=resid,
                        k=s["k"] + 1, nmv=nmv2, broken=broken2, done=done,
                        hist=history_push(s["hist"], s["k"] + 1, resid))

        def not_broken(_):
            return jax.lax.cond(early | capped, finish_early, second_half,
                                None)

        return jax.lax.cond(broken1, on_break, not_broken, None)

    s = jax.lax.while_loop(cond, body, state0)
    converged = s["resid"] <= thresh
    istop = jnp.where(converged, 0,
                      jnp.where(s["broken"], 3, 1)).astype(jnp.int32)
    return SolveResult(
        x=s["x"], converged=converged, istop=istop,
        n_iter=s["k"], n_matvec=s["nmv"],
        resid_norm=s["resid"], resid_norm0=resid0,
        resid_history=s["hist"], info={})


def bicgstab(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
             matvec_max=None, store_history=False, verify_final=False):
    """Solve unsymmetric ``A x = b`` by Bi-CGSTAB.

    Parameters mirror :func:`pykrylov_tpu.solvers.cg`; ``M`` is applied as a
    right preconditioner on the search directions as in the reference
    (``bicgstab.py:96-100,118-121``).

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
    require_square(A, b, "bicgstab")
    n = b.shape[0]
    if matvec_max is None:
        matvec_max = 2 * n
    maxiter = int(matvec_max)  # <=1 matvec-pair per iteration; safe cap
    x0 = jnp.asarray(x0) if x0 is not None else None
    res = _bicgstab(A, b, x0, M, rtol, atol, maxiter, int(matvec_max),
                     bool(store_history))
    if verify_final:
        from .common import attach_true_residual
        res = attach_true_residual(A, b, res)
    return res
