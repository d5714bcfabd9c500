"""Transpose-Free QMR (TFQMR) as a fused ``lax.while_loop``.

JAX-native redesign of the reference TFQMR
(``/root/reference/pykrylov/tfqmr/tfqmr.py:7-159``, Freund '93 /
Kelley-style).  Each outer iteration performs two half-steps; each half
updates the quasi-residual ``residNorm *= theta * c`` and tests
``residNorm * sqrt(m+1) < threshold`` (``tfqmr.py:95-123``).  The two
half-steps plus the direction refresh are encoded as ``lax.cond``-gated
stages inside a single device loop so the matvec count matches the
reference exactly (2 matvecs with A per full iteration, 3 precon solves).

Preserved semantics (SURVEY §2.3):
  * quasi-residual update and ``sqrt(m+1)`` safety factor in the
    convergence test (strict ``<`` as in the reference);
  * ``matvec_max`` cap (default 2n);
  * quirk kept for matvec-count parity: the matvec forming
    ``r0 = b - A x0`` for a supplied guess is **not** counted
    (``tfqmr.py:59-60``);
  * no adjoint products required (``tfqmr.py:17-19``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import (as_operator, apply_op, threshold_of, history_init,
                     history_push, promote_rhs, require_square, dotu)
from .result import SolveResult

__all__ = ["tfqmr", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "quasi-residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    3: "breakdown: rho or sigma vanished / residual not finite",
}


@partial(jax.jit, static_argnames=("maxiter", "matvec_max", "store_history"))
def _tfqmr(A, b, x0, M, rtol, atol, maxiter, matvec_max, store_history):
    dtype = b.dtype
    n = b.shape[0]

    if x0 is None:
        x = jnp.zeros(n, dtype=dtype)
        r0 = b
    else:
        x = x0.astype(dtype)
        r0 = b - apply_op(A, x)  # not counted (tfqmr.py:59-60)

    # Unconjugated dots (reference np.dot semantics) keep the recurrence
    # correct for complex systems; theta/c/residNorm are real, while
    # rho/alpha/eta follow the (possibly complex) system dtype.
    rho = dotu(r0, r0)
    rdtype = jnp.zeros((), dtype).real.dtype
    resid0 = jnp.abs(jnp.sqrt(rho)).real.astype(rdtype)
    thresh = threshold_of(resid0, rtol, atol)
    hist = history_init(store_history, maxiter, resid0.dtype)
    hist = history_push(hist, 0, resid0)

    started = resid0 > thresh
    # Pre-loop: z = M y; u = A z (one counted matvec) — tfqmr.py:78-86.
    y = r0
    z = apply_op(M, y) if M is not None else y
    u = jax.lax.cond(started, lambda _: apply_op(A, z),
                     lambda _: jnp.zeros(n, dtype), None)
    zero = jnp.zeros((), dtype)
    rzero = jnp.zeros((), rdtype)
    state0 = dict(
        x=x, w=r0, y=y, z=z, u=u, v=u, d=jnp.zeros(n, dtype),
        theta=rzero, eta=zero, rho=rho, resid=resid0, m=rzero,
        k=jnp.zeros((), jnp.int32),
        nmv=jnp.where(started, 1, 0).astype(jnp.int32),
        broken=~jnp.isfinite(resid0),
        done=~started | ~jnp.isfinite(resid0), hist=hist)

    def half_step(s, w, d, x, alpha, u, z, resid):
        """One quasi-minimization half-step (tfqmr.py:93-104,108-123)."""
        w2 = w - alpha * u
        scale = jnp.where(s["theta"] == 0, zero,
                          (s["theta"] * s["theta"] / alpha) * s["eta"])
        d2 = z + scale * d
        theta2 = (jnp.linalg.norm(w2) / resid).astype(rdtype)
        c = 1.0 / jnp.sqrt(1.0 + theta2 * theta2)
        resid2 = (resid * theta2 * c).astype(rdtype)
        eta2 = (c * c) * alpha
        x2 = x + eta2 * d2
        return w2, d2, x2, theta2, eta2, resid2

    def cond(s):
        return ~s["done"]

    def body(s):
        k = s["k"] + 1
        sigma = dotu(r0, s["v"])
        alpha = s["rho"] / sigma
        # Breakdown guard: dead recurrence -> stop with the best iterate
        # (the reference spins NaNs to the matvec cap).
        broken0 = ((sigma == 0) | ~jnp.isfinite(sigma) | (s["rho"] == 0)
                   | ~jnp.isfinite(s["resid"]))

        def on_break(_):
            return dict(s, k=k, broken=True, done=True)

        # First half-step.
        w, d, x, theta, eta, resid = half_step(
            s, s["w"], s["d"], s["x"], alpha, s["u"], s["z"], s["resid"])
        m = 2.0 * k.astype(rdtype) - 1.0
        stop1 = ((resid * jnp.sqrt(m + 1) < thresh)
                 | (s["nmv"] >= matvec_max) | ~jnp.isfinite(resid))

        def after_first(_):
            # Non-finite restore (contract: breakdown keeps the best
            # finite iterate, as in cgs/bicgstab).
            keep = ~jnp.isfinite(resid)
            x1 = jnp.where(keep, s["x"], x)
            r1 = jnp.where(keep, s["resid"], resid)
            return dict(s, x=x1, w=w, d=d, theta=theta, eta=eta, resid=r1,
                        m=m, k=k, broken=s["broken"] | keep, done=True,
                        hist=history_push(s["hist"], k, r1))

        def second(_):
            m2 = m + 1.0
            y2 = s["y"] - alpha * s["v"]
            z2 = apply_op(M, y2) if M is not None else y2
            u2 = apply_op(A, z2)
            nmv2 = s["nmv"] + 1
            s1 = dict(s, theta=theta, eta=eta)
            w2, d2, x2, theta2, eta2, resid2 = half_step(
                s1, w, d, x, alpha, u2, z2, resid)
            stop2 = ((resid2 * jnp.sqrt(m2 + 1) < thresh)
                     | (nmv2 >= matvec_max) | ~jnp.isfinite(resid2))

            def after_second(_):
                keep = ~jnp.isfinite(resid2)
                x3 = jnp.where(keep, s["x"], x2)
                r3 = jnp.where(keep, s["resid"], resid2)
                return dict(s, x=x3, w=w2, y=y2, z=z2, u=u2, d=d2,
                            theta=theta2, eta=eta2, resid=r3, m=m2,
                            k=k, nmv=nmv2, broken=s["broken"] | keep,
                            done=True,
                            hist=history_push(s["hist"], k, r3))

            def refresh(_):
                # Direction refresh (tfqmr.py:128-151).
                rho_next = dotu(r0, w2)
                beta = rho_next / s["rho"]
                y3 = w2 + beta * y2
                v_part = beta * (beta * s["v"] + u2)
                z3 = apply_op(M, y3) if M is not None else y3
                u3 = apply_op(A, z3)
                nmv3 = nmv2 + 1
                v3 = v_part + u3
                # Non-finite mid-loop: stop now with the previous iterate
                # rather than committing NaNs for one more round.
                bad = ~jnp.isfinite(resid2)
                x3 = jnp.where(bad, s["x"], x2)
                r3 = jnp.where(bad, s["resid"], resid2)
                done = (nmv3 >= matvec_max) | bad
                return dict(x=x3, w=w2, y=y3, z=z3, u=u3, v=v3, d=d2,
                            theta=theta2, eta=eta2, rho=rho_next,
                            resid=r3, m=m2, k=k, nmv=nmv3,
                            broken=bad, done=done,
                            hist=history_push(s["hist"], k, r3))

            return jax.lax.cond(stop2, after_second, refresh, None)

        def not_broken(_):
            return jax.lax.cond(stop1, after_first, second, None)

        return jax.lax.cond(broken0, on_break, not_broken, None)

    s = jax.lax.while_loop(cond, body, state0)
    converged = s["resid"] * jnp.sqrt(s["m"] + 1) < thresh
    istop = jnp.where(converged, 0,
                      jnp.where(s["broken"], 3, 1)).astype(jnp.int32)
    return SolveResult(
        x=s["x"], converged=converged, istop=istop,
        n_iter=s["k"], n_matvec=s["nmv"],
        resid_norm=s["resid"], resid_norm0=resid0,
        resid_history=s["hist"], info={"quasi_residual": s["resid"]})


def tfqmr(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
          matvec_max=None, store_history=False, verify_final=False):
    """Solve unsymmetric ``A x = b`` by the transpose-free QMR method.

    ``resid_norm`` in the result is Freund's *quasi-residual* norm, as in
    the reference (``tfqmr.py:95-98``): it upper-bounds the true residual
    via ``||r|| <= residNorm * sqrt(m+1)``.

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
    require_square(A, b, "tfqmr")
    n = b.shape[0]
    if matvec_max is None:
        matvec_max = 2 * n
    maxiter = max(1, int(matvec_max) // 2 + 1)
    x0 = jnp.asarray(x0) if x0 is not None else None
    res = _tfqmr(A, b, x0, M, rtol, atol, maxiter, int(matvec_max),
                  bool(store_history))
    if verify_final:
        from .common import attach_true_residual
        res = attach_true_residual(A, b, res)
    return res
