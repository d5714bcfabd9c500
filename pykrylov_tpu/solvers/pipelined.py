"""Pipelined (communication-hiding) conjugate gradients.

No reference counterpart — this is the JAX-native scaling variant of CG
for sharded systems, after Ghysels & Vanroose's pipelined CG (see
PAPERS.md: arXiv:1801.04728, arXiv:1706.05988, arXiv:2105.06176).

Classic CG has two dependent global reductions per iteration (``r'u`` and
``p'Ap``), each a ``psum`` barrier on a mesh.  The pipelined recurrence
computes both dot products from the *same* vectors so they fuse into ONE
reduction per iteration, and that reduction is independent of the
iteration's preconditioner apply + matvec (``m = M w; n = A m``) — the
compiler can overlap the collective with the local compute.  The price is
four extra axpys and recurrence-induced rounding drift; the optional
``replace_every`` residual replacement (the stabilization studied in
arXiv:1706.05988) recomputes ``r = b - A x`` periodically to arrest the
drift at the cost of one extra matvec per replacement.

State recurrences (preconditioned pipelined CG):

    gamma = r'u,  delta = w'u            (fused reduction)
    m = M w ; n = A m                    (overlaps the reduction)
    beta = gamma/gamma_old ; alpha = gamma / (delta - beta*gamma/alpha_old)
    z <- n + beta z ; q <- m + beta q ; s <- w + beta s ; p <- u + beta p
    x <- x + alpha p ; r <- r - alpha s ; u <- u - alpha q ; w <- w - alpha z
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import (as_operator, apply_op, threshold_of, history_init,
                     history_push, default_maxiter, promote_rhs, require_square)
from .result import SolveResult

__all__ = ["cg_pipelined", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
}


@partial(jax.jit, static_argnames=("maxiter", "replace_every",
                                   "store_history"))
def _cg_pipelined(A, b, x0, M, rtol, atol, maxiter, replace_every,
                  store_history):
    dtype = b.dtype
    n = b.shape[0]

    def precon(v):
        return apply_op(M, v) if M is not None else v

    if x0 is None:
        x = jnp.zeros(n, dtype=dtype)
        r = b
        nmv0 = 0
    else:
        x = x0.astype(dtype)
        r = b - apply_op(A, x)
        nmv0 = 1

    u = precon(r)
    w = apply_op(A, u)
    gamma = jnp.vdot(r, u).real.astype(dtype)
    resid0 = jnp.sqrt(jnp.abs(gamma))
    thresh = threshold_of(resid0, rtol, atol)
    hist = history_init(store_history, maxiter, resid0.dtype)
    hist = history_push(hist, 0, resid0)

    zero = jnp.zeros((), dtype)
    zeros_n = jnp.zeros(n, dtype)
    state0 = dict(
        x=x, r=r, u=u, w=w,
        z=zeros_n, q=zeros_n, s=zeros_n, p=zeros_n,
        gamma=gamma, alpha=jnp.ones((), dtype), beta=zero,
        resid=resid0, k=jnp.zeros((), jnp.int32),
        nmv=jnp.asarray(nmv0 + 1, jnp.int32),
        done=(resid0 <= thresh), hist=hist)

    def cond(st):
        return ~st["done"] & (st["k"] < maxiter)

    def body(st):
        # ONE fused reduction per iteration: both dots share operands
        # (with sharded inputs XLA emits a single combined psum), and the
        # convergence test reuses gamma instead of adding a reduction.
        gamma = jnp.vdot(st["r"], st["u"]).real.astype(dtype)
        delta = jnp.vdot(st["w"], st["u"]).real.astype(dtype)
        resid = jnp.sqrt(jnp.abs(gamma))

        def finish(_):
            return dict(st, resid=resid, done=True,
                        hist=history_push(st["hist"], st["k"], resid))

        def step(_):
            k = st["k"] + 1
            # Independent local work the reduction overlaps with.
            m = precon(st["w"])
            nvec = apply_op(A, m)

            first = st["k"] == 0
            beta = jnp.where(first, zero, gamma / st["gamma"])
            alpha = jnp.where(
                first, gamma / delta,
                gamma / (delta - beta * gamma / st["alpha"]))

            z = nvec + beta * st["z"]
            q = m + beta * st["q"]
            s = st["w"] + beta * st["s"]
            p = st["u"] + beta * st["p"]
            x = st["x"] + alpha * p
            r = st["r"] - alpha * s
            u = st["u"] - alpha * q
            w = st["w"] - alpha * z
            nmv = st["nmv"] + 1

            if replace_every:
                # Full residual replacement (Cools & Vanroose, see
                # arXiv:1706.05988): ALL coupled recurrences are restored
                # to their true values — replacing only r/u/w leaves
                # s/q/z inconsistent and makes the drift worse.
                def replace(ops):
                    x, r, u, w, s, q, z, nmv = ops
                    r2 = b - apply_op(A, x)
                    u2 = precon(r2)
                    w2 = apply_op(A, u2)
                    s2 = apply_op(A, p)
                    q2 = precon(s2)
                    z2 = apply_op(A, q2)
                    return x, r2, u2, w2, s2, q2, z2, nmv + 4

                x, r, u, w, s, q, z, nmv = jax.lax.cond(
                    k % replace_every == 0, replace,
                    lambda ops: ops, (x, r, u, w, s, q, z, nmv))

            return dict(
                x=x, r=r, u=u, w=w, z=z, q=q, s=s, p=p,
                gamma=gamma, alpha=alpha, beta=beta,
                resid=resid, k=k, nmv=nmv, done=False,
                hist=history_push(st["hist"], st["k"], resid))

        return jax.lax.cond(resid <= thresh, finish, step, None)

    st = jax.lax.while_loop(cond, body, state0)
    converged = st["resid"] <= thresh
    istop = jnp.where(converged, 0, 1).astype(jnp.int32)
    return SolveResult(
        x=st["x"], converged=converged, istop=istop,
        n_iter=st["k"], n_matvec=st["nmv"],
        resid_norm=st["resid"], resid_norm0=resid0,
        resid_history=st["hist"], info={})


def cg_pipelined(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
                 maxiter=None, matvec_max=None, replace_every=0,
                 store_history=False):
    """Solve SPD ``A x = b`` by pipelined (communication-hiding) CG.

    Same contract as :func:`cg`; prefer this variant for row-sharded
    systems on multi-chip meshes where reduction latency matters.
    ``replace_every=k`` restores ALL coupled recurrences to their true
    values every k iterations (4 extra operator applications each time).
    Recommended: ~50 in float64; ~10 in float32 for ill-conditioned
    systems — with k=10 the f32 iteration count matches classic CG on the
    cond~1e7 1138bus system, where the unstabilized recurrence stalls at
    ~1e-3 relative residual.

    Returns :class:`SolveResult`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "cg_pipelined")
    if maxiter is None:
        maxiter = default_maxiter(b.shape[0], 1, matvec_max)
    x0 = jnp.asarray(x0) if x0 is not None else None
    return _cg_pipelined(A, b, x0, M, rtol, atol, int(maxiter),
                         int(replace_every), bool(store_history))
