"""Preconditioned conjugate gradients as a fused ``lax.while_loop``.

JAX-native redesign of the reference CG (``/root/reference/pykrylov/cg/
cg.py:9-165``).  The reference runs a host Python loop with one matvec, two
dots and three axpys per iteration and checks scalars on the host every
pass; here the whole iteration is one jit-compiled ``lax.while_loop`` with
an on-device convergence predicate, so a solve is a single device program
regardless of iteration count.

Preserved semantics (SURVEY §2.3):
  * preconditioned residual norm ``residNorm = sqrt(r'·M r)`` drives the
    stopping rule ``max(abstol, reltol · residNorm0)`` (``cg.py:99-102``);
  * ``matvec_max`` cap (default 2n) on operator applications;
  * optional curvature check: if ``p'Ap <= 0`` the method aborts, flags the
    operator indefinite and returns the direction of (near-)infinite
    descent for trust-region callers (``cg.py:119-124``);
  * optional residual history (``cg.py:101,155``) as a fixed device buffer.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import (as_operator, apply_op, threshold_of, history_init,
                     history_push, default_maxiter, promote_rhs, require_square)
from .ffmv import resolve_ff_matvec as _resolve_ff  # noqa: F401 (re-export)
from .result import SolveResult

__all__ = ["cg", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "matvec budget exhausted before convergence",
    2: "operator appears indefinite: nonpositive curvature encountered",
}


@partial(jax.jit, static_argnames=("maxiter", "check_curvature",
                                   "store_history", "store_iterates",
                                   "store_resids", "replace_every",
                                   "ff_mv", "leg_rtol"))
def _cg(A, b, x0, M, rtol, atol, maxiter, check_curvature, store_history,
        store_iterates, store_resids, replace_every=None, ff_mv=None,
        leg_rtol=1e-2):
    dtype = b.dtype
    n = b.shape[0]

    if x0 is None:
        x = jnp.zeros(n, dtype=dtype)
        r = b
        extra_matvec = 0
    else:
        x = x0.astype(dtype)
        r = b - apply_op(A, x)
        extra_matvec = 1

    y = apply_op(M, r) if M is not None else r
    ry = jnp.vdot(r, y).real
    # verified path stops on the plain 2-norm of the true residual (see
    # the replacement branch); the reference path on sqrt(r'Mr)
    resid0 = jnp.linalg.norm(r) if replace_every is not None \
        else jnp.sqrt(ry)
    thresh = threshold_of(resid0, rtol, atol)
    hist = history_init(store_history, maxiter, resid0.dtype)
    hist = history_push(hist, 0, resid0)
    # Optional iterate / residual-vector histories (reference
    # ``store_iterates``/``store_resids``, cg.py:66-67,79-80,133-143):
    # fixed (maxiter+1, n) device buffers.
    # The reference stores the PRECONDITIONED residual vectors y = M r
    # (cg.py:97,143), which coincide with r only when M is None.
    iters_buf = (jnp.full((maxiter + 1, n), jnp.nan, dtype=dtype)
                 .at[0].set(x) if store_iterates else None)
    resids_buf = (jnp.full((maxiter + 1, n), jnp.nan, dtype=dtype)
                  .at[0].set(y) if store_resids else None)
    # Per-iteration curvature p'Ap telemetry (the value the reference logs
    # each iteration, cg.py:158) — NaN at row 0 (no curvature yet).
    curv_hist = history_init(store_history, maxiter, resid0.dtype)

    xl0 = jnp.zeros_like(b)  # low parts of x and r (double-f32 carries)

    def cond(carry):
        (x, xl, r, rl, y, p, ry, k, resid, definite, inf_desc, hist, ib,
         rb, cb, nrep, leg_r0) = carry
        return (resid > thresh) & (k < maxiter) & definite

    def body(carry):
        (x, xl, r, rl, y, p, ry, k, resid, definite, inf_desc, hist, ib,
         rb, cb, nrep, leg_r0) = carry
        if replace_every is not None and ff_mv is not None:
            # compensated per-iteration matvec: the legs' f32 matvec
            # rounding is what sets the on-chip floor (~6e-6 relative
            # on 1138bus); with an error-free Ap the recurrence tracks
            # exact CG and the legs descend like the reference's f64
            Ap, Apl = ff_mv(A._params, p, xl0)
            pAp = (jnp.vdot(p, Ap) + jnp.vdot(p, Apl)).real
        else:
            Ap, Apl = apply_op(A, p), None
            pAp = jnp.vdot(p, Ap).real

        def indefinite(_):
            # Record the direction of nonpositive curvature and abort.
            # Telemetry rows for the aborted iteration repeat the current
            # (unchanged) values so the buffers stay finite through
            # n_iter (the reference appends nothing on abort).
            return (x, xl, r, rl, y, p, ry, k + 1, resid,
                    jnp.asarray(False), p,
                    history_push(hist, k + 1, resid),
                    history_push(ib, k + 1, x),
                    history_push(rb, k + 1, y),
                    history_push(cb, k + 1, pAp), nrep, leg_r0)

        def step(_):
            alpha = ry / pAp
            nrep2 = nrep
            leg_r02 = leg_r0
            if replace_every is None:
                r2, rl2 = r - alpha * Ap, rl
                x2, xl2 = x + alpha * p, xl
                y2 = apply_op(M, r2) if M is not None else r2
                ry2 = jnp.vdot(r2, y2).real
                beta = ry2 / ry
                p2 = y2 + beta * p
            else:
                # Verified stopping with residual replacement: in low
                # precision the incremental r drifts O(eps·κ) from
                # b - A x, so an unverified recurrence test is
                # meaningless for ill-conditioned systems (1138bus f32
                # at rtol 1e-4 "converges" at TRUE relres 0.65).  When
                # the recurrence claims convergence — or at most every
                # ``replace_every`` iterations as a drift bound — the
                # true residual is recomputed and the search direction
                # restarted from the verified state (replacing r while
                # keeping the old p was measured to DIVERGE: the stale
                # conjugacy amplifies the discontinuity).  The loop can
                # only exit on a true-residual test.
                #
                # x is carried as a double-f32 (hi, lo) pair (TwoSum /
                # TwoProd accumulation, utils/ff.py) and, when the
                # operator storage supports it, the replacement residual
                # is evaluated with the compensated matvec — the plain
                # f32 matvec floor (~eps·|A||x|, 2.3e-6 relative on
                # 1138bus) sits ABOVE the reference's f64 rtol 1e-6.
                # Each replacement is counted in n_matvec (deviation
                # from the reference, which runs f64; cg.py:129-130).
                # Refinement-leg structure: chasing the final threshold
                # with one continuous f32 recurrence is fragile (the
                # recurrence drifts again within a leg; on-chip the
                # verified floor lands exactly at rtol 1e-6 and
                # convergence becomes build-dependent rounding luck).
                # Each leg targets only a ``leg_rtol`` reduction
                # relative to its own verified starting residual —
                # comfortably inside f32's reliable range — then
                # replaces and restarts: classic iterative refinement
                # with a CG inner solver.  All STOPPING quantities
                # (claims, threshold, reported residual) use the plain
                # 2-norm of the unpreconditioned residual — M only
                # accelerates the legs (unpreconditioned legs of an
                # ill-conditioned system would need thousands of
                # iterations each once the restart discards the Krylov
                # momentum).  This is a documented deviation from the
                # reference's sqrt(r'Mr) stopping rule, active only
                # with ``replace_every``.
                # Both x AND r ride double-f32 carries: the f32
                # r-recurrence alone saturates near 4e-6 relative on
                # chip (its drift noise stalls the legs); with an ff
                # carry the recurrence tracks the exact recurrence of
                # the f32 matvec sequence, and only matvec rounding
                # remains.
                from ..utils.ff import ff_add_ff, two_prod, two_sum
                ps, pe = two_prod(alpha, p)
                x2, xl2 = ff_add_ff(x, xl, ps, pe)
                qs, qe = two_prod(-alpha, Ap)
                if Apl is not None:
                    qe = qe - alpha * Apl
                r2, rl2 = ff_add_ff(r, rl, qs, qe)
                y_cand = apply_op(M, r2) if M is not None else r2
                ry_cand = jnp.vdot(r2, y_cand).real
                res_cand = jnp.linalg.norm(r2)
                claims = res_cand <= jnp.maximum(leg_rtol * leg_r0, thresh)
                do_rep = claims | ((k + 1) % replace_every == 0)

                def _replaced():
                    if ff_mv is not None:
                        sh, sl = ff_mv(A._params, x2, xl2)
                    else:
                        sh = apply_op(A, x2)
                        sl = apply_op(A, xl2)
                    d, de = two_sum(b, -sh)
                    rt, rtl = two_sum(d, de - sl)
                    yt = apply_op(M, rt) if M is not None else rt
                    return (rt, rtl, yt, jnp.vdot(rt, yt).real,
                            jnp.linalg.norm(rt))

                r2, rl2, y2, ry2, resid2 = jax.lax.cond(
                    do_rep, _replaced,
                    lambda: (r2, rl2, y_cand, ry_cand, res_cand))
                nrep2 = nrep + do_rep.astype(jnp.int32)
                leg_r02 = jnp.where(do_rep, resid2, leg_r0)
                beta = ry2 / ry
                p2 = jnp.where(do_rep, y2, y2 + beta * p)
            if replace_every is None:
                resid2 = jnp.sqrt(ry2)
            h2 = history_push(hist, k + 1, resid2)
            ib2 = history_push(ib, k + 1, x2)
            rb2 = history_push(rb, k + 1, y2)
            cb2 = history_push(cb, k + 1, pAp)
            return (x2, xl2, r2, rl2, y2, p2, ry2, k + 1, resid2,
                    definite, inf_desc, h2, ib2, rb2, cb2, nrep2, leg_r02)

        if check_curvature:
            return jax.lax.cond(pAp <= 0, indefinite, step, None)
        return step(None)

    p0 = y
    carry0 = (x, xl0, r, xl0, y, p0, ry, jnp.zeros((), jnp.int32),
              resid0, jnp.asarray(True), jnp.zeros_like(b), hist,
              iters_buf, resids_buf, curv_hist, jnp.zeros((), jnp.int32),
              resid0)
    (x, xl, r, rl, y, p, ry, k, resid, definite, inf_desc, hist,
     iters_buf, resids_buf, curv_hist, nrep, _leg) = jax.lax.while_loop(
        cond, body, carry0)

    converged = resid <= thresh
    istop = jnp.where(converged, 0, jnp.where(definite, 1, 2))
    info = {"definite": definite}
    if replace_every is not None:
        info["n_replacements"] = nrep
        info["x_lo"] = xl
        # compensated replacements are one (ff) matvec; the generic
        # fallback applies A twice (to x_hi and x_lo)
        extra_matvec = extra_matvec + nrep * (1 if ff_mv is not None
                                              else 2)
    if check_curvature:
        info["infinite_descent"] = inf_desc
    if store_iterates:
        info["iterates"] = iters_buf
    if store_resids:
        info["resids"] = resids_buf
    if store_history:
        info["curvatures"] = curv_hist
    return SolveResult(
        x=x, converged=converged, istop=istop.astype(jnp.int32),
        n_iter=k, n_matvec=k + extra_matvec,
        resid_norm=resid, resid_norm0=resid0,
        resid_history=hist, info=info)


def cg(A, b, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8, maxiter=None,
       matvec_max=None, check_curvature=False, store_history=False,
       store_iterates=False, store_resids=False, replace_every=None,
       leg_rtol=1e-2, verify_final=False):
    """Solve SPD ``A x = b`` by preconditioned conjugate gradients.

    Parameters
    ----------
    A : LinearOperator or dense array — symmetric positive definite.
    b : right-hand side vector.
    x0 : optional initial guess (costs one extra matvec, ``cg.py:85-88``).
    M : optional preconditioner operator approximating A^{-1}.
    rtol, atol : stopping rule ``resid <= max(atol, rtol * resid0)`` on the
        preconditioned residual norm sqrt(r'Mr).
    maxiter : iteration cap; default derived from ``matvec_max`` (2n).
    check_curvature : abort on nonpositive curvature and report the
        direction of infinite descent in ``result.info`` (trust-region use).
    store_history : keep the residual-norm history in a device buffer.
    store_iterates : keep every iterate in a (maxiter+1, n) device buffer
        returned as ``result.info["iterates"]`` (NaN rows beyond
        ``n_iter``) — the reference's ``store_iterates`` (cg.py:66-67).
        Memory scales with maxiter*n; prefer ``checkpointed_solve`` for
        long runs.
    store_resids : likewise for the preconditioned residual vectors
        ``y = M r`` (``result.info["resids"]``; reference cg.py:97,143 —
        equal to the raw residuals when ``M`` is None).
    replace_every : enable van der Vorst–Ye residual replacement with
        this period: the true residual ``b - A x`` is recomputed every
        ``replace_every`` iterations and whenever the recurrence claims
        convergence, so the stopping test is verified against the true
        residual.  This is the f32 parity knob: the reference
        runs f64 where the recurrence drift is invisible at its
        tolerances; in f32 the drift makes unverified convergence
        meaningless for ill-conditioned systems (e.g. 1138bus at rtol
        1e-4 stops at TRUE relres ~0.65 without it).  Each replacement
        costs one compensated matvec (two plain applies when the
        operator storage has no compensated path), counted in
        ``n_matvec``;
        ``info["n_replacements"]`` reports how many fired and
        ``info["x_lo"]`` the solution's double-f32 low part.
    leg_rtol : per-leg reduction target between replacements (the inner
        tolerance of the refinement structure); each leg stops at
        ``max(leg_rtol * leg_start_resid, threshold)`` and verifies.

    Returns :class:`SolveResult`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "cg")
    if maxiter is None:
        maxiter = default_maxiter(b.shape[0], 1, matvec_max)
    x0 = jnp.asarray(x0) if x0 is not None else None
    replace_every = int(replace_every) if replace_every else None
    ff_mv = _resolve_ff(A) if replace_every else None
    res = _cg(A, b, x0, M, rtol, atol, int(maxiter),
              bool(check_curvature), bool(store_history),
              bool(store_iterates), bool(store_resids),
              replace_every, ff_mv, float(leg_rtol))
    if verify_final:
        from .common import attach_true_residual
        res = attach_true_residual(A, b, res)
    return res
