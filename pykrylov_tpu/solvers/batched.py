"""Multi-right-hand-side solves: fused block-batched CG / Bi-CGSTAB /
CGS / TFQMR / LSQR + a generic column driver.

The reference solves one RHS per call (its solvers hold a single
``self.x``; ``generic/generic.py:79-87``).  On a device that leaves the
dominant cost — streaming the operator out of HBM — unamortized: an
HBM-bound SpMV moves ``A_bytes + x_bytes + y_bytes`` per product, so
solving K systems one by one streams A K times.  ``cg_batched`` runs
one fused ``lax.while_loop`` over an (n, K) block iterate instead: each
iteration applies the operator to ALL K direction columns (one
traced block product — a matmul for dense operators, a
K-column gather/segment product for sparse formats), turning K solves
into ``A_bytes + K·(x+y)_bytes`` of traffic per iteration and a single
device program for the whole family.

Semantics: each column runs EXACTLY the reference CG recurrence
(``/root/reference/pykrylov/cg/cg.py:113-158``) under a per-column
active mask — converged (or curvature-failed) columns freeze: their
``alpha`` is forced to 0 and their direction column is carried
unchanged, so a column's iterate history matches a single-RHS ``cg``
call up to floating-point reduction order (the block product sums in
a different order than the single dot; stopping iterations track
within 1-2 over hundreds of iterations — tested), while
the loop keeps running until every column has stopped or the iteration
cap hits.  Per-column stopping uses the reference rule
``resid_k <= max(atol, rtol * resid0_k)`` on the preconditioned norm
``sqrt(r'M r)``.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .common import (apply_op, as_operator, default_maxiter, promote_rhs,
                     threshold_of)
from .result import SolveResult

__all__ = ["cg_batched", "cg_pipelined_batched",
           "bicgstab_batched", "cgs_batched",
           "tfqmr_batched", "minres_batched", "symmlq_batched",
           "lsqr_batched", "lsmr_batched", "craig_batched",
           "craigmr_batched", "solve_columns", "ISTOP_MSG",
           "ISTOP_MSG_TF", "ISTOP_MSG_LSQR", "ISTOP_MSG_MINRES",
           "ISTOP_MSG_SYMMLQ", "ISTOP_MSG_CRAIG", "ISTOP_MSG_CRAIGMR"]

# cg_batched istop codes (per column); lsqr_batched columns follow the
# LSQR table re-exported below
ISTOP_MSG = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "iteration budget exhausted before convergence",
    2: "operator appears indefinite: nonpositive curvature encountered",
}

from .lsqr import ISTOP_MSG as ISTOP_MSG_LSQR  # noqa: E402


def _apply_block(op, X):
    """Block product ``A @ X`` on an (n, K) column block: the operator's
    native SpMM rule when it has one (the sharded operators ship (w, K)
    halo slices once for all K columns), trace-time vmap otherwise (XLA
    fuses it into one dot_general for dense operators)."""
    mm = getattr(op, "_mm", None)
    if mm is not None:
        return op.apply_with(mm, X)
    return jax.vmap(lambda c: apply_op(op, c), in_axes=1, out_axes=1)(X)


def _col_dot(A, B):
    """Per-column conjugated real inner products ``Re(a_k' b_k)``."""
    return jnp.sum(jnp.conj(A) * B, axis=0).real


def _check_x0(x0, B, name):
    """Validate an initial-guess block: exactly (n, K), or (n,) when the
    rhs arrived as a single column — a size-matching wrong layout (e.g.
    (K, n) row-major guesses) must raise, not silently reshape."""
    if x0 is None:
        return None
    x0 = jnp.asarray(x0)
    if x0.shape == B.shape:
        return x0
    if x0.ndim == 1 and B.shape[1] == 1 and x0.shape[0] == B.shape[0]:
        return x0[:, None]
    from ..ops.base import ShapeError
    raise ShapeError("%s: x0 of shape %s does not match the rhs block %s"
                     % (name, x0.shape, B.shape))


@partial(jax.jit, static_argnames=("maxiter", "check_curvature",
                                   "store_history", "replace_every",
                                   "ff_mm", "leg_rtol"))
def _cg_batched(A, B, X0, M, rtol, atol, maxiter, check_curvature,
                store_history, replace_every=None, ff_mm=None,
                leg_rtol=1e-2):
    dtype = B.dtype
    n, K = B.shape
    verified = replace_every is not None
    if X0 is None:
        X = jnp.zeros((n, K), dtype)
        R = B
        extra = 0
    else:
        X = X0.astype(dtype)
        R = B - _apply_block(A, X)
        extra = 1
    Y = _apply_block(M, R) if M is not None else R
    ry = _col_dot(R, Y)
    # the verified path stops per column on the plain 2-norm of the TRUE
    # residual (same documented deviation as single-RHS cg's
    # replace_every: M only accelerates, it does not define the norm)
    resid0 = (jnp.linalg.norm(R, axis=0) if verified
              else jnp.sqrt(jnp.maximum(ry, 0)))
    thresh = threshold_of(resid0, rtol, atol)
    hist = (jnp.full((maxiter + 1, K), jnp.nan, resid0.dtype)
            .at[0].set(resid0) if store_history else None)

    Z = jnp.zeros((n, K), dtype)  # lo parts of the double-f32 carries
    active0 = resid0 > thresh
    carry0 = (X, Z, R, Z, Y, Y, ry, jnp.zeros((), jnp.int32), resid0,
              active0, jnp.ones(K, bool), jnp.zeros(K, jnp.int32),
              jnp.zeros(K, jnp.int32), jnp.zeros((), jnp.int32), resid0,
              hist)

    def cond(carry):
        k, active = carry[7], carry[9]
        return jnp.any(active) & (k < maxiter)

    def body(carry):
        (X, Xl, R, Rl, Y, P, ry, k, resid, active, definite, iters,
         nrep_cols, nrep_evts, leg_r0, hist) = carry
        if verified and ff_mm is not None:
            # compensated block product: each column's recurrence tracks
            # exact CG of the f32 matvec sequence (cg.py's per-iteration
            # ff path — the plain f32 product floors legs at ~6e-6)
            AP, APl = ff_mm(A._params, P, Z)
            pAp = _col_dot(P, AP) + _col_dot(P, APl)
        else:
            AP, APl = _apply_block(A, P), None
            pAp = _col_dot(P, AP)
        if check_curvature:
            bad = active & (pAp <= 0)
        else:
            bad = jnp.zeros_like(active)
        act = active & ~bad
        # frozen columns get alpha = beta-mix 0 so every array column
        # they own is carried bit-unchanged through the remaining sweeps
        alpha = jnp.where(act, ry / jnp.where(pAp == 0, 1, pAp), 0)
        nrep_cols2, nrep_evts2, leg_r02 = nrep_cols, nrep_evts, leg_r0
        if not verified:
            X2, Xl2 = X + alpha * P, Xl
            R2, Rl2 = R - alpha * AP, Rl
            Y2 = _apply_block(M, R2) if M is not None else R2
            ry2 = _col_dot(R2, Y2)
            beta = jnp.where(act, ry2 / jnp.where(ry == 0, 1, ry), 0)
            P2 = jnp.where(act, Y2 + beta * P, P)
            resid2 = jnp.where(act, jnp.sqrt(jnp.maximum(ry2, 0)), resid)
        else:
            # per-column mirror of single-RHS cg's replace_every branch
            # (see the long rationale in cg.py): X and R ride double-f32
            # (hi, lo) pairs; when a column's recurrence claims its leg
            # target — or every ``replace_every`` iterations as a drift
            # bound — the TRUE residual block is recomputed
            # (compensated when the storage supports it) and that
            # column's direction restarts from the verified state.
            # Columns can only stop on a true-residual test.
            from ..utils.ff import ff_add_ff, two_prod, two_sum
            ps, pe = two_prod(alpha, P)
            X2, Xl2 = ff_add_ff(X, Xl, ps, pe)
            qs, qe = two_prod(-alpha, AP)
            if APl is not None:
                qe = qe - alpha * APl
            R2, Rl2 = ff_add_ff(R, Rl, qs, qe)
            Y_cand = _apply_block(M, R2) if M is not None else R2
            ry_cand = _col_dot(R2, Y_cand)
            res_cand = jnp.linalg.norm(R2, axis=0)
            claims = res_cand <= jnp.maximum(leg_rtol * leg_r0, thresh)
            do_rep = act & (claims | ((k + 1) % replace_every == 0))

            def _replaced():
                if ff_mm is not None:
                    Sh, Sl = ff_mm(A._params, X2, Xl2)
                else:
                    # one fused (n, 2K) product instead of two A streams
                    SS = _apply_block(A, jnp.concatenate([X2, Xl2],
                                                         axis=1))
                    Sh, Sl = SS[:, :K], SS[:, K:]
                D, De = two_sum(B, -Sh)
                Rt, Rtl = two_sum(D, De - Sl)
                R3 = jnp.where(do_rep, Rt, R2)
                Rl3 = jnp.where(do_rep, Rtl, Rl2)
                Y3 = _apply_block(M, R3) if M is not None else R3
                ry3 = _col_dot(R3, Y3)
                res3 = jnp.where(do_rep, jnp.linalg.norm(Rt, axis=0),
                                 res_cand)
                return R3, Rl3, Y3, ry3, res3

            R2, Rl2, Y2, ry2, res2 = jax.lax.cond(
                jnp.any(do_rep), _replaced,
                lambda: (R2, Rl2, Y_cand, ry_cand, res_cand))
            nrep_cols2 = nrep_cols + do_rep.astype(jnp.int32)
            nrep_evts2 = nrep_evts + jnp.any(do_rep).astype(jnp.int32)
            leg_r02 = jnp.where(do_rep, res2, leg_r0)
            beta = jnp.where(act, ry2 / jnp.where(ry == 0, 1, ry), 0)
            P2 = jnp.where(act, jnp.where(do_rep, Y2, Y2 + beta * P), P)
            resid2 = jnp.where(act, res2, resid)
        # a non-finite column freezes like single cg's loop exit (its
        # cond resid > thresh is False for NaN); it reports istop 1
        done = act & ((resid2 <= thresh) | ~jnp.isfinite(resid2))
        h2 = hist if hist is None else hist.at[k + 1].set(
            jnp.where(active, resid2, jnp.nan))
        # mask BOTH halves of the double-f32 pairs for frozen columns:
        # ff_add_ff renormalizes (hi, lo) even under a zero update, and
        # a renormalized hi paired with the stale lo would corrupt the
        # carried value
        return (jnp.where(act, X2, X), jnp.where(act, Xl2, Xl),
                jnp.where(act, R2, R),
                jnp.where(act, Rl2, Rl), jnp.where(act, Y2, Y), P2,
                jnp.where(act, ry2, ry), k + 1, resid2, act & ~done,
                definite & ~bad, iters + active.astype(jnp.int32),
                nrep_cols2, nrep_evts2, leg_r02, h2)

    (X, Xl, R, Rl, Y, P, ry, k, resid, active, definite, iters,
     nrep_cols, nrep_evts, leg_r0, hist) = jax.lax.while_loop(
        cond, body, carry0)

    converged = resid <= thresh
    istop = jnp.where(converged, 0, jnp.where(definite, 1, 2))
    info = {"definite": definite, "n_iter_columns": iters,
            "active_at_exit": active}
    extra_total = extra
    if verified:
        info["n_replacements"] = nrep_cols
        info["x_lo"] = Xl
        # each replacement event is one compensated block product (two
        # plain ones without a compensated storage path)
        extra_total = extra + nrep_evts * (1 if ff_mm is not None else 2)
    return SolveResult(
        x=X, converged=converged, istop=istop.astype(jnp.int32),
        n_iter=k, n_matvec=k + extra_total,
        resid_norm=resid, resid_norm0=resid0,
        resid_history=hist, info=info)


def cg_batched(A, B, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
               maxiter=None, matvec_max=None, check_curvature=False,
               store_history=False, replace_every=None, leg_rtol=1e-2):
    """Solve SPD ``A X = B`` for an (n, K) block of right-hand sides in
    ONE fused while-loop.

    Each column follows the reference CG recurrence and stopping rule
    independently (``/root/reference/pykrylov/cg/cg.py:99-158``) under
    a per-column freeze mask — results match K separate
    :func:`~pykrylov_tpu.solvers.cg` calls up to floating-point
    reduction order — while the
    operator is applied to the whole direction block at once, streaming
    A's data a single time per iteration for all K systems.

    Parameters mirror :func:`~pykrylov_tpu.solvers.cg` (no
    telemetry-buffer options; ``x0`` is an (n, K) block).  ``maxiter``
    caps BLOCK iterations; a column that converges early freezes and
    stops counting (``info["n_iter_columns"]``).

    ``replace_every`` enables VERIFIED per-column stopping, the block
    counterpart of single-RHS cg's residual-replacement mode: ``X`` and
    ``R`` ride double-f32 (hi, lo) column blocks, each column stops
    only on a recomputed TRUE residual (compensated when the operator
    storage supports it — ELL/dense), and every column refines in
    ``leg_rtol``-sized legs relative to its own last verified residual.
    Stopping then uses the plain 2-norm of the unpreconditioned
    residual (same documented deviation as single cg).  The compensated
    block product streams A per column (vmap of the ff matvec), so this
    mode trades the SpMM amortization for the certificate.

    Returns
    -------
    :class:`SolveResult` with per-column fields: ``x`` is (n, K);
    ``converged``/``istop``/``resid_norm``/``resid_norm0`` are (K,)
    arrays; ``resid_history`` (when stored) is (maxiter+1, K) with NaN
    after each column's own stop.  ``n_matvec`` counts BLOCK products
    (each = K column matvecs); ``info["n_iter_columns"]`` the
    per-column iteration counts, ``info["definite"]`` the per-column
    curvature verdicts.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[1] or A.shape[0] != A.shape[1]:
        from ..ops.base import ShapeError
        raise ShapeError("cg_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M)
    if maxiter is None:
        maxiter = default_maxiter(B.shape[0], 1, matvec_max)
    X0 = _check_x0(x0, B, "cg_batched")
    # falsy (0/None) disables the verified mode, mirroring single cg's
    # coercion — replace_every=0 would otherwise reach (k+1) % 0
    replace_every = int(replace_every) if replace_every else None
    ff_mm = None
    if replace_every is not None:
        from .ffmv import resolve_ff_matmat
        ff_mm = resolve_ff_matmat(A)
    return _cg_batched(A, B, X0, M, float(rtol), float(atol), int(maxiter),
                       bool(check_curvature), bool(store_history),
                       replace_every, ff_mm, float(leg_rtol))


def solve_columns(solver, A, B, **kwargs):
    """Generic multi-RHS driver: run ``solver`` once per column of
    ``B`` (host loop, one compile shared across columns) and stack the
    results.

    The pedestrian fallback for methods without a fused block variant
    (:func:`cg_batched` covers CG): per-column results are bitwise
    those of individual calls, nothing is amortized except compilation.
    Returns a list of :class:`SolveResult`, one per column.
    """
    A = as_operator(A)
    B = jnp.asarray(B)
    if B.ndim != 2:
        raise ValueError("solve_columns expects an (n, K) block, got %s"
                         % (B.shape,))
    return [solver(A, B[:, j], **kwargs) for j in range(B.shape[1])]


# ---------------------------------------------------------------------------
# Batched short-recurrence transpose-free family (BiCGSTAB / TFQMR)
# ---------------------------------------------------------------------------

# shared by bicgstab_batched / tfqmr_batched (breakdown code 3 matches the
# single-RHS solvers' tables)
ISTOP_MSG_TF = {
    0: "residual small enough (relative/absolute tolerance reached)",
    1: "iteration budget exhausted before convergence",
    3: "breakdown: recurrence scalar vanished / residual not finite",
}


def _dotu_cols(A, B):
    """Per-column UNCONJUGATED dots (reference np.dot semantics,
    ``bicgstab.py:103``)."""
    return jnp.sum(A * B, axis=0)


def _safe(x):
    return jnp.where(x == 0, 1, x)


@partial(jax.jit, static_argnames=("maxiter", "store_history"))
def _bicgstab_batched(A, B, X0, M, rtol, atol, maxiter, store_history):
    dtype = B.dtype
    n, K = B.shape
    if X0 is None:
        X = jnp.zeros((n, K), dtype)
        R0 = B
        nmv0 = 0
    else:
        X = X0.astype(dtype)
        R0 = B - _apply_block(A, X)
        nmv0 = 1        # counted, as in the reference (bicgstab.py:61-63)
    rho_next = _dotu_cols(R0, R0)
    resid0 = jnp.abs(jnp.sqrt(rho_next)).real
    thresh = threshold_of(resid0, rtol, atol)
    hist = (jnp.full((maxiter + 1, K), jnp.nan, resid0.dtype)
            .at[0].set(resid0) if store_history else None)

    one = jnp.ones(K, dtype)
    finite0 = jnp.isfinite(resid0)
    active0 = (resid0 > thresh) & finite0
    state0 = dict(
        x=X, r=R0, p=jnp.zeros((n, K), dtype), v=jnp.zeros((n, K), dtype),
        rho=one, rho_next=rho_next, alpha=one, omega=one,
        resid=resid0, k=jnp.zeros((), jnp.int32),
        nmv=jnp.full(K, nmv0, jnp.int32),
        broken=~finite0, active=active0, hist=hist)

    def cond(s):
        return jnp.any(s["active"]) & (s["k"] < maxiter)

    def body(s):
        act = s["active"]
        beta = (s["rho_next"] / _safe(s["rho"])) \
            * (s["alpha"] / _safe(s["omega"]))
        rho = s["rho_next"]
        P = jnp.where(act, s["r"] + beta * (s["p"] - s["omega"] * s["v"]),
                      s["p"])
        Q = _apply_block(M, P) if M is not None else P
        V = _apply_block(A, P if M is None else Q)
        nmv = s["nmv"] + act.astype(jnp.int32)
        denom = _dotu_cols(R0, V)
        alpha = rho / _safe(denom)
        S = s["r"] - alpha * V
        resid_s = jnp.linalg.norm(jnp.where(act, S, 0), axis=0)

        broken1 = act & ((denom == 0) | ~jnp.isfinite(denom) | (rho == 0)
                         | ~jnp.isfinite(resid_s))
        go = act & ~broken1
        early = go & (resid_s <= thresh)
        # ``bicgstab.py:107-114``: accept the half-step and stop
        second = go & ~early

        Z = _apply_block(M, S) if M is not None else S
        T = _apply_block(A, Z)
        nmv = nmv + second.astype(jnp.int32)
        tt = _dotu_cols(T, T)
        omega = _dotu_cols(T, S) / _safe(tt)
        rho_n2 = -omega * _dotu_cols(R0, T)
        Rn = S - omega * T
        Xn = s["x"] + omega * Z + alpha * Q
        resid_f = jnp.linalg.norm(jnp.where(second, Rn, 0), axis=0)
        broken2 = second & ((tt == 0) | ~jnp.isfinite(resid_f))
        keep = second & ~jnp.isfinite(resid_f)

        # per-column merge: frozen -> unchanged; early -> half-step;
        # second -> full step (non-finite restores the previous iterate)
        x2 = jnp.where(early, s["x"] + alpha * Q,
                       jnp.where(second & ~keep, Xn, s["x"]))
        r2 = jnp.where(early, S, jnp.where(second, Rn, s["r"]))
        resid2 = jnp.where(early, resid_s,
                           jnp.where(second & ~keep, resid_f, s["resid"]))
        done = early | (second & ((resid2 <= thresh) | broken2)) | broken1
        h2 = s["hist"]
        if h2 is not None:
            h2 = h2.at[s["k"] + 1].set(jnp.where(act, resid2, jnp.nan))
        return dict(
            x=x2, r=r2, p=jnp.where(act, P, s["p"]),
            v=jnp.where(act, V, s["v"]),
            rho=jnp.where(go, rho, s["rho"]),
            rho_next=jnp.where(second, rho_n2, s["rho_next"]),
            alpha=jnp.where(go, alpha, s["alpha"]),
            omega=jnp.where(second, omega, s["omega"]),
            resid=resid2, k=s["k"] + 1, nmv=nmv,
            broken=s["broken"] | broken1 | broken2 | keep,
            active=act & ~done, hist=h2)

    s = jax.lax.while_loop(cond, body, state0)
    converged = s["resid"] <= thresh
    istop = jnp.where(converged, 0, jnp.where(s["broken"], 3, 1))
    info = {"n_matvec_columns": s["nmv"], "active_at_exit": s["active"]}
    return SolveResult(
        x=s["x"], converged=converged, istop=istop.astype(jnp.int32),
        n_iter=s["k"], n_matvec=jnp.max(s["nmv"]),
        resid_norm=s["resid"], resid_norm0=resid0,
        resid_history=s["hist"], info=info)


def bicgstab_batched(A, B, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
                     maxiter=None, matvec_max=None, store_history=False):
    """Solve unsymmetric ``A X = B`` for an (n, K) block of right-hand
    sides in ONE fused while-loop.

    Each column follows the reference Bi-CGSTAB recurrence
    (``/root/reference/pykrylov/bicgstab/bicgstab.py:43-151``) under a
    per-column freeze mask, including the mid-iteration half-step exit
    (``bicgstab.py:107-114``) and the breakdown guards of the
    single-RHS :func:`~pykrylov_tpu.solvers.bicgstab` — while both A
    products per iteration apply to the whole direction block,
    streaming the operator once for all K systems.

    ``maxiter`` caps BLOCK iterations (default ``matvec_max`` / 2 with
    the reference's 2n matvec budget); per-column matvec counts follow
    the reference accounting (+1 first product, +1 only when the
    column's second half-step ran) in ``info["n_matvec_columns"]``;
    ``n_matvec`` reports their maximum.

    f32 caveat: Bi-CGSTAB trajectories are rounding-chaotic — block
    reductions round differently than single-RHS dots, so near the f32
    accuracy floor (tight ``rtol`` with a large-residual guess, e.g.
    rtol<=1e-5 on jpwh_991 with the reference's 1+arange guess) a
    column can stagnate where the single solver got lucky (and vice
    versa).  In f64 the batched and single trajectories match matvec
    for matvec (tested).  Use f64 on CPU or ``refined_solve`` for
    reference-f64 tolerances.

    Returns :class:`SolveResult` with per-column ``x`` (n, K),
    ``converged``/``istop``/``resid_norm``/``resid_norm0`` as (K,)
    arrays (istop codes in :data:`ISTOP_MSG_TF`), and, when requested,
    a (maxiter+1, K) ``resid_history`` with NaN after each column's own
    stop.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[1] or A.shape[0] != A.shape[1]:
        from ..ops.base import ShapeError
        raise ShapeError("bicgstab_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M)
    if maxiter is None:
        maxiter = default_maxiter(B.shape[0], 2, matvec_max)
    X0 = _check_x0(x0, B, "bicgstab_batched")
    return _bicgstab_batched(A, B, X0, M, float(rtol), float(atol),
                             int(maxiter), bool(store_history))


@partial(jax.jit, static_argnames=("maxiter", "matvec_max",
                                   "store_history"))
def _cgs_batched(A, B, X0, M, rtol, atol, maxiter, matvec_max,
                 store_history):
    dtype = B.dtype
    n, K = B.shape
    if X0 is None:
        X = jnp.zeros((n, K), dtype)
        R0 = B
    else:
        X = X0.astype(dtype)
        R0 = B - _apply_block(A, X)  # not counted (cgs.py:59-60)
    rho = _dotu_cols(R0, R0)
    resid0 = jnp.abs(jnp.sqrt(rho)).real
    thresh = threshold_of(resid0, rtol, atol)
    hist = (jnp.full((maxiter + 1, K), jnp.nan, resid0.dtype)
            .at[0].set(resid0) if store_history else None)

    finite0 = jnp.isfinite(resid0)
    active0 = (resid0 > thresh) & finite0
    state0 = dict(
        x=X, r=R0, u=R0, p=R0, rho=rho, resid=resid0,
        k=jnp.zeros((), jnp.int32), nmv=jnp.zeros(K, jnp.int32),
        broken=~finite0, active=active0, hist=hist)

    def cond(s):
        return jnp.any(s["active"]) & (s["k"] < maxiter)

    def body(s):
        act = s["active"]
        Y = _apply_block(M, s["p"]) if M is not None else s["p"]
        V = _apply_block(A, Y)
        sigma = _dotu_cols(R0, V)
        alpha = s["rho"] / _safe(sigma)
        Q = s["u"] - alpha * V
        Z = _apply_block(M, s["u"] + Q) if M is not None else s["u"] + Q
        X2 = s["x"] + alpha * Z
        AZ = _apply_block(A, Z)
        nmv = s["nmv"] + 2 * act.astype(jnp.int32)
        R = s["r"] - alpha * AZ
        resid = jnp.linalg.norm(R, axis=0)
        rho_n = _dotu_cols(R0, R)
        # single-RHS parity: a dead STEP (sigma breakdown / non-finite
        # residual) restores the pre-step iterate (the single solver's
        # alpha=inf poisons resid and its keep-guard fires); a
        # rho_next==0 breakdown is detected AFTER a good update and the
        # update is kept, exactly as in _cgs
        badstep = act & ((sigma == 0) | ~jnp.isfinite(sigma)
                         | ~jnp.isfinite(resid))
        broken = badstep | (act & (rho_n == 0))
        done = act & ((resid <= thresh) | (nmv >= matvec_max) | broken)
        beta = rho_n / _safe(s["rho"])
        U = R + beta * Q
        P = U + beta * (Q + beta * s["p"])
        X2 = jnp.where(badstep, s["x"], X2)
        resid_out = jnp.where(badstep, s["resid"], resid)
        sel = lambda new, old: jnp.where(act, new, old)  # noqa: E731
        h2 = s["hist"]
        if h2 is not None:
            h2 = h2.at[s["k"] + 1].set(jnp.where(act, resid_out, jnp.nan))
        return dict(
            x=sel(X2, s["x"]), r=sel(R, s["r"]), u=sel(U, s["u"]),
            p=sel(P, s["p"]), rho=sel(rho_n, s["rho"]),
            resid=sel(resid_out, s["resid"]), k=s["k"] + 1,
            nmv=nmv, broken=s["broken"] | broken,
            active=act & ~done, hist=h2)

    s = jax.lax.while_loop(cond, body, state0)
    converged = s["resid"] <= thresh
    istop = jnp.where(converged, 0, jnp.where(s["broken"], 3, 1))
    info = {"n_matvec_columns": s["nmv"], "active_at_exit": s["active"]}
    return SolveResult(
        x=s["x"], converged=converged, istop=istop.astype(jnp.int32),
        n_iter=s["k"], n_matvec=jnp.max(s["nmv"]),
        resid_norm=s["resid"], resid_norm0=resid0,
        resid_history=s["hist"], info=info)


def cgs_batched(A, B, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
                maxiter=None, matvec_max=None, store_history=False):
    """Solve unsymmetric ``A X = B`` for an (n, K) block of right-hand
    sides by CGS in ONE fused while-loop.

    Each column follows the reference CGS recurrence
    (``/root/reference/pykrylov/cgs/cgs.py:40-123``) under a per-column
    freeze mask — both A products per iteration apply to the whole
    direction block, streaming the operator once for all K systems —
    with the single-RHS solver's breakdown guards and its
    matvec-count-parity quirk (the guess's ``r0`` matvec is NOT
    counted, ``cgs.py:59-60``).  Completes the reference bmark trio
    (``examples/bmark.py:45-51``) in fused multi-RHS form alongside
    :func:`bicgstab_batched` and :func:`tfqmr_batched`; the f32
    trajectory-chaos caveat of :func:`bicgstab_batched` applies.

    Returns :class:`SolveResult` with per-column ``x`` (n, K) and (K,)
    diagnostics (istop codes 0/1/3 as the single-RHS CGS).
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[1] or A.shape[0] != A.shape[1]:
        from ..ops.base import ShapeError
        raise ShapeError("cgs_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M)
    if matvec_max is None:
        matvec_max = 2 * B.shape[0]
    if maxiter is None:
        maxiter = max(1, int(matvec_max) // 2)
    X0 = _check_x0(x0, B, "cgs_batched")
    return _cgs_batched(A, B, X0, M, float(rtol), float(atol),
                        int(maxiter), int(matvec_max),
                        bool(store_history))


@partial(jax.jit, static_argnames=("maxiter", "store_history"))
def _tfqmr_batched(A, B, X0, M, rtol, atol, maxiter, store_history):
    dtype = B.dtype
    n, K = B.shape
    if X0 is None:
        X = jnp.zeros((n, K), dtype)
        R0 = B
    else:
        X = X0.astype(dtype)
        R0 = B - _apply_block(A, X)  # not counted (tfqmr.py:59-60)
    rho = _dotu_cols(R0, R0)
    rdtype = jnp.zeros((), dtype).real.dtype
    resid0 = jnp.abs(jnp.sqrt(rho)).real.astype(rdtype)
    thresh = threshold_of(resid0, rtol, atol)
    hist = (jnp.full((maxiter + 1, K), jnp.nan, resid0.dtype)
            .at[0].set(resid0) if store_history else None)

    finite0 = jnp.isfinite(resid0)
    started = (resid0 > thresh) & finite0
    Z = _apply_block(M, R0) if M is not None else R0
    U = jnp.where(started, _apply_block(A, Z), jnp.zeros((n, K), dtype))
    zK = jnp.zeros(K, dtype)
    rzK = jnp.zeros(K, rdtype)
    state0 = dict(
        x=X, w=R0, y=R0, z=Z, u=U, v=U, d=jnp.zeros((n, K), dtype),
        theta=rzK, eta=zK, rho=rho, resid=resid0, m=rzK,
        k=jnp.zeros((), jnp.int32),
        nmv=started.astype(jnp.int32),
        broken=~finite0, active=started, hist=hist)

    def half(theta_prev, eta_prev, w, d, x, alpha, u, z, resid):
        """One quasi-minimization half-step (tfqmr.py:93-123),
        column-vectorized."""
        w2 = w - alpha * u
        scale = jnp.where(theta_prev == 0, jnp.zeros_like(eta_prev),
                          (theta_prev * theta_prev / alpha) * eta_prev)
        d2 = z + scale * d
        theta2 = (jnp.linalg.norm(w2, axis=0) / _safe(resid)) \
            .astype(rzK.dtype)
        c = 1.0 / jnp.sqrt(1.0 + theta2 * theta2)
        resid2 = (resid * theta2 * c).astype(rzK.dtype)
        eta2 = (c * c) * alpha
        x2 = x + eta2 * d2
        return w2, d2, x2, theta2, eta2, resid2

    def cond(s):
        return jnp.any(s["active"]) & (s["k"] < maxiter)

    def body(s):
        act = s["active"]
        k = s["k"] + 1
        sigma = _dotu_cols(R0, s["v"])
        alpha = s["rho"] / _safe(sigma)
        broken0 = act & ((sigma == 0) | ~jnp.isfinite(sigma)
                         | (s["rho"] == 0) | ~jnp.isfinite(s["resid"]))
        go = act & ~broken0

        # first half-step
        w1, d1, x1, th1, et1, rs1 = half(
            s["theta"], s["eta"], s["w"], s["d"], s["x"], alpha,
            s["u"], s["z"], s["resid"])
        m1 = 2.0 * k.astype(rzK.dtype) - 1.0
        bad1 = go & ~jnp.isfinite(rs1)
        stop1 = go & ((rs1 * jnp.sqrt(m1 + 1) < thresh) | bad1)
        second = go & ~stop1

        # second half-step (one block product with A)
        m2 = m1 + 1.0
        Y2 = s["y"] - alpha * s["v"]
        Z2 = _apply_block(M, Y2) if M is not None else Y2
        U2 = _apply_block(A, Z2)
        nmv = s["nmv"] + second.astype(jnp.int32)
        w2, d2, x2, th2, et2, rs2 = half(
            th1, et1, w1, d1, x1, alpha, U2, Z2, rs1)
        bad2 = second & ~jnp.isfinite(rs2)
        stop2 = second & ((rs2 * jnp.sqrt(m2 + 1) < thresh) | bad2)
        refresh = second & ~stop2

        # direction refresh (tfqmr.py:128-151; one more block product)
        rho_n = _dotu_cols(R0, w2)
        beta = rho_n / _safe(s["rho"])
        Y3 = w2 + beta * Y2
        Z3 = _apply_block(M, Y3) if M is not None else Y3
        U3 = _apply_block(A, Z3)
        nmv = nmv + refresh.astype(jnp.int32)
        V3 = beta * (beta * s["v"] + U2) + U3

        # merge per column (non-finite restores the previous iterate)
        x_n = jnp.where(stop1 & ~bad1, x1,
                        jnp.where(second & ~bad2, x2, s["x"]))
        r_n = jnp.where(stop1 & ~bad1, rs1,
                        jnp.where(second & ~bad2, rs2, s["resid"]))
        m_n = jnp.where(stop1, m1, jnp.where(second, m2, s["m"]))
        done = stop1 | stop2 | broken0 | (refresh & bad2)
        h2 = s["hist"]
        if h2 is not None:
            h2 = h2.at[k].set(jnp.where(act, r_n, jnp.nan))
        sel = lambda msk, new, old: jnp.where(msk, new, old)  # noqa: E731
        return dict(
            x=x_n,
            w=sel(go, jnp.where(second[None, :], w2, w1), s["w"]),
            y=sel(refresh, Y3, sel(second, Y2, s["y"])),
            z=sel(refresh, Z3, sel(second, Z2, s["z"])),
            u=sel(refresh, U3, sel(second, U2, s["u"])),
            v=sel(refresh, V3, s["v"]),
            d=sel(go, jnp.where(second[None, :], d2, d1), s["d"]),
            theta=sel(go, jnp.where(second, th2, th1), s["theta"]),
            eta=sel(go, jnp.where(second, et2, et1), s["eta"]),
            rho=sel(refresh, rho_n, s["rho"]),
            resid=r_n, m=m_n, k=k, nmv=nmv,
            broken=s["broken"] | broken0 | bad1 | bad2,
            active=act & ~done, hist=h2)

    s = jax.lax.while_loop(cond, body, state0)
    converged = s["resid"] * jnp.sqrt(s["m"] + 1) < thresh
    istop = jnp.where(converged, 0, jnp.where(s["broken"], 3, 1))
    info = {"quasi_residual": s["resid"],
            "n_matvec_columns": s["nmv"], "active_at_exit": s["active"]}
    return SolveResult(
        x=s["x"], converged=converged, istop=istop.astype(jnp.int32),
        n_iter=s["k"], n_matvec=jnp.max(s["nmv"]),
        resid_norm=s["resid"], resid_norm0=resid0,
        resid_history=s["hist"], info=info)


def tfqmr_batched(A, B, *, x0=None, M=None, rtol=1.0e-6, atol=1.0e-8,
                  maxiter=None, matvec_max=None, store_history=False):
    """Solve unsymmetric ``A X = B`` for an (n, K) block of right-hand
    sides by transpose-free QMR in ONE fused while-loop.

    Each column follows the reference TFQMR recurrence — two
    quasi-minimization half-steps per iteration, quasi-residual update
    ``resid *= theta*c`` and the ``sqrt(m+1)`` safety factor
    (``/root/reference/pykrylov/tfqmr/tfqmr.py:39-159``) — under a
    per-column freeze mask, while the two A products per iteration
    apply to whole blocks.  The reference's uncounted-guess-matvec
    quirk is preserved (``tfqmr.py:59-60``).

    ``resid_norm`` columns are QUASI-residual norms (they upper-bound
    the true residuals via ``||r|| <= resid * sqrt(m+1)``).  Per-column
    matvec counts (reference accounting: +1 pre-loop, +1 second half,
    +1 refresh) land in ``info["n_matvec_columns"]``; ``n_matvec``
    reports their maximum.  See :func:`bicgstab_batched` for the shape
    and istop conventions.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[1] or A.shape[0] != A.shape[1]:
        from ..ops.base import ShapeError
        raise ShapeError("tfqmr_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M)
    if maxiter is None:
        maxiter = max(1, default_maxiter(B.shape[0], 2, matvec_max) + 1)
    X0 = _check_x0(x0, B, "tfqmr_batched")
    return _tfqmr_batched(A, B, X0, M, float(rtol), float(atol),
                          int(maxiter), bool(store_history))


# ---------------------------------------------------------------------------
# Batched MINRES
# ---------------------------------------------------------------------------

from .minres import ISTOP_MSG as ISTOP_MSG_MINRES  # noqa: E402

_MINRES_CONVERGED = (1, 2, 3, 4, 10)


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history"))
def _minres_batched(A, B, M, shift, rtol, etol, itnlim, window,
                    store_history):
    dtype = B.dtype
    n, K = B.shape
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    zK = jnp.zeros(K, dtype)

    Y = _apply_block(M, B) if M is not None else B
    beta1_sq = _col_dot(B, Y).astype(dtype)
    indef_precon = beta1_sq < 0              # istop 9 (minres.py:168-171)
    zero_b = beta1_sq == 0                   # istop 0 (minres.py:173-177)
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0))
    hist = (jnp.full((itnlim + 1, K), jnp.nan, dtype).at[0].set(beta1)
            if store_history else None)

    state0 = dict(
        x=jnp.zeros((n, K), dtype), r1=B, r2=B, y=Y,
        w=jnp.zeros((n, K), dtype), w2=jnp.zeros((n, K), dtype),
        oldb=zK, beta=beta1, dbar=zK, epsln=zK,
        phibar=beta1, rhs1=beta1, rhs2=zK,
        tnorm2=zK, ynorm2=zK,
        cs=-jnp.ones(K, dtype), sn=zK,
        gmax=zK, gmin=zK, x_nrg2=zK,
        d_err=jnp.zeros((window, K), dtype),
        anorm=zK, acond=zK, ynorm=zK, arnorm=zK, rnorm=beta1,
        istop=jnp.where(indef_precon, 9, 0).astype(jnp.int32),
        itn=jnp.zeros((), jnp.int32),
        done=indef_precon | zero_b,
        iters=jnp.zeros(K, jnp.int32), hist=hist)

    def cond(s):
        return jnp.any(~s["done"]) & (s["itn"] < itnlim)

    def body(s):
        act = ~s["done"]
        itn = s["itn"] + 1
        # ---- Lanczos step (minres.py:236-255), column-vectorized ------
        v = s["y"] / _safe(s["beta"])
        y = _apply_block(A, v) - shift * v
        y = jnp.where(itn >= 2,
                      y - (s["beta"] / _safe(s["oldb"])) * s["r1"], y)
        alfa = _col_dot(v, y).astype(dtype)
        y = y - (alfa / _safe(s["beta"])) * s["r2"]
        r1, r2 = s["r2"], y
        y = _apply_block(M, r2) if M is not None else r2
        oldb = s["beta"]
        beta_sq = _col_dot(r2, y).astype(dtype)
        indef = act & (beta_sq < 0)      # istop 6 (minres.py:251-255)
        go = act & ~indef
        beta = jnp.sqrt(jnp.maximum(beta_sq, 0))

        tnorm2 = s["tnorm2"] + alfa**2 + oldb**2 + beta**2
        near_const = beta / _safe(beta1) <= 10 * eps
        istop = jnp.where(go & (itn == 1) & near_const,
                          jnp.asarray(-1, jnp.int32), s["istop"])
        gmax0 = jnp.where(itn == 1, jnp.abs(alfa), s["gmax"])
        gmin0 = jnp.where(itn == 1, jnp.abs(alfa), s["gmin"])

        # ---- previous rotation (minres.py:266-289) ---------------------
        oldeps = s["epsln"]
        delta = s["cs"] * s["dbar"] + s["sn"] * alfa
        gbar = s["sn"] * s["dbar"] - s["cs"] * alfa
        epsln = s["sn"] * beta
        dbar = -s["cs"] * beta
        root = jnp.hypot(gbar, dbar)
        arnorm = s["phibar"] * root

        gamma = jnp.maximum(jnp.hypot(gbar, beta), eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * s["phibar"]
        phibar = sn * s["phibar"]

        # ---- solution update (minres.py:293-297) -----------------------
        w1, w2 = s["w2"], s["w"]
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = s["x"] + phi * w

        # ---- truncated direct-error window (minres.py:303-310) ---------
        x_nrg2 = s["x_nrg2"] + phi * phi
        d_err = s["d_err"].at[itn % window].set(
            jnp.where(go, phi, s["d_err"][itn % window]))
        trnc = jnp.linalg.norm(d_err, axis=0)
        small_err = (itn > window) & (trnc < etol * jnp.sqrt(x_nrg2))
        istop = jnp.where(go & (istop == 0) & small_err,
                          jnp.asarray(10, jnp.int32), istop)

        gmax = jnp.maximum(gmax0, gamma)
        gmin = jnp.minimum(gmin0, gamma)
        z = s["rhs1"] / gamma
        ynorm2 = z**2 + s["ynorm2"]
        rhs1 = s["rhs2"] - delta * z
        rhs2 = -epsln * z

        # ---- norm estimates + stopping tests (minres.py:321-361) -------
        anorm = jnp.sqrt(tnorm2)
        ynorm = jnp.sqrt(ynorm2)
        epsx = anorm * ynorm * eps
        rnorm = phibar
        test1 = rnorm / _safe(anorm * ynorm)
        test2 = root / _safe(anorm)
        acond = gmax / _safe(gmin)

        code = istop
        code = jnp.where(1 + test2 <= 1, 2, code)
        code = jnp.where(1 + test1 <= 1, 1, code)
        code = jnp.where(itn >= itnlim, 6, code)
        code = jnp.where(acond >= 0.1 / eps, 4, code)
        code = jnp.where(epsx >= beta1, 3, code)
        code = jnp.where(test2 <= rtol, 2, code)
        code = jnp.where(test1 <= rtol, 1, code)
        istop = jnp.where(go & (istop == 0), code.astype(jnp.int32),
                          istop)
        istop = jnp.where(indef, jnp.asarray(6, jnp.int32), istop)

        def mc(new, old):
            return jnp.where(go, new, old)

        def mv(new, old):
            return jnp.where(go[None, :], new, old)

        h2 = s["hist"]
        if h2 is not None:
            h2 = h2.at[itn].set(jnp.where(go, rnorm, jnp.nan))
        return dict(
            x=mv(x, s["x"]), r1=mv(r1, s["r1"]), r2=mv(r2, s["r2"]),
            y=mv(y, s["y"]), w=mv(w, s["w"]), w2=mv(w2, s["w2"]),
            oldb=mc(oldb, s["oldb"]), beta=mc(beta, s["beta"]),
            dbar=mc(dbar, s["dbar"]), epsln=mc(epsln, s["epsln"]),
            phibar=mc(phibar, s["phibar"]),
            rhs1=mc(rhs1, s["rhs1"]), rhs2=mc(rhs2, s["rhs2"]),
            tnorm2=mc(tnorm2, s["tnorm2"]), ynorm2=mc(ynorm2, s["ynorm2"]),
            cs=mc(cs, s["cs"]), sn=mc(sn, s["sn"]),
            gmax=mc(gmax, s["gmax"]), gmin=mc(gmin, s["gmin"]),
            x_nrg2=mc(x_nrg2, s["x_nrg2"]), d_err=d_err,
            anorm=mc(anorm, s["anorm"]), acond=mc(acond, s["acond"]),
            ynorm=mc(ynorm, s["ynorm"]), arnorm=mc(arnorm, s["arnorm"]),
            rnorm=mc(rnorm, s["rnorm"]), istop=istop, itn=itn,
            # != 0: a -1 (eigenvector-rhs) column must freeze, not grind
            done=s["done"] | (istop != 0),
            iters=s["iters"] + act.astype(jnp.int32), hist=h2)

    s = jax.lax.while_loop(cond, body, state0)
    istop = s["istop"]
    x_out = jnp.where(zero_b[None, :], jnp.zeros((n, K), dtype), s["x"])
    converged = zero_b | jnp.isin(istop, jnp.asarray(_MINRES_CONVERGED))
    info = {"Anorm": s["anorm"], "Acond": s["acond"],
            "Arnorm": s["arnorm"], "ynorm": s["ynorm"],
            "n_iter_columns": s["iters"], "active_at_exit": ~s["done"]}
    return SolveResult(
        x=x_out, converged=converged, istop=istop,
        n_iter=s["itn"], n_matvec=s["itn"],
        resid_norm=jnp.where(zero_b, jnp.zeros(K, dtype), s["rnorm"]),
        resid_norm0=beta1, resid_history=s["hist"], info=info)


def minres_batched(A, B, *, M=None, shift=0.0, rtol=1.0e-12, etol=None,
                   window=None, itnlim=None, store_history=False,
                   replace_every=None, atol=None):
    """Solve symmetric (possibly indefinite) ``(A - shift I) X = B`` for
    an (n, K) block of right-hand sides by MINRES in ONE fused
    while-loop.

    Completes the batched short-recurrence family for the symmetric
    class: each column runs the reference Paige–Saunders recurrence —
    Lanczos step, Givens rotation chain, w recurrence, the full istop
    battery incl. the energy-norm direct-error window
    (``/root/reference/pykrylov/minres/minres.py:220-361``) — under a
    per-column freeze mask, while the matvec and the preconditioner
    solve apply to the whole block, streaming the operator once per
    iteration for all K systems.  Per-column indefinite-preconditioner
    detection (istop 9 at entry, istop 6 mid-loop) freezes only the
    affected column.

    Parameters mirror :func:`~pykrylov_tpu.solvers.minres` (no
    ``check``/``show``/``store_iterates``).  ``replace_every`` enables
    the VERIFIED per-column mode (round 4): the block counterpart of
    single-RHS ff-MINRES — every column's Lanczos/Givens/w recurrence
    rides double-f32 (hi, lo) pairs and ``istop=1`` fires per column
    only on its recomputed TRUE residual
    ``||b_k - (A - shift I)(x_k + xl_k)|| <= max(atol, rtol ||b_k||)``
    (plain 2-norm, the same documented deviation as the single
    solver).  No restarts; compensated block products when the
    operator storage supports them.  ``store_history``/``etol`` are
    unsupported in that mode.

    Returns :class:`SolveResult` with per-column fields: ``x`` (n, K);
    ``converged``/``istop``/``resid_norm`` (K,) arrays (istop codes in
    :data:`ISTOP_MSG_MINRES`).  In the DEFAULT (estimate-stopping)
    mode, ``info`` carries per-column Anorm/Acond/Arnorm/ynorm and
    ``n_iter_columns``, and ``resid_norm`` columns are the
    recurrence's ``phibar`` estimates, as in the single-RHS solver.
    In VERIFIED mode (``replace_every``), ``resid_norm`` columns are
    the last recomputed TRUE residual 2-norms and ``info`` carries
    ``n_replacements``/``x_lo``/``n_iter_columns`` instead of the norm
    estimates; ``etol``/``window``/``store_history`` are unsupported
    there (``atol`` is supported ONLY there).
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[1] or A.shape[0] != A.shape[1]:
        from ..ops.base import ShapeError
        raise ShapeError("minres_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M)
    if itnlim is None:
        itnlim = 5 * B.shape[0]
    replace_every = int(replace_every) if replace_every else None
    if replace_every is not None:
        if store_history:
            raise ValueError("minres_batched: store_history is "
                             "unsupported with replace_every (verified "
                             "mode keeps no history buffers)")
        if etol is not None or window is not None:
            raise ValueError("minres_batched: the etol/window "
                             "direct-error stop does not exist in "
                             "verified mode (istop 1 fires only on "
                             "recomputed true residuals)")
        from .ffmv import resolve_ff_matmat
        return _minres_batched_ff(A, B, M, float(shift), float(rtol),
                                   float(atol if atol is not None
                                         else 0.0), int(itnlim),
                                   replace_every, resolve_ff_matmat(A))
    if atol is not None:
        raise ValueError("minres_batched: atol is only used by the "
                         "verified (replace_every) stopping rule; the "
                         "estimate-stopping mode has no absolute test "
                         "(reference minres.py has none either)")
    return _minres_batched(A, B, M, float(shift), float(rtol),
                           float(etol if etol is not None else 1e-6),
                           int(itnlim),
                           int(window if window is not None else 5),
                           bool(store_history))


# ---------------------------------------------------------------------------
# Batched SYMMLQ
# ---------------------------------------------------------------------------

from .symmlq import ISTOP_MSG as ISTOP_MSG_SYMMLQ  # noqa: E402

_SYMMLQ_CONVERGED = (1, 2)


@partial(jax.jit, static_argnames=("matvec_max", "store_history"))
def _symmlq_batched(A, B, M, shift, rtol, matvec_max, store_history):
    dtype = B.dtype
    n, K = B.shape
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    itnlim = max(1, matvec_max + 2)
    zK = jnp.zeros(K, dtype)

    def sdiv(a, d):
        return a / jnp.where(d == 0, jnp.ones_like(d), d)

    # ---- first + second Lanczos vectors, local reorthogonalization ----
    # (symmlq.py:128-199, column-vectorized; init counts one matvec)
    r1 = B
    Y = _apply_block(M, r1) if M is not None else r1
    beta1_sq = _col_dot(r1, Y).astype(dtype)
    indef_precon = beta1_sq < 0
    zero_b = beta1_sq == 0
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0))

    v = sdiv(Y, beta1)
    y = _apply_block(A, v) - shift * v
    alfa = _col_dot(v, y).astype(dtype)
    y = y - sdiv(alfa, beta1) * r1
    z = _col_dot(v, y).astype(dtype)
    ss = _col_dot(v, v).astype(dtype)
    y = y - sdiv(z, ss) * v
    r2 = y
    Y = _apply_block(M, r2) if M is not None else r2
    beta_sq = _col_dot(r2, Y).astype(dtype)
    indef_precon2 = beta_sq < 0
    dead = indef_precon | zero_b | indef_precon2
    beta = jnp.sqrt(jnp.maximum(beta_sq, 0))
    istop0 = jnp.where(indef_precon | indef_precon2, 8, 0)
    istop0 = jnp.where((istop0 == 0) & (beta <= eps) & ~zero_b, -1,
                       istop0).astype(jnp.int32)

    hist = (jnp.full((itnlim + 1, K), jnp.nan, dtype).at[0].set(beta1)
            if store_history else None)

    state0 = dict(
        x=jnp.zeros((n, K), dtype), w=jnp.zeros((n, K), dtype),
        r1=r1, r2=r2, y=Y,
        oldb=beta1, beta=beta, gbar=alfa, dbar=beta,
        rhs1=beta1, rhs2=zK, snprod=jnp.ones(K, dtype), bstep=zK,
        tnorm=alfa**2 + beta**2, ynorm2=zK,
        gmax=jnp.abs(alfa) + eps, gmin=jnp.abs(alfa) + eps,
        cgnorm=beta1, lqnorm=beta1,
        diag=jnp.where(alfa == 0, eps, alfa),
        acond=zK, anorm=zK,
        istop=istop0, itn=jnp.zeros((), jnp.int32),
        nmv=jnp.where(dead, 0, 1).astype(jnp.int32),
        done=dead, hist=hist)

    def cond(s):
        return (jnp.any(~s["done"] & (s["nmv"] < matvec_max))
                & (s["itn"] < itnlim))

    def body(s):
        act = ~s["done"] & (s["nmv"] < matvec_max)
        itn = s["itn"] + 1
        # ---- per-column norm estimates + tests (symmlq.py:237-277) ----
        anorm = jnp.sqrt(s["tnorm"])
        ynorm = jnp.sqrt(s["ynorm2"])
        epsa = anorm * eps
        epsx = anorm * ynorm * eps
        epsr = anorm * ynorm * rtol
        diag = jnp.where(s["gbar"] == 0, epsa, s["gbar"])
        lqnorm = jnp.sqrt(s["rhs1"]**2 + s["rhs2"]**2)
        qrnorm = s["snprod"] * beta1
        cgnorm = qrnorm * s["beta"] / jnp.abs(jnp.where(diag == 0, eps,
                                                        diag))
        acond = jnp.where(lqnorm < cgnorm, s["gmax"] / s["gmin"],
                          s["gmax"] / jnp.minimum(s["gmin"],
                                                  jnp.abs(diag)))
        code = s["istop"]
        code = jnp.where(s["nmv"] >= matvec_max, 5, code)
        code = jnp.where(acond >= 0.1 / eps, 4, code)
        code = jnp.where(epsx >= beta1, 3, code)
        code = jnp.where(cgnorm <= epsx, 2, code)
        code = jnp.where(cgnorm <= epsr, 1, code)
        istop = jnp.where(act & (s["istop"] == 0), code.astype(jnp.int32),
                          s["istop"])
        go = act & (istop == 0)

        # ---- Lanczos step (symmlq.py:286-302), column-vectorized ------
        v = sdiv(s["y"], s["beta"])
        ya = _apply_block(A, v) - shift * v
        ya = ya - sdiv(s["beta"], s["oldb"]) * s["r1"]
        alfa = _col_dot(v, ya).astype(dtype)
        ya = ya - sdiv(alfa, s["beta"]) * s["r2"]
        r1n, r2n = s["r2"], ya
        y2 = _apply_block(M, r2n) if M is not None else r2n
        oldb = s["beta"]
        beta_sq = _col_dot(r2n, y2).astype(dtype)
        indef = go & (beta_sq < 0)          # istop 6 (symmlq.py:191-199)
        rot = go & ~indef
        istop = jnp.where(indef, jnp.asarray(6, jnp.int32), istop)
        beta_n = jnp.sqrt(jnp.maximum(beta_sq, 0))
        tnorm = s["tnorm"] + alfa**2 + oldb**2 + beta_n**2

        # ---- plane rotation + LQ update (symmlq.py:307-338) -----------
        gamma = jnp.hypot(s["gbar"], oldb)
        gsafe = jnp.where(gamma == 0, eps, gamma)
        cs = s["gbar"] / gsafe
        sn = oldb / gsafe
        delta = cs * s["dbar"] + sn * alfa
        gbar = sn * s["dbar"] - cs * alfa
        epsln = sn * beta_n
        dbar = -cs * beta_n
        zz = s["rhs1"] / gsafe
        x = s["x"] + (zz * cs) * s["w"] + (zz * sn) * v
        w = sn * s["w"] - cs * v
        bstep = s["snprod"] * cs * zz + s["bstep"]
        snprod = s["snprod"] * sn
        gmax = jnp.maximum(s["gmax"], gamma)
        gmin = jnp.minimum(s["gmin"], gamma)
        ynorm2 = zz**2 + s["ynorm2"]
        rhs1 = s["rhs2"] - delta * zz
        rhs2 = -epsln * zz

        def ma(new, old):  # committed for every column tested this pass
            return jnp.where(act, new, old)

        def mc(new, old):  # committed only when the rotation ran
            return jnp.where(rot, new, old)

        def mv(new, old):
            return jnp.where(rot[None, :], new, old)

        h2 = s["hist"]
        if h2 is not None:
            h2 = h2.at[itn].set(jnp.where(act, cgnorm, jnp.nan))
        return dict(
            x=mv(x, s["x"]), w=mv(w, s["w"]),
            r1=mv(r1n, s["r1"]), r2=mv(r2n, s["r2"]),
            y=mv(y2, s["y"]),
            oldb=mc(oldb, s["oldb"]), beta=mc(beta_n, s["beta"]),
            gbar=mc(gbar, s["gbar"]), dbar=mc(dbar, s["dbar"]),
            rhs1=mc(rhs1, s["rhs1"]), rhs2=mc(rhs2, s["rhs2"]),
            snprod=mc(snprod, s["snprod"]), bstep=mc(bstep, s["bstep"]),
            tnorm=mc(tnorm, s["tnorm"]), ynorm2=mc(ynorm2, s["ynorm2"]),
            gmax=mc(gmax, s["gmax"]), gmin=mc(gmin, s["gmin"]),
            cgnorm=ma(cgnorm, s["cgnorm"]), lqnorm=ma(lqnorm, s["lqnorm"]),
            diag=ma(diag, s["diag"]), acond=ma(acond, s["acond"]),
            anorm=ma(anorm, s["anorm"]),
            istop=istop, itn=itn,
            # the step's matvec is spent before indefiniteness is seen
            # (symmlq on_indef commits nmv), so count go, not rot
            nmv=s["nmv"] + go.astype(jnp.int32),
            done=s["done"] | (act & (istop != 0)), hist=h2)

    s = jax.lax.while_loop(cond, body, state0)
    # budget exhausted via the loop guard (reference leaves istop=0
    # there); report the iteration limit explicitly, as single symmlq
    istop = jnp.where((s["istop"] == 0) & ~zero_b,
                      jnp.asarray(5, jnp.int32), s["istop"])

    # ---- move to the CG point where better (symmlq.py:356-365) --------
    move = s["cgnorm"] < s["lqnorm"]
    dsafe = jnp.where(s["diag"] == 0, eps, s["diag"])
    zbar = s["rhs1"] / dsafe
    bstep = jnp.where(move, s["snprod"] * zbar + s["bstep"], s["bstep"])
    x = jnp.where(move[None, :], s["x"] + zbar * s["w"], s["x"])

    # ---- step along b (symmlq.py:367-374) ----------------------------
    bstep = sdiv(bstep, beta1)
    Yb = _apply_block(M, B) if M is not None else B
    x = x + bstep * Yb

    # ---- true final residual, one counted matvec (symmlq.py:376-381) --
    Ax = _apply_block(A, x) - shift * x
    rnorm = jnp.linalg.norm(B - Ax, axis=0)
    xnorm = jnp.linalg.norm(x, axis=0)
    nmv = s["nmv"] + jnp.where(s["nmv"] == 0, 0, 1)

    x = jnp.where(zero_b[None, :], jnp.zeros((n, K), dtype), x)
    rnorm = jnp.where(zero_b, zK, rnorm)
    converged = zero_b | jnp.isin(istop, jnp.asarray(_SYMMLQ_CONVERGED))
    info = {"Anorm": s["anorm"], "Acond": s["acond"], "xnorm": xnorm,
            "cgnorm": s["cgnorm"], "lqnorm": s["lqnorm"],
            "n_matvec_columns": nmv, "active_at_exit": ~s["done"]}
    return SolveResult(
        x=x, converged=converged, istop=istop,
        n_iter=s["itn"], n_matvec=jnp.max(nmv),
        resid_norm=rnorm, resid_norm0=beta1,
        resid_history=s["hist"], info=info)


def symmlq_batched(A, B, *, M=None, shift=0.0, rtol=1.0e-9,
                   matvec_max=None, store_history=False):
    """Solve symmetric (possibly indefinite) ``(A - shift I) X = B`` for
    an (n, K) block of right-hand sides by SYMMLQ in ONE fused
    while-loop.

    Each column runs the reference Paige–Saunders LQ recurrence —
    Lanczos step with the init-time local reorthogonalization, plane
    rotations, the full istop battery, the LQ-vs-CG exit point and the
    final step along ``b`` (``/root/reference/pykrylov/symmlq/
    symmlq.py:65-400``) — under a per-column freeze mask, while the
    matvec and preconditioner solve apply to whole blocks (one operator
    stream per iteration for all K systems).  The reference's
    ``self.matvec`` bug is not replicated (SURVEY §7).

    Parameters mirror :func:`~pykrylov_tpu.solvers.symmlq` (no
    ``check``/``store_iterates``).  ``matvec_max`` caps PER-COLUMN
    matvec counts (default 2n+2); per-column counts land in
    ``info["n_matvec_columns"]`` and ``n_matvec`` reports their max.

    Returns :class:`SolveResult` with per-column fields: ``x`` (n, K);
    ``converged``/``istop``/``resid_norm``/``resid_norm0`` are (K,)
    (istop codes in :data:`ISTOP_MSG_SYMMLQ`); ``resid_norm`` columns
    are TRUE final residuals recomputed with one counted block matvec,
    as in the single-RHS solver.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[1] or A.shape[0] != A.shape[1]:
        from ..ops.base import ShapeError
        raise ShapeError("symmlq_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M)
    if matvec_max is None:
        matvec_max = 2 * B.shape[0] + 2
    return _symmlq_batched(A, B, M, float(shift), float(rtol),
                           int(matvec_max), bool(store_history))


# ---------------------------------------------------------------------------
# Batched LSQR
# ---------------------------------------------------------------------------

def _gk_init_block(A, B, M, N):
    """Column-batched Golub-Kahan init — :func:`lls_common.gk_init` on an
    (m, K) block (weighted norms and guarded normalizations per column;
    reference ``lls/lsqr.py:188-210``)."""
    dtype = B.dtype
    Mu = B
    u = _apply_block(M, Mu) if M is not None else Mu
    beta = jnp.sqrt(jnp.maximum(_col_dot(u, Mu).astype(dtype), 0))
    sb = jnp.where(beta == 0, 1, beta)
    u = jnp.where(beta > 0, u / sb, u)
    Mu = jnp.where(beta > 0, Mu / sb, Mu)
    Nv = _apply_block_T(A, u)
    v = _apply_block(N, Nv) if N is not None else Nv
    alpha = jnp.sqrt(jnp.maximum(_col_dot(v, Nv).astype(dtype), 0))
    alpha = jnp.where(beta > 0, alpha, 0)
    sa = jnp.where(alpha == 0, 1, alpha)
    v = jnp.where(alpha > 0, v / sa, v)
    Nv = jnp.where(alpha > 0, Nv / sa, Nv)
    return u, Mu, v, Nv, alpha, beta


def _gk_step_block(A, M, N, v, Mu, Nv, alpha):
    """Column-batched bidiagonalization step — mirrors
    :func:`lls_common.gk_step` (guards incl. the beta == 0 freeze of
    v/Nv/alpha; reference ``lls/lsqr.py:252-272``)."""
    dtype = v.dtype
    Mu2 = _apply_block(A, v) - alpha * Mu
    u2 = _apply_block(M, Mu2) if M is not None else Mu2
    beta = jnp.sqrt(jnp.maximum(_col_dot(u2, Mu2).astype(dtype), 0))
    ok_b = beta > 0
    sb = jnp.where(ok_b, beta, 1)
    u2 = jnp.where(ok_b, u2 / sb, u2)
    Mu2 = jnp.where(ok_b, Mu2 / sb, Mu2)
    Nv2 = _apply_block_T(A, u2) - beta * Nv
    v2 = _apply_block(N, Nv2) if N is not None else Nv2
    alpha2 = jnp.sqrt(jnp.maximum(_col_dot(v2, Nv2).astype(dtype), 0))
    ok_a = ok_b & (alpha2 > 0)
    sa = jnp.where(ok_a, alpha2, 1)
    v2 = jnp.where(ok_a, v2 / sa, v2)
    Nv2 = jnp.where(ok_a, Nv2 / sa, Nv2)
    v2 = jnp.where(ok_b, v2, v)
    Nv2 = jnp.where(ok_b, Nv2, Nv)
    alpha2 = jnp.where(ok_b, jnp.where(alpha2 > 0, alpha2, 0), alpha)
    return u2, Mu2, v2, Nv2, alpha2, beta


def _apply_block_T(op, X):
    from .common import apply_op_T
    rmm = getattr(op, "_rmm", None)
    if rmm is not None:
        return op.apply_with(rmm, X)
    return jax.vmap(lambda c: apply_op_T(op, c), in_axes=1, out_axes=1)(X)


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history"))
def _lsqr_batched(A, B, M, N, damp, atol, btol, conlim, etol, itnlim,
                  window, store_history):
    n = A.nargin
    dtype = B.dtype
    K = B.shape[1]
    zK = jnp.zeros(K, dtype)
    dampsq = damp * damp
    ctol = jnp.where(conlim > 0, 1.0 / jnp.where(conlim == 0, 1, conlim),
                     0.0).astype(dtype)

    u, Mu, v, Nv, alpha, beta = _gk_init_block(A, B, M, N)
    arnorm0 = alpha * beta
    bnorm = beta
    done0 = arnorm0 == 0          # exact solution x = 0 (istop 0)

    hist = (jnp.full((itnlim + 1, K), jnp.nan, dtype).at[0].set(beta)
            if store_history else None)

    state0 = dict(
        x=jnp.zeros((n, K), dtype), w=v, u=u, Mu=Mu, v=v, Nv=Nv,
        alpha=alpha, beta=beta, rhobar=alpha, phibar=beta,
        cs2=-jnp.ones(K, dtype), sn2=zK, z=zK,
        xxnorm=zK, ddnorm=zK, res2=zK,
        anorm=zK, acond=zK, xnorm=zK,
        rnorm=beta, r1norm=beta, r2norm=beta, arnorm=arnorm0,
        x_nrg2=zK, d_err=jnp.zeros((window, K), dtype),
        istop=jnp.zeros(K, jnp.int32), iters=jnp.zeros(K, jnp.int32),
        itn=jnp.zeros((), jnp.int32), done=done0, hist=hist)

    def cond(s):
        return jnp.any(~s["done"]) & (s["itn"] < itnlim)

    def body(s):
        act = ~s["done"]
        itn = s["itn"] + 1
        u, Mu, v, Nv, alpha, beta = _gk_step_block(
            A, M, N, s["v"], s["Mu"], s["Nv"], s["alpha"])
        anorm = jnp.sqrt(s["anorm"]**2 + s["alpha"]**2 + beta**2 + dampsq)

        rhobar1 = jnp.hypot(s["rhobar"], damp)
        cs1 = s["rhobar"] / rhobar1
        sn1 = damp / rhobar1
        psi = sn1 * s["phibar"]
        phibar = cs1 * s["phibar"]

        rho = jnp.hypot(rhobar1, beta)
        cs = rhobar1 / rho
        sn = beta / rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi

        t1 = phi / rho
        t2 = -theta / rho
        dk = s["w"] / rho
        x = s["x"] + t1 * s["w"]
        w = t2 * s["w"] + v
        ddnorm = s["ddnorm"] + _col_dot(dk, dk).astype(dtype)

        x_nrg2 = s["x_nrg2"] + phi * phi
        d_err = s["d_err"].at[itn % window].set(
            jnp.where(act, phi, s["d_err"][itn % window]))
        trnc = jnp.linalg.norm(d_err, axis=0)
        istop = jnp.where((itn > window) & (trnc < etol * jnp.sqrt(x_nrg2)),
                          8, s["istop"])

        delta = s["sn2"] * rho
        gambar = -s["cs2"] * rho
        rhs = phi - delta * s["z"]
        zbar = rhs / jnp.where(gambar == 0, 1, gambar)
        xnorm = jnp.sqrt(s["xxnorm"] + zbar**2)
        gamma = jnp.hypot(gambar, theta)
        cs2 = gambar / gamma
        sn2 = theta / gamma
        z = rhs / jnp.where(gamma == 0, 1, gamma)
        xxnorm = s["xxnorm"] + z * z

        acond = anorm * jnp.sqrt(ddnorm)
        res1 = phibar**2
        res2 = s["res2"] + psi**2
        rnorm = jnp.sqrt(res1 + res2)
        arnorm = alpha * jnp.abs(tau)
        r1sq = rnorm**2 - dampsq * xxnorm
        r1norm = jnp.sign(r1sq) * jnp.sqrt(jnp.abs(r1sq))
        r2norm = rnorm

        inf = jnp.asarray(jnp.inf, dtype)
        test1 = rnorm / jnp.where(bnorm == 0, 1, bnorm)
        test2 = jnp.where((anorm == 0) | (rnorm == 0), inf,
                          arnorm / (anorm * rnorm))
        test3 = jnp.where(acond == 0, inf, 1.0 / acond)
        t1t = test1 / (1 + anorm * xnorm / jnp.where(bnorm == 0, 1, bnorm))
        rtol = btol + atol * anorm * xnorm / jnp.where(bnorm == 0, 1, bnorm)

        istop = jnp.where(itn >= itnlim, 7, istop)
        istop = jnp.where(1 + test3 <= 1, 6, istop)
        istop = jnp.where(1 + test2 <= 1, 5, istop)
        istop = jnp.where(1 + t1t <= 1, 4, istop)
        istop = jnp.where(test3 <= ctol, 3, istop)
        istop = jnp.where(test2 <= atol, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)
        istop = istop.astype(jnp.int32)

        # freeze: done columns carry every field bit-unchanged
        def mc(new, old):
            return jnp.where(act, new, old)

        def mv(new, old):
            return jnp.where(act[None, :], new, old)

        h2 = s["hist"]
        if h2 is not None:
            h2 = h2.at[itn].set(jnp.where(act, r2norm, jnp.nan))
        return dict(
            x=mv(x, s["x"]), w=mv(w, s["w"]), u=mv(u, s["u"]),
            Mu=mv(Mu, s["Mu"]), v=mv(v, s["v"]), Nv=mv(Nv, s["Nv"]),
            alpha=mc(alpha, s["alpha"]), beta=mc(beta, s["beta"]),
            rhobar=mc(rhobar, s["rhobar"]), phibar=mc(phibar, s["phibar"]),
            cs2=mc(cs2, s["cs2"]), sn2=mc(sn2, s["sn2"]), z=mc(z, s["z"]),
            xxnorm=mc(xxnorm, s["xxnorm"]), ddnorm=mc(ddnorm, s["ddnorm"]),
            res2=mc(res2, s["res2"]), anorm=mc(anorm, s["anorm"]),
            acond=mc(acond, s["acond"]), xnorm=mc(xnorm, s["xnorm"]),
            rnorm=mc(rnorm, s["rnorm"]), r1norm=mc(r1norm, s["r1norm"]),
            r2norm=mc(r2norm, s["r2norm"]), arnorm=mc(arnorm, s["arnorm"]),
            x_nrg2=mc(x_nrg2, s["x_nrg2"]), d_err=d_err,
            istop=jnp.where(act, istop, s["istop"]),
            iters=s["iters"] + act.astype(jnp.int32),
            itn=itn, done=s["done"] | (act & (istop > 0)), hist=h2)

    s = jax.lax.while_loop(cond, body, state0)
    istop = s["istop"]
    optimal = jnp.isin(istop, jnp.asarray((0, 1, 2, 4, 5, 8)))
    info = {"r1norm": s["r1norm"], "r2norm": s["r2norm"],
            "Anorm": s["anorm"], "Acond": s["acond"],
            "Arnorm": s["arnorm"], "xnorm": s["xnorm"], "bnorm": bnorm,
            "optimal": optimal, "n_iter_columns": s["iters"]}
    return SolveResult(
        x=s["x"], converged=optimal, istop=istop,
        n_iter=s["itn"], n_matvec=2 * s["itn"],
        resid_norm=s["r2norm"], resid_norm0=beta,
        resid_history=s["hist"], info=info)


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history"))
def _lsmr_batched(A, B, M, N, damp, atol, btol, conlim, etol, itnlim,
                  window, store_history):
    from .lls_common import sym_ortho

    n = A.nargin
    dtype = B.dtype
    K = B.shape[1]
    zK = jnp.zeros(K, dtype)
    oneK = jnp.ones(K, dtype)
    ctol = jnp.where(conlim > 0, 1.0 / jnp.where(conlim == 0, 1, conlim),
                     0.0).astype(dtype)

    u, Mu, v, Nv, alpha, beta = _gk_init_block(A, B, M, N)
    normb = beta
    normar0 = alpha * beta
    x_is_zero = normar0 == 0

    hist = (jnp.full((itnlim + 1, K), jnp.nan, dtype).at[0].set(beta)
            if store_history else None)

    state0 = dict(
        x=jnp.zeros((n, K), dtype), h=v, hbar=jnp.zeros((n, K), dtype),
        u=u, Mu=Mu, v=v, Nv=Nv, alpha=alpha, beta=beta,
        zetabar=alpha * beta, alphabar=alpha,
        rho=oneK, rhobar=oneK, cbar=oneK, sbar=zK,
        betadd=beta, betad=zK, rhodold=oneK, tautildeold=zK,
        thetatilde=zK, zeta=zK, d=zK,
        normA2=alpha * alpha, maxrbar=zK,
        minrbar=jnp.full(K, jnp.inf, dtype),
        normr=beta, normar=normar0, normA=alpha, condA=oneK, normx=zK,
        x_nrg2=zK, d_err=jnp.zeros((window, K), dtype),
        istop=jnp.zeros(K, jnp.int32), iters=jnp.zeros(K, jnp.int32),
        itn=jnp.zeros((), jnp.int32), done=x_is_zero, hist=hist)

    def cond(s):
        return jnp.any(~s["done"]) & (s["itn"] < itnlim)

    def body(s):
        act = ~s["done"]
        itn = s["itn"] + 1
        u, Mu, v, Nv, alpha, beta = _gk_step_block(
            A, M, N, s["v"], s["Mu"], s["Nv"], s["alpha"])

        # ---- rotations (lsmr.py:336-365), column-vectorized ------------
        chat, shat, alphahat = sym_ortho(s["alphabar"],
                                         jnp.full(K, damp, dtype))
        rhoold = s["rho"]
        c, sn, rho = sym_ortho(alphahat, beta)
        thetanew = sn * alpha
        alphabar = c * alpha

        rhobarold = s["rhobar"]
        zetaold = s["zeta"]
        thetabar = s["sbar"] * rho
        rhotemp = s["cbar"] * rho
        cbar, sbar, rhobar = sym_ortho(s["cbar"] * rho, thetanew)
        zeta = cbar * s["zetabar"]
        zetabar = -sbar * s["zetabar"]

        # ---- update h, hbar, x (lsmr.py:367-371) -----------------------
        hbar = s["h"] - (thetabar * rho
                         / _safe(rhoold * rhobarold)) * s["hbar"]
        x = s["x"] + (zeta / _safe(rho * rhobar)) * hbar
        h = v - (thetanew / _safe(rho)) * s["h"]

        # ---- direct-error window (lsmr.py:376-384) ---------------------
        x_nrg2 = s["x_nrg2"] + zeta * zeta
        d_err = s["d_err"].at[itn % window].set(
            jnp.where(act, zeta, s["d_err"][itn % window]))
        trnc = jnp.linalg.norm(d_err, axis=0)
        istop = jnp.where((itn > window) & (trnc < etol * jnp.sqrt(x_nrg2)),
                          8, s["istop"])

        # ---- ||r|| estimate (lsmr.py:386-404) --------------------------
        betaacute = chat * s["betadd"]
        betacheck = -shat * s["betadd"]
        betahat = c * betaacute
        betadd = -sn * betaacute
        thetatildeold = s["thetatilde"]
        ctildeold, stildeold, rhotildeold = sym_ortho(s["rhodold"],
                                                      thetabar)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * s["betad"] + ctildeold * betahat
        tautildeold = (zetaold - thetatildeold * s["tautildeold"]) \
            / _safe(rhotildeold)
        taud = (zeta - thetatilde * tautildeold) / _safe(rhodold)
        d = s["d"] + betacheck * betacheck
        normr = jnp.sqrt(d + (betad - taud)**2 + betadd * betadd)

        # ---- ||A|| and cond(A) estimates (lsmr.py:406-412) -------------
        normA2 = s["normA2"] + beta * beta
        normA = jnp.sqrt(normA2)
        normA2 = normA2 + alpha * alpha
        maxrbar = jnp.maximum(s["maxrbar"], rhobarold)
        minrbar = jnp.where(itn > 1,
                            jnp.minimum(s["minrbar"], rhobarold),
                            s["minrbar"])
        condA = jnp.maximum(maxrbar, rhotemp) \
            / _safe(jnp.minimum(minrbar, rhotemp))

        # ---- convergence tests (lsmr.py:416-448) -----------------------
        normar = jnp.abs(zetabar)
        normx = jnp.linalg.norm(x, axis=0)
        sb = jnp.where(normb == 0, 1, normb)
        test1 = normr / sb
        test2 = normar / _safe(normA * normr)
        test3 = 1.0 / _safe(condA)
        t1 = test1 / (1 + normA * normx / sb)
        rtol = btol + atol * normA * normx / sb

        istop = jnp.where(itn >= itnlim, 7, istop)
        istop = jnp.where(1 + test3 <= 1, 6, istop)
        istop = jnp.where(1 + test2 <= 1, 5, istop)
        istop = jnp.where(1 + t1 <= 1, 4, istop)
        istop = jnp.where(test3 <= ctol, 3, istop)
        istop = jnp.where(test2 <= atol, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)
        istop = istop.astype(jnp.int32)

        def mc(new, old):
            return jnp.where(act, new, old)

        def mv(new, old):
            return jnp.where(act[None, :], new, old)

        h2 = s["hist"]
        if h2 is not None:
            h2 = h2.at[itn].set(jnp.where(act, normr, jnp.nan))
        return dict(
            x=mv(x, s["x"]), h=mv(h, s["h"]), hbar=mv(hbar, s["hbar"]),
            u=mv(u, s["u"]), Mu=mv(Mu, s["Mu"]), v=mv(v, s["v"]),
            Nv=mv(Nv, s["Nv"]),
            alpha=mc(alpha, s["alpha"]), beta=mc(beta, s["beta"]),
            zetabar=mc(zetabar, s["zetabar"]),
            alphabar=mc(alphabar, s["alphabar"]),
            rho=mc(rho, s["rho"]), rhobar=mc(rhobar, s["rhobar"]),
            cbar=mc(cbar, s["cbar"]), sbar=mc(sbar, s["sbar"]),
            betadd=mc(betadd, s["betadd"]), betad=mc(betad, s["betad"]),
            rhodold=mc(rhodold, s["rhodold"]),
            tautildeold=mc(tautildeold, s["tautildeold"]),
            thetatilde=mc(thetatilde, s["thetatilde"]),
            zeta=mc(zeta, s["zeta"]), d=mc(d, s["d"]),
            normA2=mc(normA2, s["normA2"]),
            maxrbar=mc(maxrbar, s["maxrbar"]),
            minrbar=mc(minrbar, s["minrbar"]),
            normr=mc(normr, s["normr"]), normar=mc(normar, s["normar"]),
            normA=mc(normA, s["normA"]), condA=mc(condA, s["condA"]),
            normx=mc(normx, s["normx"]), x_nrg2=mc(x_nrg2, s["x_nrg2"]),
            d_err=d_err, istop=jnp.where(act, istop, s["istop"]),
            iters=s["iters"] + act.astype(jnp.int32), itn=itn,
            done=s["done"] | (act & (istop > 0)), hist=h2)

    s = jax.lax.while_loop(cond, body, state0)
    istop = s["istop"]
    optimal = jnp.isin(istop, jnp.asarray((0, 1, 2, 4, 5, 8)))
    info = {"normr": s["normr"], "normar": s["normar"],
            "normA": s["normA"], "condA": s["condA"],
            "normx": s["normx"], "optimal": optimal,
            "n_iter_columns": s["iters"]}
    return SolveResult(
        x=s["x"], converged=optimal, istop=istop,
        n_iter=s["itn"], n_matvec=2 * s["itn"],
        resid_norm=s["normr"], resid_norm0=normb,
        resid_history=s["hist"], info=info)


def lsmr_batched(A, B, *, damp=0.0, M=None, N=None, atol=1.0e-9,
                 btol=1.0e-9, conlim=1.0e8, etol=1.0e-6, window=5,
                 itnlim=None, store_history=False):
    """Solve ``min ||A x_k - b_k||`` for an (m, K) block of right-hand
    sides by LSMR in ONE fused while-loop.

    The multi-RHS companion of :func:`~pykrylov_tpu.solvers.lsmr`
    (reference double-QR recurrence
    ``/root/reference/pykrylov/lls/lsmr.py:336-448``): each column runs
    its own Golub-Kahan bidiagonalization, Q/Qbar/Qtilde rotation
    chains, recursive ``||r||`` estimate and full istop battery under a
    per-column freeze mask, while A and A' apply to whole blocks — one
    pair of block products per iteration for all K systems.  Completes
    the batched least-squares pair alongside :func:`lsqr_batched`.

    Parameters mirror :func:`lsmr` (no ``show``/``verify_final``).
    Returns :class:`SolveResult` with per-column fields: ``x`` (n, K),
    ``converged``/``istop``/``resid_norm`` (K,) arrays, the reference
    tuple's fields (normr/normar/normA/condA/normx) as (K,) arrays in
    ``info``, and ``info["n_iter_columns"]``; ``n_matvec`` counts BLOCK
    products.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[0]:
        from ..ops.base import ShapeError
        raise ShapeError("lsmr_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M, N)
    if itnlim is None:
        itnlim = min(A.nargout, A.nargin)
    return _lsmr_batched(A, B, M, N, float(damp), float(atol), float(btol),
                         float(conlim), float(etol), int(itnlim),
                         int(window), bool(store_history))


def lsqr_batched(A, B, *, damp=0.0, M=None, N=None, atol=1.0e-9,
                 btol=1.0e-9, conlim=1.0e8, etol=1.0e-6, window=5,
                 itnlim=None, store_history=False):
    """Solve ``min ||A x_k - b_k||`` for an (m, K) block of right-hand
    sides in ONE fused while-loop.

    The multi-RHS companion of :func:`~pykrylov_tpu.solvers.lsqr`
    (reference recurrence ``/root/reference/pykrylov/lls/lsqr.py:243-392``):
    each column drives its own Golub-Kahan bidiagonalization, damp/beta
    rotations, istop battery and direct-error window under a per-column
    freeze mask, while A and A' apply to whole blocks — one pair of
    block products per iteration for all K systems.  Stopped columns
    carry their state bit-unchanged until every column stops.

    Parameters mirror :func:`lsqr` (no ``wantvar``/``show``).  Returns
    :class:`SolveResult` with per-column fields: ``x`` (n, K),
    ``converged``/``istop``/``resid_norm`` (K,) arrays,
    ``info["n_iter_columns"]`` the per-column counts; ``n_matvec``
    counts BLOCK products.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[0]:
        from ..ops.base import ShapeError
        raise ShapeError("lsqr_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M, N)
    if itnlim is None:
        itnlim = 3 * A.nargin
    return _lsqr_batched(A, B, M, N, float(damp), float(atol), float(btol),
                         float(conlim), float(etol), int(itnlim),
                         int(window), bool(store_history))


# ---------------------------------------------------------------------------
# Batched CRAIG / CRAIG-MR (SQD family)
# ---------------------------------------------------------------------------

from .craig import ISTOP_MSG as ISTOP_MSG_CRAIG        # noqa: E402
from .craigmr import ISTOP_MSG as ISTOP_MSG_CRAIGMR    # noqa: E402

_CRAIG_OPTIMAL = (0, 1, 2, 4, 5, 8)


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history"))
def _craig_batched(A, B, M, N, atol, btol, etol, itnlim, window,
                   store_history):
    m, n = A.nargout, A.nargin
    dtype = B.dtype
    K = B.shape[1]
    zK = jnp.zeros(K, dtype)
    one = jnp.ones(K, dtype)

    U, Mu, V, Nv, alpha, beta = _gk_init_block(A, B, M, N)
    x_is_zero = beta == 0
    bnorm = beta

    # first-iteration initialization (craig.py:247-268), per column
    rho = jnp.hypot(alpha, one)
    D = U / rho
    tau = beta / rho
    R = tau * D
    rnorm = tau * tau
    c = alpha / rho
    s = 1.0 / rho
    zeta = s * beta
    eta = c * zeta
    xi = s * zeta
    W = c * V
    Wbar = s * V
    X = zeta * W
    xnorm = eta * eta
    r1norm = xi * xi

    hist = (jnp.full((itnlim + 1, K), jnp.nan, dtype)
            .at[0].set(jnp.sqrt(rnorm)) if store_history else None)

    st0 = dict(
        X=X, R=R, W=W, Wbar=Wbar, D=D,
        U=U, Mu=Mu, V=V, Nv=Nv, alpha=alpha, beta=beta,
        c=c, s=s, zeta=zeta, tau=tau,
        rnorm=rnorm, r1norm=r1norm, xnorm=xnorm,
        arnorm=zK, r_nrg2=zK, x_nrg2=zK,
        d_err=jnp.zeros((window, K), dtype),
        istop=jnp.zeros(K, jnp.int32), itn=jnp.zeros((), jnp.int32),
        done=x_is_zero, iters=jnp.zeros(K, jnp.int32), hist=hist)

    def cond(st):
        return jnp.any(~st["done"]) & (st["itn"] < itnlim)

    def body(st):
        act = ~st["done"]
        itn = st["itn"] + 1
        U, Mu, V, Nv, alpha, beta = _gk_step_block(
            A, M, N, st["V"], st["Mu"], st["Nv"], st["alpha"])
        arnorm = jnp.abs(st["alpha"] * beta * st["s"] * st["zeta"])

        # rotations of types I and II (craig.py:333-345), per column
        beta_hat = st["c"] * beta
        gamma = st["s"] * beta
        delta = jnp.hypot(gamma, one)
        alpha_hat = jnp.hypot(alpha, delta)
        ah = jnp.where(alpha_hat == 0, 1, alpha_hat)
        c = alpha / ah
        s = delta / ah
        s2 = gamma / delta
        # (c2 = -1/delta is unused by the updates, as in the single)

        # dual update (craig.py:347-350)
        D2 = (U - beta_hat * st["D"]) / ah
        tau = -beta_hat * st["tau"] / ah
        R2 = st["R"] + tau * D2

        # primal update (craig.py:354-365)
        zeta = -beta_hat * st["zeta"] / ah
        eta = c * zeta
        xi = s * zeta
        Wbar_s = st["Wbar"] * s2
        W2 = c * V + s * Wbar_s
        Wbar2 = -c * Wbar_s + s * V
        X2 = st["X"] + zeta * W2

        # energy norms + dual direct-error stop (craig.py:370-379)
        r_nrg2 = st["r_nrg2"] + tau * tau
        x_nrg2 = st["x_nrg2"] + zeta * zeta
        d_err = st["d_err"].at[itn % window].set(
            jnp.where(act, tau, st["d_err"][itn % window]))
        trnc = jnp.linalg.norm(d_err, axis=0)
        istop = jnp.where(
            act & (itn > window) & (trnc < etol * jnp.sqrt(r_nrg2)),
            jnp.asarray(8, jnp.int32), st["istop"])

        rnorm = st["rnorm"] + tau * tau
        xnorm = st["xnorm"] + eta * eta
        r1norm = st["r1norm"] + xi * xi

        # active tests (craig.py:438-457)
        test1 = jnp.sqrt(rnorm) / jnp.where(bnorm == 0, 1, bnorm)
        istop = jnp.where(act & (itn >= itnlim), 7, istop)
        istop = jnp.where(act & (1 + test1 <= 1), 4, istop)
        istop = jnp.where(act & (test1 <= btol), 1, istop)
        istop = istop.astype(jnp.int32)

        def mc(new, old):
            return jnp.where(act, new, old)

        def mv(new, old):
            return jnp.where(act[None, :], new, old)

        h2 = st["hist"]
        if h2 is not None:
            h2 = h2.at[itn].set(jnp.where(act, jnp.sqrt(rnorm), jnp.nan))
        return dict(
            X=mv(X2, st["X"]), R=mv(R2, st["R"]), W=mv(W2, st["W"]),
            Wbar=mv(Wbar2, st["Wbar"]), D=mv(D2, st["D"]),
            U=mv(U, st["U"]), Mu=mv(Mu, st["Mu"]), V=mv(V, st["V"]),
            Nv=mv(Nv, st["Nv"]),
            alpha=mc(alpha, st["alpha"]), beta=mc(beta, st["beta"]),
            c=mc(c, st["c"]), s=mc(s, st["s"]),
            zeta=mc(zeta, st["zeta"]), tau=mc(tau, st["tau"]),
            rnorm=mc(rnorm, st["rnorm"]),
            r1norm=mc(r1norm, st["r1norm"]),
            xnorm=mc(xnorm, st["xnorm"]), arnorm=mc(arnorm, st["arnorm"]),
            r_nrg2=mc(r_nrg2, st["r_nrg2"]),
            x_nrg2=mc(x_nrg2, st["x_nrg2"]), d_err=d_err,
            istop=istop, itn=itn, done=st["done"] | (istop > 0),
            iters=st["iters"] + act.astype(jnp.int32), hist=h2)

    st = jax.lax.while_loop(cond, body, st0)
    istop = st["istop"]
    optimal = jnp.isin(istop, jnp.asarray(_CRAIG_OPTIMAL))
    X_out = jnp.where(x_is_zero[None, :], jnp.zeros((n, K), dtype),
                      st["X"])
    R_out = jnp.where(x_is_zero[None, :], jnp.zeros((m, K), dtype),
                      st["R"])
    return SolveResult(
        x=X_out, converged=optimal, istop=istop,
        n_iter=st["itn"], n_matvec=2 * st["itn"],
        resid_norm=jnp.sqrt(st["rnorm"]), resid_norm0=bnorm,
        resid_history=st["hist"],
        info={"r": R_out, "r1norm": jnp.sqrt(st["r1norm"]),
              "r2norm": jnp.sqrt(st["rnorm"]),
              "Arnorm": st["arnorm"], "xnorm": st["xnorm"],
              "rNrgNorm2": st["r_nrg2"], "xNrgNorm2": st["x_nrg2"],
              "optimal": optimal, "n_iter_columns": st["iters"]})


def craig_batched(A, B, *, M=None, N=None, atol=1.0e-9, btol=1.0e-9,
                  etol=1.0e-6, window=5, itnlim=None,
                  store_history=False):
    """Solve consistent ``A X = B`` / the SQD system per column by the
    generalized CRAIG method in ONE fused while-loop.

    Each column runs the reference recurrence — Golub-Kahan steps,
    rotations of types I/II, BOTH the primal and dual iterates, energy
    norms and the dual truncated-direct-error stop
    (``/root/reference/pykrylov/lls/craig.py:104-520``) — under a
    per-column freeze mask, with one forward + one transpose BLOCK
    product per iteration for all K systems.

    Parameters mirror :func:`~pykrylov_tpu.solvers.craig` (no
    ``store_iterates``/``show``/``verify_final``).  Returns
    :class:`SolveResult` with per-column fields; the dual block ``R``
    is ``info["r"]`` (m, K), istop codes in :data:`ISTOP_MSG_CRAIG`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[0]:
        from ..ops.base import ShapeError
        raise ShapeError("craig_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M, N)
    if itnlim is None:
        itnlim = 3 * A.nargin
    return _craig_batched(A, B, M, N, float(atol), float(btol),
                          float(etol), int(itnlim), int(window),
                          bool(store_history))


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history"))
def _craigmr_batched(A, B, M, N, etol, itnlim, window, store_history):
    m, n = A.nargout, A.nargin
    dtype = B.dtype
    K = B.shape[1]
    zK = jnp.zeros(K, dtype)
    one = jnp.ones(K, dtype)

    U, Mu, V, Nv, alpha, beta = _gk_init_block(A, B, M, N)
    x_is_zero = (alpha * beta) == 0

    # first-iteration initialization (craigmr.py:104-120), per column
    alpha_hat = jnp.hypot(alpha, one)
    c = alpha / alpha_hat
    s = 1.0 / alpha_hat
    zeta_hat = beta
    alpha_tilde = alpha_hat
    theta = zK
    D = U / alpha_hat

    hist = (jnp.full((itnlim + 1, K), jnp.nan, dtype).at[0].set(beta)
            if store_history else None)

    st0 = dict(
        X=jnp.zeros((m, K), dtype), D=D, Dbar=jnp.zeros((m, K), dtype),
        U=U, Mu=Mu, V=V, Nv=Nv, alpha=alpha, beta=beta,
        c=c, s=s, zeta_hat=zeta_hat, alpha_tilde=alpha_tilde,
        theta=theta, zeta=zK, x_nrg2=zK,
        d_err=jnp.zeros((window, K), dtype),
        istop=jnp.zeros(K, jnp.int32), itn=jnp.zeros((), jnp.int32),
        done=x_is_zero, iters=jnp.zeros(K, jnp.int32), hist=hist)

    def cond(st):
        return jnp.any(~st["done"]) & (st["itn"] < itnlim)

    def body(st):
        act = ~st["done"]
        itn = st["itn"] + 1
        U, Mu, V, Nv, alpha, beta = _gk_step_block(
            A, M, N, st["V"], st["Mu"], st["Nv"], st["alpha"])

        # rotations I / II / III (craigmr.py:161-185), per column
        beta_hat = st["c"] * beta
        gamma = st["s"] * beta
        delta = jnp.hypot(gamma, one)
        alpha_hat = jnp.hypot(alpha, delta)
        ah = jnp.where(alpha_hat == 0, 1, alpha_hat)
        c = alpha / ah
        s = delta / ah
        rho = jnp.hypot(st["alpha_tilde"], beta_hat)
        rh = jnp.where(rho == 0, 1, rho)
        c_hat = st["alpha_tilde"] / rh
        s_hat = beta_hat / rh

        Dbar2 = (st["D"] - st["theta"] * st["Dbar"]) / rh
        theta = s_hat * ah
        alpha_tilde = -c_hat * ah

        zeta = c_hat * st["zeta_hat"]
        zeta_hat = s_hat * st["zeta_hat"]
        x_nrg2 = st["x_nrg2"] + zeta * zeta
        D2 = (U - beta_hat * st["D"]) / ah
        X2 = st["X"] + zeta * Dbar2

        # stopping (craigmr.py:202-212)
        d_err = st["d_err"].at[itn % window].set(
            jnp.where(act, zeta, st["d_err"][itn % window]))
        trnc = jnp.linalg.norm(d_err, axis=0)
        istop = jnp.where(
            act & (itn > window) & (trnc < etol * jnp.sqrt(x_nrg2)),
            jnp.asarray(8, jnp.int32), st["istop"])
        istop = jnp.where(act & (itn >= itnlim), 7,
                          istop).astype(jnp.int32)

        def mc(new, old):
            return jnp.where(act, new, old)

        def mv(new, old):
            return jnp.where(act[None, :], new, old)

        h2 = st["hist"]
        if h2 is not None:
            h2 = h2.at[itn].set(jnp.where(act, jnp.abs(zeta), jnp.nan))
        return dict(
            X=mv(X2, st["X"]), D=mv(D2, st["D"]),
            Dbar=mv(Dbar2, st["Dbar"]),
            U=mv(U, st["U"]), Mu=mv(Mu, st["Mu"]), V=mv(V, st["V"]),
            Nv=mv(Nv, st["Nv"]),
            alpha=mc(alpha, st["alpha"]), beta=mc(beta, st["beta"]),
            c=mc(c, st["c"]), s=mc(s, st["s"]),
            zeta_hat=mc(zeta_hat, st["zeta_hat"]),
            alpha_tilde=mc(alpha_tilde, st["alpha_tilde"]),
            theta=mc(theta, st["theta"]), zeta=mc(zeta, st["zeta"]),
            x_nrg2=mc(x_nrg2, st["x_nrg2"]), d_err=d_err,
            istop=istop, itn=itn, done=st["done"] | (istop > 0),
            iters=st["iters"] + act.astype(jnp.int32), hist=h2)

    st = jax.lax.while_loop(cond, body, st0)
    istop = st["istop"]
    converged = x_is_zero | (istop == 8)
    return SolveResult(
        x=st["X"], converged=converged, istop=istop,
        n_iter=st["itn"], n_matvec=2 * st["itn"],
        resid_norm=jnp.abs(st["zeta"]), resid_norm0=beta,
        resid_history=st["hist"],
        info={"xNrgNorm2": st["x_nrg2"],
              "trncDirErr": jnp.linalg.norm(st["d_err"], axis=0),
              "optimal": converged, "n_iter_columns": st["iters"]})


def craigmr_batched(A, B, *, M=None, N=None, etol=1.0e-6, window=5,
                    itnlim=None, store_history=False):
    """Solve the least-norm minimum-residual problem per column by
    CRAIG-MR in ONE fused while-loop.

    Each column runs the reference recurrence (rotations I/II/III, the
    dual-space iterate of dimension m, the truncated-direct-error stop
    as the only active test — ``/root/reference/pykrylov/lls/
    craigmr.py:51-250``; the stray hot-loop debug print is not
    replicated) under a per-column freeze mask, with one forward + one
    transpose BLOCK product per iteration.

    Parameters mirror :func:`~pykrylov_tpu.solvers.craigmr`.  Returns
    :class:`SolveResult` with per-column fields; ``x`` is the (m, K)
    dual-space block, istop codes in :data:`ISTOP_MSG_CRAIGMR`.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[0]:
        from ..ops.base import ShapeError
        raise ShapeError("craigmr_batched: operator %r with rhs block %s"
                         % (A, B.shape))
    B = promote_rhs(B, A, M, N)
    if itnlim is None:
        itnlim = min(A.nargout, A.nargin)
    return _craigmr_batched(A, B, M, N, float(etol), int(itnlim),
                            int(window), bool(store_history))


# ---------------------------------------------------------------------------
# Verified batched MINRES (restart-free double-f32, per column)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("itnlim", "replace_every", "ff_mm"))
def _minres_batched_ff(A, B, M, shift, rtol, atol, itnlim,
                       replace_every, ff_mm):
    """Per-column port of single-RHS ``_minres``'s verified mode (see
    the long rationale there, solvers/minres.py): the whole
    Lanczos/Givens/w recurrence rides double-f32 (hi, lo) pairs per
    column — scalars as (K,) pairs, vectors as (n, K) pairs — and
    istop 1 fires per column only on its recomputed TRUE residual."""
    from ..utils.ff import (ff_add_ff, ff_div, ff_hypot, ff_mul,
                            ff_sqrt, ff_vdot_cols, two_prod, two_sum)

    dtype = B.dtype
    n, K = B.shape
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    zK = jnp.zeros(K, dtype)
    Z = jnp.zeros((n, K), dtype)

    Y = _apply_block(M, B) if M is not None else B
    beta1_sq = _col_dot(B, Y).astype(dtype)
    indef_precon = beta1_sq < 0              # istop 9
    zero_b = beta1_sq == 0
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0))
    bnorm = jnp.linalg.norm(B, axis=0)
    vthresh = jnp.maximum(jnp.asarray(atol, dtype),
                          jnp.asarray(rtol, dtype) * bnorm)

    s0 = dict(
        x=Z, xl=Z, r1=B, r1l=Z, r2=B, r2l=Z, y=Y, yl=Z,
        w=Z, wl=Z, w2=Z, w2l=Z,
        oldb=zK, oldbl=zK, beta=beta1, betal=zK,
        dbar=zK, dbarl=zK, epsln=zK, epslnl=zK,
        phibar=beta1, phibarl=zK,
        cs=-jnp.ones(K, dtype), csl=zK, sn=zK, snl=zK,
        tnorm2=zK, gmax=zK, gmin=zK,
        rnt=bnorm, lastv=jnp.zeros(K, jnp.int32),
        nrep=jnp.zeros(K, jnp.int32),
        nrep_evts=jnp.zeros((), jnp.int32),
        istop=jnp.where(indef_precon, 9, 0).astype(jnp.int32),
        itn=jnp.zeros((), jnp.int32),
        done=indef_precon | zero_b,
        iters=jnp.zeros(K, jnp.int32))

    def cond(s):
        return jnp.any(~s["done"]) & (s["itn"] < itnlim)

    def body(s):
        act = ~s["done"]
        itn = s["itn"] + 1
        # ---- double-f32 Lanczos, column-vectorized --------------------
        v, vl = ff_div(s["y"], s["yl"], s["beta"], s["betal"])
        if ff_mm is not None:
            y, ylo = ff_mm(A._params, v, vl)
        else:
            # one fused (n, 2K) product instead of two A streams — the
            # SpMM amortization is the whole point of the block family
            YY = _apply_block(A, jnp.concatenate([v, vl], axis=1))
            y, ylo = YY[:, :K], YY[:, K:]
        ph0, pe0 = two_prod(-shift, v)
        y, ylo = ff_add_ff(y, ylo, ph0, pe0 - shift * vl)
        c1, c1l = ff_div(s["beta"], s["betal"], s["oldb"], s["oldbl"])
        t1h, t1l = two_prod(-c1, s["r1"])
        y2h, y2l = ff_add_ff(y, ylo, t1h,
                             t1l - c1 * s["r1l"] - c1l * s["r1"])
        y = jnp.where(itn >= 2, y2h, y)
        ylo = jnp.where(itn >= 2, y2l, ylo)
        alfa, alfal = ff_vdot_cols(v, vl, y, ylo)
        c2, c2l = ff_div(alfa, alfal, s["beta"], s["betal"])
        t2h, t2l = two_prod(-c2, s["r2"])
        y, ylo = ff_add_ff(y, ylo, t2h,
                           t2l - c2 * s["r2l"] - c2l * s["r2"])
        r1, r1l = s["r2"], s["r2l"]
        r2, r2l = y, ylo
        if M is not None:
            y, yl_new = _apply_block(M, r2), _apply_block(M, r2l)
        else:
            y, yl_new = r2, r2l
        oldb, oldbl = s["beta"], s["betal"]
        beta_sq, beta_sql = ff_vdot_cols(r2, r2l, y, yl_new)
        indef = act & (beta_sq < 0)          # istop 6
        go = act & ~indef
        istop = jnp.where(indef, jnp.asarray(6, jnp.int32), s["istop"])

        beta, betal = ff_sqrt(jnp.maximum(beta_sq, 0), beta_sql)
        beta = jnp.where(beta_sq > 0, beta, 0.0)
        betal = jnp.where(beta_sq > 0, betal, 0.0)
        tnorm2 = s["tnorm2"] + alfa**2 + oldb**2 + beta**2
        near_const = beta / jnp.where(beta1 == 0, 1, beta1) <= 10 * eps
        istop = jnp.where(go & (itn == 1) & near_const,
                          jnp.asarray(-1, jnp.int32), istop)
        gmax0 = jnp.where(itn == 1, jnp.abs(alfa), s["gmax"])
        gmin0 = jnp.where(itn == 1, jnp.abs(alfa), s["gmin"])

        # ---- double-f32 Givens chain ----------------------------------
        oldeps, oldepsl = s["epsln"], s["epslnl"]
        d1h, d1l = ff_mul(s["cs"], s["csl"], s["dbar"], s["dbarl"])
        d2h, d2l = ff_mul(s["sn"], s["snl"], alfa, alfal)
        delta, deltal = ff_add_ff(d1h, d1l, d2h, d2l)
        g1h, g1l = ff_mul(s["sn"], s["snl"], s["dbar"], s["dbarl"])
        g2h, g2l = ff_mul(s["cs"], s["csl"], alfa, alfal)
        gbar, gbarl = ff_add_ff(g1h, g1l, -g2h, -g2l)
        epsln, epslnl = ff_mul(s["sn"], s["snl"], beta, betal)
        dbar, dbarl = ff_mul(-s["cs"], -s["csl"], beta, betal)
        gamma, gammal = ff_hypot(gbar, gbarl, beta, betal)
        gammal = jnp.where(gamma <= eps, 0.0, gammal)
        gamma = jnp.maximum(gamma, eps)
        cs, csl = ff_div(gbar, gbarl, gamma, gammal)
        sn, snl = ff_div(beta, betal, gamma, gammal)
        phi, phil = ff_mul(cs, csl, s["phibar"], s["phibarl"])
        phibar, phibarl = ff_mul(sn, snl, s["phibar"], s["phibarl"])

        # ---- double-f32 w recurrence + x update -----------------------
        w1, w2v = s["w2"], s["w"]
        w1l, w2l_ = s["w2l"], s["wl"]
        t1h, t1l = two_prod(-oldeps, w1)
        t1l = t1l - oldeps * w1l - oldepsl * w1
        t2h, t2l = two_prod(-delta, w2v)
        t2l = t2l - delta * w2l_ - deltal * w2v
        sh, sl = two_sum(v, t1h)
        sh, e2 = two_sum(sh, t2h)
        w, wl = ff_div(sh, sl + e2 + t1l + t2l + vl, gamma, gammal)
        uh, ue = two_prod(phi, w)
        x, xl = ff_add_ff(s["x"], s["xl"], uh, ue + phi * wl + phil * w)

        gmax = jnp.maximum(gmax0, gamma)
        gmin = jnp.minimum(gmin0, gamma)
        acond = gmax / jnp.where(gmin == 0, 1, gmin)

        # ---- verified stopping ----------------------------------------
        code = jnp.where(itn >= itnlim, 6, 0)
        code = jnp.where(acond >= 0.1 / eps, 4, code)
        istop = jnp.where(go & (istop == 0), code.astype(jnp.int32),
                          istop)
        claims = (phibar <= vthresh) & (itn - s["lastv"] >= 5)
        periodic = (itn % replace_every) == 0
        do_ver = go & (claims | periodic)

        def _true_resid():
            if ff_mm is not None:
                sh2, sl2 = ff_mm(A._params, x, xl)
            else:
                SS = _apply_block(A, jnp.concatenate([x, xl], axis=1))
                sh2, sl2 = SS[:, :K], SS[:, K:]
            ph, pe = two_prod(shift, x)
            d, de = two_sum(B, -sh2)
            d2, de2 = two_sum(d, ph)
            rt = d2 + (de + de2 + pe + shift * xl - sl2)
            rnt_new = jnp.linalg.norm(rt, axis=0)
            return jnp.where(do_ver, rnt_new, s["rnt"])

        rnt = jax.lax.cond(jnp.any(do_ver), _true_resid,
                           lambda: s["rnt"])
        istop = jnp.where(go & (istop == 0) & do_ver & (rnt <= vthresh),
                          jnp.asarray(1, jnp.int32), istop)

        def mc(new, old):
            return jnp.where(go, new, old)

        def mv(new, old):
            return jnp.where(go[None, :], new, old)

        return dict(
            x=mv(x, s["x"]), xl=mv(xl, s["xl"]),
            r1=mv(r1, s["r1"]), r1l=mv(r1l, s["r1l"]),
            r2=mv(r2, s["r2"]), r2l=mv(r2l, s["r2l"]),
            y=mv(y, s["y"]), yl=mv(yl_new, s["yl"]),
            w=mv(w, s["w"]), wl=mv(wl, s["wl"]),
            w2=mv(w2v, s["w2"]), w2l=mv(w2l_, s["w2l"]),
            oldb=mc(oldb, s["oldb"]), oldbl=mc(oldbl, s["oldbl"]),
            beta=mc(beta, s["beta"]), betal=mc(betal, s["betal"]),
            dbar=mc(dbar, s["dbar"]), dbarl=mc(dbarl, s["dbarl"]),
            epsln=mc(epsln, s["epsln"]),
            epslnl=mc(epslnl, s["epslnl"]),
            phibar=mc(phibar, s["phibar"]),
            phibarl=mc(phibarl, s["phibarl"]),
            cs=mc(cs, s["cs"]), csl=mc(csl, s["csl"]),
            sn=mc(sn, s["sn"]), snl=mc(snl, s["snl"]),
            tnorm2=mc(tnorm2, s["tnorm2"]),
            gmax=mc(gmax, s["gmax"]), gmin=mc(gmin, s["gmin"]),
            rnt=mc(rnt, s["rnt"]),
            lastv=mc(jnp.where(do_ver, itn, s["lastv"]), s["lastv"]),
            nrep=s["nrep"] + do_ver.astype(jnp.int32),
            nrep_evts=s["nrep_evts"] + jnp.any(do_ver).astype(jnp.int32),
            istop=istop, itn=itn, done=s["done"] | (istop != 0),
            iters=s["iters"] + act.astype(jnp.int32))

    s = jax.lax.while_loop(cond, body, s0)
    istop = s["istop"]
    x_out = jnp.where(zero_b[None, :], jnp.zeros((n, K), dtype), s["x"])
    converged = zero_b | (istop == 1)
    mult = 1 if ff_mm is not None else 2
    return SolveResult(
        x=x_out, converged=converged, istop=istop,
        n_iter=s["itn"], n_matvec=(s["itn"] + s["nrep_evts"]) * mult,
        resid_norm=jnp.where(zero_b, zK, s["rnt"]),
        resid_norm0=bnorm, resid_history=None,
        info={"n_replacements": s["nrep"], "x_lo": s["xl"],
              "n_iter_columns": s["iters"],
              "active_at_exit": ~s["done"]})


@partial(jax.jit, static_argnames=("maxiter", "replace_every",
                                  "store_history"))
def _cg_pipelined_batched(A, B, X0, M, rtol, atol, maxiter,
                          replace_every, store_history):
    dtype = B.dtype
    n, K = B.shape

    def precon(V):
        return _apply_block(M, V) if M is not None else V

    if X0 is None:
        X = jnp.zeros((n, K), dtype)
        R = B
        extra = 0
    else:
        X = X0.astype(dtype)
        R = B - _apply_block(A, X)
        extra = 1
    U = precon(R)
    W = _apply_block(A, U)
    gamma = _col_dot(R, U)
    resid0 = jnp.sqrt(jnp.abs(gamma))
    thresh = threshold_of(resid0, rtol, atol)
    hist = (jnp.full((maxiter + 1, K), jnp.nan, resid0.dtype)
            .at[0].set(resid0) if store_history else None)

    Zb = jnp.zeros((n, K), dtype)
    active0 = resid0 > thresh
    carry0 = (X, R, U, W, Zb, Zb, Zb, Zb, gamma, jnp.ones(K, dtype),
              jnp.zeros((), jnp.int32), resid0, active0,
              jnp.zeros(K, jnp.int32), hist)

    def cond(carry):
        k, active = carry[10], carry[12]
        return jnp.any(active) & (k < maxiter)

    def body(carry):
        (X, R, U, W, Z, Q, S, P, gamma, alpha, k, resid, active,
         iters, hist) = carry
        # ONE fused per-column reduction pair (both dots share U) —
        # the same communication shape as the single-RHS solver; the
        # convergence test reuses gamma
        gamma2 = _col_dot(R, U)
        delta = _col_dot(W, U)
        resid2 = jnp.where(active, jnp.sqrt(jnp.abs(gamma2)), resid)
        done_now = active & (resid2 <= thresh)
        act = active & ~done_now

        Mw = precon(W)
        Nv = _apply_block(A, Mw)
        first = k == 0
        g_old = jnp.where(gamma == 0, 1, gamma)
        beta = jnp.where(first, jnp.zeros((), dtype), gamma2 / g_old)
        a_old = jnp.where(alpha == 0, 1, alpha)
        den = jnp.where(first, delta, delta - beta * gamma2 / a_old)
        alpha2 = gamma2 / jnp.where(den == 0, 1, den)
        alpha2 = jnp.where(act, alpha2, 0)
        beta = jnp.where(act, beta, 0)

        Z2 = Nv + beta * Z
        Q2 = Mw + beta * Q
        S2 = W + beta * S
        P2 = U + beta * P
        X2 = X + alpha2 * P2
        R2 = R - alpha2 * S2
        U2 = U - alpha2 * Q2
        W2 = W - alpha2 * Z2

        if replace_every:
            # full per-column restoration (the single-RHS solver's
            # replace branch, columnwise): every coupled recurrence is
            # recomputed from X2/P2 on the cadence — partial
            # replacements worsen the drift
            def replace(ops):
                X2, R2, U2, W2, S2, Q2, Z2 = ops
                Rn = B - _apply_block(A, X2)
                Un = precon(Rn)
                Wn = _apply_block(A, Un)
                Sn = _apply_block(A, P2)
                Qn = precon(Sn)
                Zn = _apply_block(A, Qn)
                m2 = act[None, :]
                return (X2, jnp.where(m2, Rn, R2),
                        jnp.where(m2, Un, U2), jnp.where(m2, Wn, W2),
                        jnp.where(m2, Sn, S2), jnp.where(m2, Qn, Q2),
                        jnp.where(m2, Zn, Z2))

            X2, R2, U2, W2, S2, Q2, Z2 = jax.lax.cond(
                (k + 1) % replace_every == 0, replace,
                lambda ops: ops, (X2, R2, U2, W2, S2, Q2, Z2))

        m2 = act[None, :]
        h2 = hist if hist is None else hist.at[k + 1].set(
            jnp.where(active, resid2, jnp.nan))
        return (jnp.where(m2, X2, X), jnp.where(m2, R2, R),
                jnp.where(m2, U2, U), jnp.where(m2, W2, W),
                jnp.where(m2, Z2, Z), jnp.where(m2, Q2, Q),
                jnp.where(m2, S2, S), jnp.where(m2, P2, P),
                jnp.where(act, gamma2, gamma),
                jnp.where(act, alpha2, alpha), k + 1, resid2,
                act, iters + active.astype(jnp.int32), h2)

    (X, R, U, W, Z, Q, S, P, gamma, alpha, k, resid, active, iters,
     hist) = jax.lax.while_loop(cond, body, carry0)
    converged = resid <= thresh
    istop = jnp.where(converged, 0, 1).astype(jnp.int32)
    return SolveResult(
        x=X, converged=converged, istop=istop,
        n_iter=k, n_matvec=k + 1 + extra,
        resid_norm=resid, resid_norm0=resid0, resid_history=hist,
        info={"n_iter_columns": iters, "active_at_exit": active})


def cg_pipelined_batched(A, B, *, x0=None, M=None, rtol=1.0e-6,
                         atol=1.0e-8, maxiter=None, matvec_max=None,
                         replace_every=0, store_history=False):
    """Solve SPD ``A X = B`` by pipelined (communication-hiding) CG in
    ONE fused while-loop — the block twin of
    :func:`~pykrylov_tpu.solvers.cg_pipelined` (round 5: the last
    method without one).

    Each column runs the single-RHS pipelined recurrence independently
    under a per-column freeze mask; the per-iteration reductions are
    TWO fused (K,)-column dot blocks sharing operands (on a mesh, one
    combined psum — the solver's reason to exist), and the operator
    products stream A once per iteration for all K systems through the
    block-product protocol.  ``replace_every`` restores all coupled
    recurrences to their true values on a fixed cadence (4 extra block
    products each time) — use ~10 in f32 for ill-conditioned systems,
    exactly as the single-RHS docstring prescribes.
    """
    from .common import as_operator, default_maxiter, promote_rhs, \
        require_square
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    B = promote_rhs(B, A, M)
    require_square(A, B[:, 0], "cg_pipelined_batched")
    if maxiter is None:
        maxiter = default_maxiter(B.shape[0], 1, matvec_max)
    X0 = jnp.asarray(x0) if x0 is not None else None
    return _cg_pipelined_batched(A, B, X0, M, rtol, atol, int(maxiter),
                                 int(replace_every),
                                 bool(store_history))
