"""SYMMLQ (Paige & Saunders) as a fused ``lax.while_loop``.

JAX-native redesign of the reference SYMMLQ
(``/root/reference/pykrylov/symmlq/symmlq.py:17-400``).  Symmetric, possibly
indefinite systems ``(A - shift I) x = b``; one matvec, two dots, four axpys
per iteration (``symmlq.py:24-25``); the preconditioner must be SPD.

Preserved semantics (SURVEY §2.3):
  * istop table -1..8 (``symmlq.py:99-109``) with the reference's test
    ordering (``symmlq.py:273-277``), tested at the *top* of each
    iteration from the previous step's quantities;
  * local reorthogonalization of the second Lanczos vector against the
    first (``symmlq.py:181-186``);
  * LQ-vs-CG exit: moves to the CG point when ``cgnorm < lqnorm``
    (``symmlq.py:356-365``), then adds the accumulated step along ``b``
    (``symmlq.py:367-374``);
  * the true final residual is recomputed with one extra counted matvec
    (``symmlq.py:376-381``);
  * ``matvec_max`` default 2n+2 (``symmlq.py:87``).

Reference bug NOT replicated (SURVEY §7): ``symmlq.py:162`` calls the
nonexistent ``self.matvec(v)`` — the first Lanczos step here uses the
operator itself.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .common import as_operator, apply_op, history_init, history_push, promote_rhs, require_square
from .result import SolveResult
from ..utils.utils import check_symmetric as _check_symmetric

__all__ = ["symmlq", "ISTOP_MSG"]

ISTOP_MSG = {
    -1: "beta2 = 0. If M = I, b and x are eigenvectors",
    0: "beta1 = 0. The exact solution is x = 0",
    1: "requested accuracy achieved, as determined by rtol",
    2: "reasonable accuracy achieved, given eps",
    3: "x has converged to an eigenvector",
    4: "acond has exceeded 0.1/eps",
    5: "the iteration limit was reached",
    6: "the operator does not define a symmetric matrix",
    7: "the preconditioner does not define a symmetric matrix",
    8: "the preconditioner does not define a pos-def preconditioner",
}

_CONVERGED_CODES = (1, 2)


@partial(jax.jit, static_argnames=("matvec_max", "store_history",
                                   "store_iterates"))
def _symmlq(A, b, M, shift, rtol, matvec_max, store_history,
            store_iterates):
    dtype = b.dtype
    n = b.shape[0]
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    itnlim = max(1, (matvec_max - 2) // 1)

    def safe_div(a, d):
        return a / jnp.where(d == 0, jnp.ones((), dtype), d)

    # ---- first Lanczos vector (symmlq.py:128-146) ------------------------
    r1 = b
    y = apply_op(M, r1) if M is not None else r1
    b1 = y[0]
    beta1_sq = jnp.vdot(r1, y).real.astype(dtype)
    indef_precon = beta1_sq < 0
    zero_b = beta1_sq == 0
    dead = indef_precon | zero_b
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0))

    # ---- second Lanczos vector + local reorthogonalization ---------------
    # (symmlq.py:158-199; the reference's first step counts one matvec)
    v = safe_div(y, beta1)
    y = apply_op(A, v)
    y = y - shift * v
    alfa = jnp.vdot(v, y).real.astype(dtype)
    y = y - safe_div(alfa, beta1) * r1
    z = jnp.vdot(v, y).real.astype(dtype)
    ss = jnp.vdot(v, v).real.astype(dtype)
    y = y - safe_div(z, ss) * v
    r2 = y
    y = apply_op(M, r2) if M is not None else r2
    oldb = beta1
    beta_sq = jnp.vdot(r2, y).real.astype(dtype)
    indef_precon2 = beta_sq < 0
    dead = dead | indef_precon2
    beta = jnp.sqrt(jnp.maximum(beta_sq, 0))
    istop0 = jnp.where(indef_precon | indef_precon2, 8, 0)
    istop0 = jnp.where((istop0 == 0) & (beta <= eps) & ~zero_b, -1, istop0)

    zero = jnp.zeros((), dtype)
    hist = history_init(store_history, itnlim, dtype)
    hist = history_push(hist, 0, beta1)
    # Optional LQ-point iterate history (the reference's store_iterates,
    # symmlq.py:94,124,321).
    iters_buf = (jnp.full((itnlim + 1, n), jnp.nan, dtype=dtype)
                 .at[0].set(jnp.zeros(n, dtype)) if store_iterates
                 else None)

    state0 = dict(
        x=jnp.zeros(n, dtype), w=jnp.zeros(n, dtype),
        r1=r1, r2=r2, y=y,
        oldb=oldb, beta=beta, gbar=alfa, dbar=beta,
        rhs1=beta1, rhs2=zero, snprod=jnp.ones((), dtype), bstep=zero,
        tnorm=alfa**2 + beta**2, ynorm2=zero,
        gmax=jnp.abs(alfa) + eps, gmin=jnp.abs(alfa) + eps,
        cgnorm=beta1, lqnorm=beta1, diag=jnp.where(alfa == 0, eps, alfa),
        acond=zero, anorm=zero,
        istop=istop0.astype(jnp.int32),
        itn=jnp.zeros((), jnp.int32),
        nmv=jnp.where(dead, 0, 1).astype(jnp.int32),
        done=dead, hist=hist, iters=iters_buf)

    def cond(s):
        return ~s["done"] & (s["nmv"] < matvec_max)

    def body(s):
        itn = s["itn"] + 1
        # ---- estimate norms and test (top of loop, symmlq.py:237-277) ----
        anorm = jnp.sqrt(s["tnorm"])
        ynorm = jnp.sqrt(s["ynorm2"])
        epsa = anorm * eps
        epsx = anorm * ynorm * eps
        epsr = anorm * ynorm * rtol
        diag = jnp.where(s["gbar"] == 0, epsa, s["gbar"])
        lqnorm = jnp.sqrt(s["rhs1"]**2 + s["rhs2"]**2)
        qrnorm = s["snprod"] * beta1
        cgnorm = qrnorm * s["beta"] / jnp.abs(diag)
        acond = jnp.where(lqnorm < cgnorm, s["gmax"] / s["gmin"],
                          s["gmax"] / jnp.minimum(s["gmin"], jnp.abs(diag)))

        def tests(code):
            code = jnp.where(s["nmv"] >= matvec_max, 5, code)
            code = jnp.where(acond >= 0.1 / eps, 4, code)
            code = jnp.where(epsx >= beta1, 3, code)
            code = jnp.where(cgnorm <= epsx, 2, code)
            code = jnp.where(cgnorm <= epsr, 1, code)
            return code.astype(jnp.int32)

        istop = jnp.where(s["istop"] == 0, tests(s["istop"]), s["istop"])
        s_tested = dict(s, itn=itn, istop=istop, cgnorm=cgnorm,
                        lqnorm=lqnorm, diag=diag, acond=acond, anorm=anorm,
                        hist=history_push(s["hist"], itn, cgnorm))

        def stop(_):
            return dict(s_tested, done=True)

        def step(_):
            # ---- Lanczos step (symmlq.py:286-302) ------------------------
            v = s["y"] / s["beta"]
            y = apply_op(A, v)
            nmv = s["nmv"] + 1
            y = y - shift * v
            y = y - (s["beta"] / s["oldb"]) * s["r1"]
            alfa = jnp.vdot(v, y).real.astype(dtype)
            y = y - (alfa / s["beta"]) * s["r2"]
            r1, r2 = s["r2"], y
            y2 = apply_op(M, r2) if M is not None else r2
            oldb = s["beta"]
            beta_sq = jnp.vdot(r2, y2).real.astype(dtype)
            indef = beta_sq < 0

            def on_indef(_):
                return dict(s_tested, nmv=nmv,
                            istop=jnp.asarray(6, jnp.int32), done=True)

            def rotate(_):
                beta = jnp.sqrt(beta_sq)
                tnorm = s["tnorm"] + alfa**2 + oldb**2 + beta**2
                # ---- plane rotation for Q (symmlq.py:307-315) -------------
                gamma = jnp.hypot(s["gbar"], oldb)
                cs = s["gbar"] / gamma
                sn = oldb / gamma
                delta = cs * s["dbar"] + sn * alfa
                gbar = sn * s["dbar"] - cs * alfa
                epsln = sn * beta
                dbar = -cs * beta
                # ---- update x along LQ directions (symmlq.py:319-325) -----
                z = s["rhs1"] / gamma
                x = s["x"] + (z * cs) * s["w"] + (z * sn) * v
                w = sn * s["w"] - cs * v
                # ---- step along b + norms (symmlq.py:331-338) -------------
                bstep = s["snprod"] * cs * z + s["bstep"]
                snprod = s["snprod"] * sn
                gmax = jnp.maximum(s["gmax"], gamma)
                gmin = jnp.minimum(s["gmin"], gamma)
                ynorm2 = z**2 + s["ynorm2"]
                rhs1 = s["rhs2"] - delta * z
                rhs2 = -epsln * z
                iters2 = history_push(s["iters"], itn, x)
                return dict(
                    x=x, w=w, r1=r1, r2=r2, y=y2,
                    oldb=oldb, beta=beta, gbar=gbar, dbar=dbar,
                    rhs1=rhs1, rhs2=rhs2, snprod=snprod, bstep=bstep,
                    tnorm=tnorm, ynorm2=ynorm2, gmax=gmax, gmin=gmin,
                    cgnorm=cgnorm, lqnorm=lqnorm, diag=diag,
                    acond=acond, anorm=anorm,
                    istop=istop, itn=itn, nmv=nmv, done=False,
                    hist=s_tested["hist"], iters=iters2)

            return jax.lax.cond(indef, on_indef, rotate, None)

        return jax.lax.cond(istop != 0, stop, step, None)

    s = jax.lax.while_loop(cond, body, state0)
    # Budget exhausted via the loop guard: the reference leaves istop=0
    # there (its in-loop nMatvec>=matvec_max test is unreachable); report
    # the iteration limit explicitly instead.
    s["istop"] = jnp.where((s["istop"] == 0) & ~zero_b,
                           jnp.asarray(5, jnp.int32), s["istop"])

    # ---- move to the CG point if better (symmlq.py:356-365) --------------
    move = s["cgnorm"] < s["lqnorm"]
    zbar = s["rhs1"] / s["diag"]
    bstep = jnp.where(move, s["snprod"] * zbar + s["bstep"], s["bstep"])
    x = jnp.where(move, s["x"] + zbar * s["w"], s["x"])

    # ---- add the step along b (symmlq.py:367-374) -------------------------
    bstep = safe_div(bstep, beta1)
    yb = apply_op(M, b) if M is not None else b
    x = x + bstep * yb

    # ---- true final residual, one counted matvec (symmlq.py:376-381) ------
    Ax = apply_op(A, x) - shift * x
    rnorm = jnp.linalg.norm(b - Ax)
    xnorm = jnp.linalg.norm(x)
    nmv = s["nmv"] + jnp.where(s["done"] & (s["nmv"] == 0), 0, 1)

    x = jnp.where(zero_b, jnp.zeros(n, dtype), x)
    rnorm = jnp.where(zero_b, zero, rnorm)
    istop = s["istop"]
    converged = zero_b | jnp.isin(istop, jnp.asarray(_CONVERGED_CODES))
    return SolveResult(
        x=x, converged=converged, istop=istop,
        n_iter=s["itn"], n_matvec=nmv,
        resid_norm=rnorm, resid_norm0=beta1,
        resid_history=s["hist"],
        info={"Anorm": s["anorm"], "Acond": s["acond"], "xnorm": xnorm,
              "cgnorm": s["cgnorm"], "lqnorm": s["lqnorm"],
              **({"iterates": s["iters"]} if store_iterates else {})})


def symmlq(A, b, *, M=None, shift=0.0, rtol=1.0e-9, matvec_max=None,
           check=False, store_history=False, store_iterates=False,
           verify_final=False):
    """Solve symmetric (possibly indefinite) ``(A - shift I) x = b`` by
    SYMMLQ.

    Parameters
    ----------
    A : symmetric LinearOperator or dense array.
    b : right-hand side.
    M : optional symmetric positive-definite preconditioner.
    shift : solves the shifted system (``symmlq.py:91-92``).
    rtol : relative stopping tolerance (reference default 1e-9).
    matvec_max : matvec cap, default 2n+2 (``symmlq.py:87``).
    check : host-side randomized symmetry checks of A and M; failures
        yield istop 6/7 without running the iteration
        (``symmlq.py:138-146,163-171``).
    store_history : keep CG-point residual-norm estimates per iteration.

    Returns :class:`SolveResult`; ``resid_norm`` is the *true* final
    residual recomputed with an extra matvec, as in the reference.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "symmlq")
    n = b.shape[0]
    if matvec_max is None:
        matvec_max = 2 * n + 2

    if check:
        zero = jnp.zeros((), b.dtype)
        fail = None
        if not _check_symmetric(A):
            fail = 6
        elif M is not None and not _check_symmetric(M):
            fail = 7
        if fail is not None:
            return SolveResult(
                x=jnp.zeros(n, b.dtype), converged=jnp.asarray(False),
                istop=jnp.asarray(fail, jnp.int32),
                n_iter=jnp.asarray(0, jnp.int32),
                n_matvec=jnp.asarray(0, jnp.int32),
                resid_norm=zero, resid_norm0=zero, info={})

    res = _symmlq(A, b, M, float(shift), float(rtol), int(matvec_max),
                  bool(store_history), bool(store_iterates))
    if verify_final:
        from .common import attach_true_residual
        res = attach_true_residual(A, b, res, float(shift))
    return res
