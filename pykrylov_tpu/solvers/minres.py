"""MINRES (Paige & Saunders) as a fused ``lax.while_loop``.

JAX-native redesign of the reference MINRES
(``/root/reference/pykrylov/minres/minres.py:23-410``, itself a translation
of the Stanford SOL MATLAB code).  Symmetric, possibly indefinite or
singular systems ``(A - shift I) x = b``, also usable for ``min ||Ax-b||``.
One matvec + one preconditioner solve per iteration; Lanczos tridiagonal-
ization with a Givens-QR update of the solution.

Preserved semantics (SURVEY §2.3):
  * the full 12-code ``istop`` table (-1..10, ``minres.py:87-98``) with the
    reference's exact test ordering (``minres.py:348-361``);
  * ``shift`` solves ``(A - shift I) x = b`` (``minres.py:239-240``);
  * norm estimates ``Anorm``, ``Acond``, ``Arnorm``, ``ynorm``
    (``minres.py:321-344``) returned in ``result.info``;
  * energy-norm truncated direct-error window stop ``etol``/``window``
    (``minres.py:303-310``) — the rolling window is a fixed device buffer;
  * optional host-side symmetry checks of ``A`` and ``M``
    (``minres.py:186-197``) via :func:`pykrylov_tpu.utils.check_symmetric`;
  * ``converged`` iff ``istop in {1,2,3,4,10}`` (``minres.py:395``).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .common import (as_operator, apply_op, history_init, history_push,
                     promote_rhs, require_square, table_init, table_push)
from .result import SolveResult
from ..utils.ff import (two_sum, two_prod, ff_add_ff, ff_div, ff_mul,
                        ff_hypot, ff_sqrt, ff_vdot)
from ..utils.utils import check_symmetric as _check_symmetric

__all__ = ["minres", "ISTOP_MSG"]

ISTOP_MSG = {
    -1: "beta2 = 0. If M = I, b and x are eigenvectors",
    0: "beta1 = 0. The exact solution is x = 0",
    1: "a solution to Ax = b was found, given rtol",
    2: "a least-squares solution was found, given rtol",
    3: "reasonable accuracy achieved, given eps",
    4: "acond has exceeded 0.1/eps",
    5: "the iteration limit was reached",           # (unused; kept for table parity)
    6: "iteration limit reached or indefinite preconditioner",
    7: "A does not define a symmetric operator",
    8: "M does not define a symmetric operator",
    9: "M does not define a positive-definite preconditioner",
    10: "the truncated direct error is small enough, given etol",
}

_CONVERGED_CODES = (1, 2, 3, 4, 10)


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history",
                                   "store_iterates", "store_table",
                                   "replace_every", "ff_mv"))
def _minres(A, b, M, shift, rtol, etol, itnlim, window, store_history,
            store_iterates, store_table=False, atol=0.0,
            replace_every=None, ff_mv=None):
    dtype = b.dtype
    n = b.shape[0]
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    verified = replace_every is not None

    x = jnp.zeros(n, dtype)
    r1 = b
    y = apply_op(M, b) if M is not None else b
    beta1_sq = jnp.vdot(b, y).real.astype(dtype)

    indef_precon = beta1_sq < 0
    zero_b = beta1_sq == 0
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0))
    bnorm = jnp.linalg.norm(b)
    # verified stopping works on the PLAIN true-residual 2-norm (the
    # quantity the certificate can actually attest; mirrors ff-CG's
    # documented deviation in solvers/cg.py) — the recurrence's
    # preconditioned-norm tests only gate WHEN to verify
    vthresh = jnp.maximum(jnp.asarray(atol, dtype),
                          jnp.asarray(rtol, dtype) * bnorm)

    hist = history_init(store_history, itnlim, dtype)
    hist = history_push(hist, 0, beta1)
    # Optional iterate history + direct-error telemetry (the reference's
    # ``store_iterates``/``dir_errors_window``, minres.py:105-107,303-310).
    iters_buf = (jnp.full((itnlim + 1, n), jnp.nan, dtype=dtype)
                 .at[0].set(x) if store_iterates else None)
    derr_hist = (jnp.full((itnlim + 1,), jnp.nan, dtype=dtype)
                 if store_history else None)
    # show-table columns: x[0], test1, test2, Anorm, Acond, gbar, ynorm
    tab = table_init(store_table, itnlim, 7, dtype)

    zero = jnp.zeros((), dtype)
    state0 = dict(
        x=x, r1=r1, r2=r1, y=y, w=jnp.zeros(n, dtype),
        w2=jnp.zeros(n, dtype),
        oldb=zero, beta=beta1, dbar=zero, epsln=zero,
        phibar=beta1, rhs1=beta1, rhs2=zero,
        tnorm2=zero, ynorm2=zero,
        cs=-jnp.ones((), dtype), sn=zero,
        gmax=zero, gmin=zero, x_nrg2=zero,
        d_err=jnp.zeros(window, dtype),
        anorm=zero, acond=zero, ynorm=zero, arnorm=zero, rnorm=beta1,
        istop=jnp.where(indef_precon, 9, 0).astype(jnp.int32),
        itn=jnp.zeros((), jnp.int32),
        done=indef_precon | zero_b,
        hist=hist, iters=iters_buf, derrs=derr_hist, tab=tab)
    if verified:
        # double-f32 low parts of x and of the w direction recurrence
        # (the w three-term recurrence is MINRES's dominant drift source:
        # the residual gap grows ~eps*kappa(A) through it — Sleijpen,
        # van der Vorst & Modersitzki '00 — vs CG's milder behavior), the
        # last verified true residual, the replacement count, and the
        # iteration of the last verification (rate-limits the
        # claims-triggered checks once phibar sits under the threshold)
        state0.update(xl=jnp.zeros(n, dtype), wl=jnp.zeros(n, dtype),
                      w2l=jnp.zeros(n, dtype), rnt=bnorm,
                      yl=jnp.zeros(n, dtype), r1l=jnp.zeros(n, dtype),
                      r2l=jnp.zeros(n, dtype),
                      csl=zero, snl=zero, dbarl=zero, epslnl=zero,
                      phibarl=zero, betal=zero, oldbl=zero,
                      nrep=jnp.zeros((), jnp.int32),
                      lastv=jnp.zeros((), jnp.int32))

    def cond(s):
        return ~s["done"] & (s["itn"] < itnlim)

    def body(s):
        itn = s["itn"] + 1
        # ---- Lanczos step (minres.py:236-255) --------------------------
        if not verified:
            v = s["y"] / s["beta"]
            y = apply_op(A, v) - shift * v
            y = jnp.where(itn >= 2,
                          y - (s["beta"] / s["oldb"]) * s["r1"], y)
            alfa = jnp.vdot(v, y).real.astype(dtype)
            y = y - (alfa / s["beta"]) * s["r2"]
            r1, r2 = s["r2"], y
            y = apply_op(M, r2) if M is not None else r2
            oldb = s["beta"]
            beta_sq = jnp.vdot(r2, y).real.astype(dtype)
            vl = r1l = r2l = yl_new = None
        else:
            # Double-f32 Lanczos: carrying x/w accurately is NOT enough —
            # the attainable true residual is bounded by the Lanczos
            # RELATION error ``A V_k = V_{k+1} T_k + E_k`` times ||y_k||,
            # and plain f32 matvecs leave ||E_k|| ~ eps*||A|| (measured
            # floor 7.7e-4 relative on 1138bus/Jacobi with ff x/w only).
            # So in verified mode the whole three-term recurrence rides
            # (hi, lo) pairs and the matvec is compensated when the
            # operator storage supports it — the same lever that lets
            # ff-CG reach verified 1e-6 on chip (solvers/cg.py).
            # alfa and beta ride pairs computed with COMPENSATED dot
            # products (ff_vdot): plain f32 reductions leave eps-level
            # errors in the T entries, which degrade local Lanczos
            # orthogonality 1e7x faster than f64 (Paige) — the basis
            # stalls long before the rotation chain does.
            v, vl = ff_div(s["y"], s["yl"], s["beta"], s["betal"])
            if ff_mv is not None:
                y, ylo = ff_mv(A._params, v, vl)
            else:
                y, ylo = apply_op(A, v), apply_op(A, vl)
            ph0, pe0 = two_prod(-shift, v)
            y, ylo = ff_add_ff(y, ylo, ph0, pe0 - shift * vl)
            c1, c1l = ff_div(s["beta"], s["betal"], s["oldb"],
                             s["oldbl"])
            t1h, t1l = two_prod(-c1, s["r1"])
            y2h, y2l = ff_add_ff(y, ylo, t1h,
                                 t1l - c1 * s["r1l"] - c1l * s["r1"])
            y = jnp.where(itn >= 2, y2h, y)
            ylo = jnp.where(itn >= 2, y2l, ylo)
            alfa, alfal = ff_vdot(v, vl, y, ylo)
            c2, c2l = ff_div(alfa, alfal, s["beta"], s["betal"])
            t2h, t2l = two_prod(-c2, s["r2"])
            y, ylo = ff_add_ff(y, ylo, t2h,
                               t2l - c2 * s["r2l"] - c2l * s["r2"])
            r1, r1l = s["r2"], s["r2l"]
            r2, r2l = y, ylo
            if M is not None:
                # M applied pairwise to (hi, lo); the TRUE-residual
                # certificate never involves M, this only keeps the
                # preconditioned recurrence quantities accurate
                y, yl_new = apply_op(M, r2), apply_op(M, r2l)
            else:
                y, yl_new = r2, r2l
            oldb, oldbl = s["beta"], s["betal"]
            beta_sq, beta_sql = ff_vdot(r2, r2l, y, yl_new)
        indef = beta_sq < 0  # istop=6 break (minres.py:251-255)

        def on_indef(_):
            return dict(s, itn=itn, istop=jnp.asarray(6, jnp.int32),
                        done=True)


        def step(_):
            if verified:
                beta, betal = ff_sqrt(jnp.maximum(beta_sq, 0), beta_sql)
                betal = jnp.where(beta_sq > 0, betal, 0.0)
            else:
                beta = jnp.sqrt(beta_sq)
            tnorm2 = s["tnorm2"] + alfa**2 + oldb**2 + beta**2
            near_const = beta / beta1 <= 10 * eps
            istop = jnp.where((itn == 1) & near_const,
                              jnp.asarray(-1, jnp.int32), s["istop"])
            gmax0 = jnp.where(itn == 1, jnp.abs(alfa), s["gmax"])
            gmin0 = jnp.where(itn == 1, jnp.abs(alfa), s["gmin"])

            # ---- previous rotation (minres.py:266-289) ------------------
            oldeps = s["epsln"]
            if not verified:
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
            else:
                # Double-f32 Givens chain.  With ff vectors alone the
                # recurrence's phibar plunged to 1e-15 while the true
                # residual stalled at 7e-4 (measured, 1138bus/Jacobi):
                # the x-assembly error is AMPLIFIED scalar rounding in
                # the rotation chain (the kappa factor of Sleijpen-van
                # der Vorst-Modersitzki rides delta/gamma/phi), so the
                # scalars must ride (hi, lo) pairs too — O(1) extra work
                # per iteration.
                zl = jnp.zeros((), dtype)
                oldepsl = s["epslnl"]
                d1h, d1l = ff_mul(s["cs"], s["csl"], s["dbar"],
                                  s["dbarl"])
                d2h, d2l = ff_mul(s["sn"], s["snl"], alfa, alfal)
                delta, deltal = ff_add_ff(d1h, d1l, d2h, d2l)
                g1h, g1l = ff_mul(s["sn"], s["snl"], s["dbar"],
                                  s["dbarl"])
                g2h, g2l = ff_mul(s["cs"], s["csl"], alfa, alfal)
                gbar, gbarl = ff_add_ff(g1h, g1l, -g2h, -g2l)
                epsln, epslnl = ff_mul(s["sn"], s["snl"], beta, betal)
                dbar, dbarl = ff_mul(-s["cs"], -s["csl"], beta, betal)
                root = jnp.hypot(gbar, dbar)
                arnorm = s["phibar"] * root

                gamma, gammal = ff_hypot(gbar, gbarl, beta, betal)
                gammal = jnp.where(gamma <= eps, 0.0, gammal)
                gamma = jnp.maximum(gamma, eps)
                cs, csl = ff_div(gbar, gbarl, gamma, gammal)
                sn, snl = ff_div(beta, betal, gamma, gammal)
                phi, phil = ff_mul(cs, csl, s["phibar"], s["phibarl"])
                phibar, phibarl = ff_mul(sn, snl, s["phibar"],
                                         s["phibarl"])

            # ---- solution update (minres.py:293-297) --------------------
            w1, w2 = s["w2"], s["w"]
            if not verified:
                w = (v - oldeps * w1 - delta * w2) / gamma
                x = s["x"] + phi * w
            else:
                # double-f32 w recurrence + x update: each term of
                # w = (v - oldeps*w1 - delta*w2)/gamma is formed with an
                # error-free product and the low parts are carried, so
                # the eps*kappa residual-gap growth of the plain f32
                # recurrence collapses to matvec-rounding level
                w1l, w2l_ = s["w2l"], s["wl"]
                t1h, t1l = two_prod(-oldeps, w1)
                t1l = t1l - oldeps * w1l - oldepsl * w1
                t2h, t2l = two_prod(-delta, w2)
                t2l = t2l - delta * w2l_ - deltal * w2
                sh, sl = two_sum(v, t1h)
                sh, e2 = two_sum(sh, t2h)
                w, wl = ff_div(sh, sl + e2 + t1l + t2l + vl,
                               gamma, gammal)
                uh, ue = two_prod(phi, w)
                x, xl = ff_add_ff(s["x"], s["xl"], uh,
                                  ue + phi * wl + phil * w)

            # ---- truncated direct-error window (minres.py:303-310) ------
            x_nrg2 = s["x_nrg2"] + phi * phi
            d_err = s["d_err"].at[itn % window].set(phi)
            trnc = jnp.linalg.norm(d_err)
            # The reference only emits direct-error estimates once the
            # window is full (minres.py:303-310); earlier slots stay NaN.
            derr_val = jnp.where(itn > window,
                                 trnc / jnp.sqrt(x_nrg2),
                                 jnp.asarray(jnp.nan, dtype))
            derrs = history_push(s["derrs"], itn, derr_val)
            iters2 = history_push(s["iters"], itn, x)
            small_err = (itn > window) & (trnc < etol * jnp.sqrt(x_nrg2))
            if not verified:  # code 10 is an unverified estimate too
                istop = jnp.where((istop == 0) & small_err,
                                  jnp.asarray(10, jnp.int32), istop)

            gmax = jnp.maximum(gmax0, gamma)
            gmin = jnp.minimum(gmin0, gamma)
            z = s["rhs1"] / gamma
            ynorm2 = z**2 + s["ynorm2"]
            rhs1 = s["rhs2"] - delta * z
            rhs2 = -epsln * z

            # ---- norm estimates + stopping tests (minres.py:321-361) ----
            anorm = jnp.sqrt(tnorm2)
            ynorm = jnp.sqrt(ynorm2)
            epsx = anorm * ynorm * eps
            epsr = anorm * ynorm * rtol
            qrnorm = phibar
            rnorm = qrnorm
            test1 = rnorm / (anorm * ynorm)
            test2 = root / anorm
            acond = gmax / gmin

            def tests(code):
                # Reference ordering: later assignments overwrite earlier.
                code = jnp.where(1 + test2 <= 1, 2, code)
                code = jnp.where(1 + test1 <= 1, 1, code)
                code = jnp.where(itn >= itnlim, 6, code)
                code = jnp.where(acond >= 0.1 / eps, 4, code)
                code = jnp.where(epsx >= beta1, 3, code)
                code = jnp.where(test2 <= rtol, 2, code)
                code = jnp.where(test1 <= rtol, 1, code)
                return code.astype(jnp.int32)

            extra = {}
            if not verified:
                istop = jnp.where(istop == 0, tests(istop), istop)
            else:
                # Verified stopping: the recurrence's convergence tests
                # (codes 1/2/3) are estimates of quantities an f32
                # recurrence cannot attest — only the conditioning abort
                # and the iteration limit may stop the loop unverified.
                # When phibar claims the threshold (rate-limited once it
                # sits below it) or every ``replace_every`` iterations,
                # the TRUE residual ||b - (A - shift I)(x + xl)|| is
                # recomputed compensated; istop 1 fires only on its
                # verdict.  Unlike ff-CG nothing is replaced or
                # restarted: the Lanczos recurrence keeps its momentum,
                # the ff carries keep the gap at matvec-rounding level.
                code = jnp.where(itn >= itnlim, 6, 0)
                code = jnp.where(acond >= 0.1 / eps, 4, code)
                istop = jnp.where(istop == 0, code.astype(jnp.int32),
                                  istop)
                claims = (qrnorm <= vthresh) & (itn - s["lastv"] >= 5)
                periodic = (itn % replace_every) == 0
                do_ver = claims | periodic

                def _true_resid():
                    if ff_mv is not None:
                        sh2, sl2 = ff_mv(A._params, x, xl)
                    else:
                        sh2 = apply_op(A, x)
                        sl2 = apply_op(A, xl)
                    ph, pe = two_prod(shift, x)
                    d, de = two_sum(b, -sh2)
                    d2, de2 = two_sum(d, ph)
                    rt = d2 + (de + de2 + pe + shift * xl - sl2)
                    return jnp.linalg.norm(rt)

                rnt = jax.lax.cond(do_ver, _true_resid, lambda: s["rnt"])
                istop = jnp.where((istop == 0) & do_ver
                                  & (rnt <= vthresh),
                                  jnp.asarray(1, jnp.int32), istop)
                extra = dict(xl=xl, wl=wl, w2l=s["wl"], rnt=rnt,
                             yl=yl_new, r1l=r1l, r2l=r2l,
                             csl=csl, snl=snl, dbarl=dbarl,
                             epslnl=epslnl, phibarl=phibarl,
                             betal=betal, oldbl=oldbl,
                             nrep=s["nrep"] + do_ver.astype(jnp.int32),
                             lastv=jnp.where(do_ver, itn, s["lastv"]))
            return dict(
                x=x, r1=r1, r2=r2, y=y, w=w, w2=w2,
                oldb=oldb, beta=beta, dbar=dbar, epsln=epsln,
                phibar=phibar, rhs1=rhs1, rhs2=rhs2,
                tnorm2=tnorm2, ynorm2=ynorm2, cs=cs, sn=sn,
                gmax=gmax, gmin=gmin, x_nrg2=x_nrg2, d_err=d_err,
                anorm=anorm, acond=acond, ynorm=ynorm, arnorm=arnorm,
                # stop on ANY nonzero code, incl. -1 (eigenvector rhs) —
                # the reference breaks on istop != 0; `> 0` left a -1
                # column grinding to itnlim (round-4 review finding)
                rnorm=rnorm, istop=istop, itn=itn,
                done=istop != 0,
                hist=history_push(s["hist"], itn, rnorm),
                iters=iters2, derrs=derrs,
                tab=table_push(s["tab"], itn, x[0].real, test1, test2,
                               anorm, acond, gbar, ynorm), **extra)

        return jax.lax.cond(indef, on_indef, step, None)

    s = jax.lax.while_loop(cond, body, state0)

    istop = s["istop"]
    x_out = jnp.where(zero_b, jnp.zeros(n, dtype), s["x"])
    info = _minres_info(s, store_iterates, store_history)
    if verified:
        # only the certificate counts; each Lanczos step and each
        # verification is one compensated matvec (or two plain applies —
        # hi and lo parts — when the storage has no ff path)
        converged = zero_b | (istop == 1)
        info["n_replacements"] = s["nrep"]
        info["x_lo"] = s["xl"]
        mult = 1 if ff_mv is not None else 2
        nmv = (s["itn"] + s["nrep"]) * mult
        return SolveResult(
            x=x_out, converged=converged, istop=istop,
            n_iter=s["itn"], n_matvec=nmv,
            resid_norm=jnp.where(zero_b, zero, s["rnt"]),
            resid_norm0=bnorm, resid_history=s["hist"], info=info)
    converged = zero_b | jnp.isin(istop, jnp.asarray(_CONVERGED_CODES))
    return SolveResult(
        x=x_out, converged=converged, istop=istop,
        n_iter=s["itn"], n_matvec=s["itn"],
        resid_norm=jnp.where(zero_b, zero, s["rnorm"]), resid_norm0=beta1,
        resid_history=s["hist"], info=info)


def _minres_info(s, store_iterates, store_history):
    info = {"Anorm": s["anorm"], "Acond": s["acond"],
            "Arnorm": s["arnorm"], "ynorm": s["ynorm"]}
    if store_iterates:
        info["iterates"] = s["iters"]
    if store_history:
        info["dir_errors_window"] = s["derrs"]
    if s["tab"] is not None:
        info["show_table"] = s["tab"]
    return info


def minres(A, b, *, M=None, shift=0.0, rtol=1.0e-12, etol=1.0e-6,
           window=5, itnlim=None, check=False, store_history=False,
           store_iterates=False, show=False, verify_final=False,
           replace_every=None, atol=0.0):
    """Solve symmetric (possibly indefinite/singular) ``(A - shift I) x = b``
    or ``min ||Ax - b||`` by MINRES.

    Parameters
    ----------
    A : symmetric LinearOperator or dense array.
    b : right-hand side.
    M : optional SPD preconditioner operator (the reference's ``precon``).
    shift : solves the shifted system (``minres.py:53``).
    rtol : relative stopping tolerance (reference default 1e-12).
    etol, window : truncated direct-error stopping rule in the energy norm.
    itnlim : iteration cap, default 5n (``minres.py:124``).
    check : host-side randomized symmetry checks of A and M before the
        solve (``minres.py:186-197``); failures yield istop 7/8 without
        running the iteration.
    store_history : keep residual norms in a device buffer; also records
        the reference's ``dir_errors_window`` telemetry
        (``info["dir_errors_window"]``, minres.py:105-107).
    store_iterates : keep every iterate (``info["iterates"]``,
        an (itnlim+1, n) buffer with NaN rows beyond ``n_iter``).
    show : print the reference's iteration table after the solve
        (``minres.py:375-393``) — columns are recorded in a device
        buffer during the fused loop and rendered post-hoc (host
        callbacks are unavailable mid-``while_loop``; see
        :mod:`pykrylov_tpu.solvers.show`).
    replace_every : verified f32 stopping (the MINRES counterpart of
        ff-CG's knob, see :func:`pykrylov_tpu.solvers.cg`): the solution
        and the ``w`` direction recurrence are carried as double-f32
        (hi, lo) pairs — the plain f32 w recurrence grows a residual gap
        ~eps*kappa(A) (Sleijpen–van der Vorst–Modersitzki), which is what
        floored the refined-restart path at ~1e-4 on kappa~1e7 systems —
        and the true residual ``||b - (A - shift I) x||`` is recomputed
        (compensated when the operator storage supports it) every
        ``replace_every`` iterations and whenever the recurrence claims
        convergence.  ``istop=1`` then certifies a TRUE relative residual
        ``<= max(atol, rtol * ||b||)`` (plain 2-norm — a documented
        deviation from the recurrence's preconditioned-norm tests, which
        in this mode only gate when to verify).  No restart happens:
        the Lanczos recurrence keeps its Krylov momentum.  Verification
        matvecs are counted in ``n_matvec``;
        ``info["n_replacements"]``/``info["x_lo"]`` mirror ff-CG.
    atol : absolute floor of the verified stopping rule (only used with
        ``replace_every``).

    Returns :class:`SolveResult`; ``info`` carries Anorm/Acond/Arnorm/ynorm.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "minres")
    n = b.shape[0]
    if itnlim is None:
        itnlim = 5 * n

    if check:
        zero = jnp.zeros((), b.dtype)

        def _checkfail(code):
            # Keep the documented info keys present (empty buffers) so
            # telemetry consumers don't KeyError on the failure path.
            info = {"Anorm": zero, "Acond": zero, "Arnorm": zero,
                    "ynorm": zero}
            if store_iterates:
                info["iterates"] = jnp.full((1, n), jnp.nan, b.dtype)
            if store_history:
                info["dir_errors_window"] = jnp.full((1,), jnp.nan,
                                                     b.dtype)
            return SolveResult(
                x=jnp.zeros(n, b.dtype), converged=jnp.asarray(False),
                istop=jnp.asarray(code, jnp.int32),
                n_iter=jnp.asarray(0, jnp.int32),
                n_matvec=jnp.asarray(0, jnp.int32),
                resid_norm=zero, resid_norm0=zero, info=info)

        if not _check_symmetric(A):
            return _checkfail(7)
        if M is not None and not _check_symmetric(M):
            return _checkfail(8)

    replace_every = int(replace_every) if replace_every else None
    ff_mv = None
    if replace_every is not None:
        from .ffmv import resolve_ff_matvec
        ff_mv = resolve_ff_matvec(A)
    res = _minres(A, b, M, float(shift), float(rtol), float(etol),
                  int(itnlim), int(window),
                  bool(store_history) or bool(show),
                  bool(store_iterates), bool(show), float(atol),
                  replace_every, ff_mv)
    if show:
        from .show import print_minres
        print_minres(res, n=n, itnlim=int(itnlim), rtol=float(rtol),
                     eps=float(np.finfo(np.dtype(b.dtype)).eps))
    if verify_final:
        from .common import attach_true_residual
        res = attach_true_residual(A, b, res, float(shift))
    return res
