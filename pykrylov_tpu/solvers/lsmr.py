"""LSMR (Fong & Saunders) as a fused ``lax.while_loop``.

JAX-native redesign of the reference LSMR
(``/root/reference/pykrylov/lls/lsmr.py:28-492``, after
arxiv.org/abs/1006.0758).  Solves ``Ax = b`` / ``min ||Ax - b||`` /
the damped problem for rectangular A; same Golub-Kahan bidiagonalization
as LSQR but minimizes ``||A' r||``, giving monotone normal-equations
residuals.  One forward + one transpose matvec per iteration.

Preserved semantics (SURVEY §2.3):
  * the double-QR recurrence (rotations Q, Qbar, Qtilde,
    ``lsmr.py:336-400``) built on the stable ``symOrtho`` Givens
    (``lsmr.py:500-519``);
  * recursive ``||r||`` estimate (``lsmr.py:375-400``);
  * ``condA`` from max/min rhobar (``lsmr.py:407-411``);
  * istop codes 0-8, same test ordering as LSQR (``lsmr.py:437-448``);
  * M / N inner preconditioners and ``damp`` handled in the Qhat rotation.

Contract difference (intentional, SURVEY §7): the reference returns a bare
tuple here while every other solver sets attributes (``lsmr.py:492``); this
build unifies on :class:`SolveResult` with the tuple fields in ``info``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import (as_operator, history_init, history_push, promote_rhs,
                     table_init, table_push)
from .lls_common import gk_init, gk_step, sym_ortho
from .result import SolveResult

__all__ = ["lsmr", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "the exact solution is x = 0",
    1: "x is an approximate solution to Ax = b, given atol, btol",
    2: "x approximately solves the least-squares problem, given atol",
    3: "cond(A) seems to be greater than conlim",
    4: "Ax - b is small enough for this machine",
    5: "the least-squares solution is good enough for this machine",
    6: "cond(A) seems to be too large for this machine",
    7: "the iteration limit has been reached",
    8: "the truncated direct error is small enough, given etol",
}

_OPTIMAL_CODES = (0, 1, 2, 4, 5, 8)


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history",
                                   "store_table"))
def _lsmr(A, b, M, N, damp, atol, btol, conlim, etol, itnlim, window,
          store_history, store_table=False):
    n = A.nargin
    dtype = b.dtype
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)
    ctol = jnp.where(conlim > 0, 1.0 / conlim, 0.0).astype(dtype)

    u, Mu, v, Nv, alpha, beta = gk_init(A, b, M, N, n)
    normb = beta
    normar0 = alpha * beta
    x_is_zero = normar0 == 0

    hist = history_init(store_history, itnlim, dtype)
    hist = history_push(hist, 0, beta)
    # show-table columns: x(1), normr, normar, test1, test2, normA, condA
    # (row 0 replicates the reference's pre-loop line, lsmr.py:285-293)
    tab = table_init(store_table, itnlim, 7, dtype)
    tab = table_push(tab, 0, zero, beta, normar0, one,
                     jnp.where(x_is_zero, one, alpha / beta), zero, zero)

    state0 = dict(
        x=jnp.zeros(n, dtype), h=v, hbar=jnp.zeros(n, dtype),
        u=u, Mu=Mu, v=v, Nv=Nv, alpha=alpha, beta=beta,
        zetabar=alpha * beta, alphabar=alpha,
        rho=one, rhobar=one, cbar=one, sbar=zero,
        betadd=beta, betad=zero, rhodold=one, tautildeold=zero,
        thetatilde=zero, zeta=zero, d=zero,
        normA2=alpha * alpha, maxrbar=zero,
        minrbar=jnp.asarray(jnp.inf, dtype),  # reference's 1e100 overflows f32
        normr=beta, normar=normar0, normA=alpha, condA=one, normx=zero,
        x_nrg2=zero, d_err=jnp.zeros(window, dtype),
        istop=jnp.zeros((), jnp.int32), itn=jnp.zeros((), jnp.int32),
        done=x_is_zero, hist=hist, tab=tab)

    def cond(s):
        return ~s["done"] & (s["itn"] < itnlim)

    def body(s):
        itn = s["itn"] + 1
        u, Mu, v, Nv, alpha, beta = gk_step(A, M, N, s["v"], s["Mu"],
                                            s["Nv"], s["alpha"])

        # ---- rotations (lsmr.py:336-365) --------------------------------
        chat, shat, alphahat = sym_ortho(s["alphabar"], damp)
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

        # ---- update h, hbar, x (lsmr.py:367-371) ------------------------
        hbar = s["h"] - (thetabar * rho / (rhoold * rhobarold)) * s["hbar"]
        x = s["x"] + (zeta / (rho * rhobar)) * hbar
        h = v - (thetanew / rho) * s["h"]

        # ---- direct-error window (lsmr.py:376-384) ----------------------
        x_nrg2 = s["x_nrg2"] + zeta * zeta
        d_err = s["d_err"].at[itn % window].set(zeta)
        trnc = jnp.linalg.norm(d_err)
        istop = jnp.where((itn > window) & (trnc < etol * jnp.sqrt(x_nrg2)),
                          jnp.asarray(8, jnp.int32), s["istop"])

        # ---- ||r|| estimate (lsmr.py:386-404) ---------------------------
        betaacute = chat * s["betadd"]
        betacheck = -shat * s["betadd"]
        betahat = c * betaacute
        betadd = -sn * betaacute
        thetatildeold = s["thetatilde"]
        ctildeold, stildeold, rhotildeold = sym_ortho(s["rhodold"], thetabar)
        thetatilde = stildeold * rhobar
        rhodold = ctildeold * rhobar
        betad = -stildeold * s["betad"] + ctildeold * betahat
        tautildeold = (zetaold - thetatildeold * s["tautildeold"]) \
            / rhotildeold
        taud = (zeta - thetatilde * tautildeold) / rhodold
        d = s["d"] + betacheck * betacheck
        normr = jnp.sqrt(d + (betad - taud)**2 + betadd * betadd)

        # ---- ||A|| and cond(A) estimates (lsmr.py:406-412) --------------
        normA2 = s["normA2"] + beta * beta
        normA = jnp.sqrt(normA2)
        normA2 = normA2 + alpha * alpha
        maxrbar = jnp.maximum(s["maxrbar"], rhobarold)
        minrbar = jnp.where(itn > 1,
                            jnp.minimum(s["minrbar"], rhobarold),
                            s["minrbar"])
        condA = jnp.maximum(maxrbar, rhotemp) / jnp.minimum(minrbar, rhotemp)

        # ---- convergence tests (lsmr.py:416-448) ------------------------
        normar = jnp.abs(zetabar)
        normx = jnp.linalg.norm(x)
        test1 = normr / normb
        test2 = normar / (normA * normr)
        test3 = 1.0 / condA
        t1 = test1 / (1 + normA * normx / normb)
        rtol = btol + atol * normA * normx / normb

        istop = jnp.where(itn >= itnlim, 7, istop)
        istop = jnp.where(1 + test3 <= 1, 6, istop)
        istop = jnp.where(1 + test2 <= 1, 5, istop)
        istop = jnp.where(1 + t1 <= 1, 4, istop)
        istop = jnp.where(test3 <= ctol, 3, istop)
        istop = jnp.where(test2 <= atol, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)
        istop = istop.astype(jnp.int32)

        return dict(
            x=x, h=h, hbar=hbar, u=u, Mu=Mu, v=v, Nv=Nv,
            alpha=alpha, beta=beta,
            zetabar=zetabar, alphabar=alphabar,
            rho=rho, rhobar=rhobar, cbar=cbar, sbar=sbar,
            betadd=betadd, betad=betad, rhodold=rhodold,
            tautildeold=tautildeold, thetatilde=thetatilde, zeta=zeta, d=d,
            normA2=normA2, maxrbar=maxrbar, minrbar=minrbar,
            normr=normr, normar=normar, normA=normA, condA=condA,
            normx=normx, x_nrg2=x_nrg2, d_err=d_err,
            istop=istop, itn=itn, done=istop > 0,
            hist=history_push(s["hist"], itn, normr),
            tab=table_push(s["tab"], itn, x[0].real, normr, normar,
                           test1, test2, normA, condA))

    s = jax.lax.while_loop(cond, body, state0)
    istop = s["istop"]
    optimal = jnp.isin(istop, jnp.asarray(_OPTIMAL_CODES))
    return SolveResult(
        x=s["x"], converged=optimal, istop=istop,
        n_iter=s["itn"], n_matvec=2 * s["itn"],
        resid_norm=s["normr"], resid_norm0=normb,
        resid_history=s["hist"],
        info=_lsmr_info(s, optimal))


def _lsmr_info(s, optimal):
    info = {"normr": s["normr"], "normar": s["normar"],
            "normA": s["normA"], "condA": s["condA"],
            "normx": s["normx"], "x_nrg2": s["x_nrg2"],
            "optimal": optimal}
    if s["tab"] is not None:
        info["show_table"] = s["tab"]
    return info


def lsmr(A, b, *, damp=0.0, M=None, N=None, atol=1.0e-9, btol=1.0e-9,
         conlim=1.0e8, etol=1.0e-6, window=5, itnlim=None,
         store_history=False, show=False, verify_final=False):
    """Solve ``min ||Ax - b||`` (or the damped variant) by LSMR.

    Parameters mirror :func:`lsqr`; LSMR minimizes ``||A'r||`` so its
    normal-equations residual decreases monotonically, making it safer to
    terminate early on least-squares problems.  ``itnlim`` defaults to
    min(m, n) (``lsmr.py:191-193``).

    ``verify_final=True`` appends ``info["true_resid_norm"]`` and
    ``info["true_normar"]`` — the verified counterparts of normr/normar
    (see :func:`lsqr`); two uncounted diagnostic matvecs.

    Returns :class:`SolveResult` with the reference tuple's fields
    (normr, normar, normA, condA, normx) in ``info``.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    b = promote_rhs(b, A, M, N)
    if itnlim is None:
        itnlim = min(A.nargout, A.nargin)
    if show:
        from .show import lsmr_preamble
        lsmr_preamble(A.nargout, A.nargin, float(damp), float(atol),
                      float(btol), float(conlim), int(itnlim))
    res = _lsmr(A, b, M, N, float(damp), float(atol), float(btol),
                float(conlim), float(etol), int(itnlim), int(window),
                bool(store_history), bool(show))
    if show:
        from .show import print_lsmr
        ctol = 1.0 / float(conlim) if conlim > 0 else 0.0
        print_lsmr(res, n=A.nargin, itnlim=int(itnlim),
                   atol=float(atol), rtol=float(btol), ctol=ctol)
    if verify_final:
        from .common import attach_true_lls_residual
        res = attach_true_lls_residual(A, b, res, float(damp))
    return res
