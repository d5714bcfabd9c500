"""LSQR (Paige & Saunders) as a fused ``lax.while_loop``.

JAX-native redesign of the reference LSQR
(``/root/reference/pykrylov/lls/lsqr.py:26-454``).  Solves ``Ax = b``,
``min ||Ax - b||`` or the damped problem ``min ||Ax-b||^2 + damp^2 ||x||^2``
for rectangular A via Golub-Kahan bidiagonalization + QR by plane
rotations; one forward and one transpose matvec per iteration
(``nMatvec = 2 itn``, ``lsqr.py:445``).

Preserved semantics (SURVEY §2.3):
  * istop codes 0-8 with the reference's exact test ordering and
    machine-precision guards (``lsqr.py:361-392``);
  * ``damp`` folded in by an extra rotation (``lsqr.py:277-281``);
  * M / N inner preconditioners (M on the m-side, N on the n-side) with
    weighted norms — this is what makes LSQR solve SQD systems
    (``lsqr.py:188-210, 457-472``);
  * energy-norm direct-error window stop ``etol`` → istop 8
    (``lsqr.py:309-317``);
  * ``wantvar`` estimate of diag((A'A + damp^2 I)^{-1})
    (``lsqr.py:154-157,304``);
  * norm estimates r1norm/r2norm/Anorm/Acond/Arnorm/xnorm in ``info``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import (as_operator, history_init, history_push, promote_rhs,
                     table_init, table_push)
from .lls_common import gk_init, gk_step
from .result import SolveResult

__all__ = ["lsqr", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "the exact solution is x = 0",
    1: "x is an approximate solution to Ax = b, given atol, btol",
    2: "x approximately solves the least-squares problem, given atol",
    3: "the estimate of cond(Abar) has exceeded conlim",
    4: "Ax - b is small enough for this machine",
    5: "the least-squares solution is good enough for this machine",
    6: "cond(Abar) seems to be too large for this machine",
    7: "the iteration limit has been reached",
    8: "the truncated direct error is small enough, given etol",
}

_OPTIMAL_CODES = (0, 1, 2, 4, 5, 8)


@partial(jax.jit, static_argnames=("itnlim", "window", "wantvar",
                                   "store_history", "store_table"))
def _lsqr(A, b, M, N, damp, atol, btol, conlim, etol, itnlim, window,
          wantvar, store_history, store_table=False):
    m, n = A.nargout, A.nargin
    dtype = b.dtype
    zero = jnp.zeros((), dtype)
    dampsq = damp * damp
    ctol = jnp.where(conlim > 0, 1.0 / conlim, 0.0).astype(dtype)

    u, Mu, v, Nv, alpha, beta = gk_init(A, b, M, N, n)
    arnorm0 = alpha * beta
    x_is_zero = arnorm0 == 0

    hist = history_init(store_history, itnlim, dtype)
    hist = history_push(hist, 0, beta)
    # Normal-equations residual history ||A'r|| (the reference's
    # ``normal_eqns_resids``, lsqr.py:80,304) alongside the r2norm history.
    ne_hist = history_init(store_history, itnlim, dtype)
    ne_hist = history_push(ne_hist, 0, arnorm0)

    # show-table columns: x(1), r1norm, r2norm, test1, test2, Anorm, Acond
    # (row 0 replicates the reference's pre-loop line, lsqr.py:224-232)
    tab = table_init(store_table, itnlim, 7, dtype)
    tab = table_push(tab, 0, zero, beta, beta, jnp.ones((), dtype),
                     jnp.where(x_is_zero, 1.0, alpha / beta), zero, zero)

    state0 = dict(
        x=jnp.zeros(n, dtype), w=v, u=u, Mu=Mu, v=v, Nv=Nv,
        alpha=alpha, beta=beta,
        rhobar=alpha, phibar=beta,
        cs2=-jnp.ones((), dtype), sn2=zero, z=zero,
        xxnorm=zero, ddnorm=zero, res2=zero,
        anorm=zero, acond=zero, xnorm=zero,
        rnorm=beta, r1norm=beta, r2norm=beta, arnorm=arnorm0,
        var=jnp.zeros(n, dtype) if wantvar else zero,
        x_nrg2=zero, d_err=jnp.zeros(window, dtype),
        istop=jnp.zeros((), jnp.int32), itn=jnp.zeros((), jnp.int32),
        done=x_is_zero, hist=hist, ne_hist=ne_hist, tab=tab)
    bnorm = beta

    def cond(s):
        return ~s["done"] & (s["itn"] < itnlim)

    def body(s):
        itn = s["itn"] + 1
        # ---- bidiagonalization step (lsqr.py:252-272) -------------------
        u, Mu, v, Nv, alpha, beta = gk_step(A, M, N, s["v"], s["Mu"],
                                            s["Nv"], s["alpha"])
        anorm = jnp.sqrt(s["anorm"]**2 + s["alpha"]**2 + beta**2 + dampsq)

        # ---- rotation eliminating damp (lsqr.py:277-281) ----------------
        rhobar1 = jnp.hypot(s["rhobar"], damp)
        cs1 = s["rhobar"] / rhobar1
        sn1 = damp / rhobar1
        psi = sn1 * s["phibar"]
        phibar = cs1 * s["phibar"]

        # ---- rotation eliminating beta (lsqr.py:286-293) ----------------
        rho = jnp.hypot(rhobar1, beta)
        cs = rhobar1 / rho
        sn = beta / rho
        theta = sn * alpha
        rhobar = -cs * alpha
        phi = cs * phibar
        phibar = sn * phibar
        tau = sn * phi

        # ---- update x and w (lsqr.py:297-303) ---------------------------
        t1 = phi / rho
        t2 = -theta / rho
        dk = s["w"] / rho
        x = s["x"] + t1 * s["w"]
        w = t2 * s["w"] + v
        ddnorm = s["ddnorm"] + jnp.vdot(dk, dk).real.astype(dtype)
        var = s["var"] + dk * dk if wantvar else s["var"]

        # ---- direct-error window (lsqr.py:309-317) ----------------------
        x_nrg2 = s["x_nrg2"] + phi * phi
        d_err = s["d_err"].at[itn % window].set(phi)
        trnc = jnp.linalg.norm(d_err)
        istop = jnp.where((itn > window) & (trnc < etol * jnp.sqrt(x_nrg2)),
                          jnp.asarray(8, jnp.int32), s["istop"])

        # ---- right rotation → xnorm estimate (lsqr.py:323-332) ----------
        delta = s["sn2"] * rho
        gambar = -s["cs2"] * rho
        rhs = phi - delta * s["z"]
        zbar = rhs / gambar
        xnorm = jnp.sqrt(s["xxnorm"] + zbar**2)
        gamma = jnp.hypot(gambar, theta)
        cs2 = gambar / gamma
        sn2 = theta / gamma
        z = rhs / gamma
        xxnorm = s["xxnorm"] + z * z

        # ---- norms + tests (lsqr.py:338-392) ----------------------------
        acond = anorm * jnp.sqrt(ddnorm)
        res1 = phibar**2
        res2 = s["res2"] + psi**2
        rnorm = jnp.sqrt(res1 + res2)
        arnorm = alpha * jnp.abs(tau)
        r1sq = rnorm**2 - dampsq * xxnorm
        r1norm = jnp.sign(r1sq) * jnp.sqrt(jnp.abs(r1sq))
        r2norm = rnorm

        inf = jnp.asarray(jnp.inf, dtype)
        test1 = rnorm / bnorm
        test2 = jnp.where((anorm == 0) | (rnorm == 0), inf,
                          arnorm / (anorm * rnorm))
        test3 = jnp.where(acond == 0, inf, 1.0 / acond)
        t1t = test1 / (1 + anorm * xnorm / bnorm)
        rtol = btol + atol * anorm * xnorm / bnorm

        istop = jnp.where(itn >= itnlim, 7, istop)
        istop = jnp.where(1 + test3 <= 1, 6, istop)
        istop = jnp.where(1 + test2 <= 1, 5, istop)
        istop = jnp.where(1 + t1t <= 1, 4, istop)
        istop = jnp.where(test3 <= ctol, 3, istop)
        istop = jnp.where(test2 <= atol, 2, istop)
        istop = jnp.where(test1 <= rtol, 1, istop)
        istop = istop.astype(jnp.int32)

        return dict(
            x=x, w=w, u=u, Mu=Mu, v=v, Nv=Nv, alpha=alpha, beta=beta,
            rhobar=rhobar, phibar=phibar, cs2=cs2, sn2=sn2, z=z,
            xxnorm=xxnorm, ddnorm=ddnorm, res2=res2,
            anorm=anorm, acond=acond, xnorm=xnorm,
            rnorm=rnorm, r1norm=r1norm, r2norm=r2norm, arnorm=arnorm,
            var=var, x_nrg2=x_nrg2, d_err=d_err,
            istop=istop, itn=itn, done=istop > 0,
            hist=history_push(s["hist"], itn, r2norm),
            ne_hist=history_push(s["ne_hist"], itn, arnorm),
            tab=table_push(s["tab"], itn, x[0].real, r1norm, r2norm,
                           test1, test2, anorm, acond))

    s = jax.lax.while_loop(cond, body, state0)
    istop = s["istop"]
    optimal = jnp.isin(istop, jnp.asarray(_OPTIMAL_CODES))
    info = {"r1norm": s["r1norm"], "r2norm": s["r2norm"],
            "Anorm": s["anorm"], "Acond": s["acond"],
            "Arnorm": s["arnorm"], "xnorm": s["xnorm"],
            "bnorm": bnorm, "optimal": optimal}
    if store_history:
        info["normal_eqns_resids"] = s["ne_hist"]
    if s["tab"] is not None:
        info["show_table"] = s["tab"]
    if wantvar:
        info["var"] = s["var"]
    return SolveResult(
        x=s["x"], converged=optimal, istop=istop,
        n_iter=s["itn"], n_matvec=2 * s["itn"],
        resid_norm=s["r2norm"], resid_norm0=beta,
        resid_history=s["hist"], info=info)


def lsqr(A, b, *, damp=0.0, M=None, N=None, atol=1.0e-9, btol=1.0e-9,
         conlim=1.0e8, etol=1.0e-6, window=5, itnlim=None, wantvar=False,
         store_history=False, show=False, verify_final=False):
    """Solve ``min ||Ax - b||`` (or the damped / SQD variant) by LSQR.

    Parameters
    ----------
    A : rectangular (m x n) LinearOperator or dense array; its transpose
        product must be available.
    b : length-m right-hand side.
    damp : Tikhonov damping; solves ``min ||Ax-b||^2 + damp^2 ||x||^2``.
    M, N : optional inner preconditioners applying the *inverse* weights on
        the m-side and n-side respectively; with both given LSQR solves the
        SQD system ``[M A; A' -N] [r; x] = [b; 0]`` (``lsqr.py:457-472``).
    atol, btol, conlim : Paige-Saunders stopping tolerances.
    etol, window : truncated direct-error stop in the energy norm.
    itnlim : iteration cap, default 3n (``lsqr.py:156``).
    wantvar : also estimate diag((A'A + damp^2 I)^{-1}) in ``info['var']``.
    show : print the reference's banner and iteration table
        (``lsqr.py:168-174,406-434``) — columns are recorded in a device
        buffer during the fused loop and rendered post-hoc
        (:mod:`pykrylov_tpu.solvers.show`).
    verify_final : append the verified certificates
        ``info["true_resid_norm"]`` (= ||b - A x||) and
        ``info["true_normar"]`` (= ||A'(b - Ax) - damp^2 x||, the
        optimality residual the recursive ``Arnorm`` estimates) — two
        uncounted diagnostic matvecs, compensated forward apply when
        the operator storage supports it; Euclidean metric (M/N not
        folded in).

    Returns :class:`SolveResult`; ``converged`` is the reference's
    ``optimal`` flag (istop in {0,1,2,4,5,8}), ``n_matvec = 2 n_iter``.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    b = promote_rhs(b, A, M, N)
    if itnlim is None:
        itnlim = 3 * A.nargin
    if show:
        from .show import lsqr_preamble
        lsqr_preamble(A.nargout, A.nargin, float(damp), wantvar,
                      float(atol), float(btol), float(conlim), int(itnlim))
    res = _lsqr(A, b, M, N, float(damp), float(atol), float(btol),
                float(conlim), float(etol), int(itnlim), int(window),
                bool(wantvar), bool(store_history), bool(show))
    if show:
        from .show import print_lsqr
        ctol = 1.0 / float(conlim) if conlim > 0 else 0.0
        print_lsqr(res, itnlim=int(itnlim), atol=float(atol),
                   rtol=float(btol), ctol=ctol)
    if verify_final:
        from .common import attach_true_lls_residual
        res = attach_true_lls_residual(A, b, res, float(damp))
    return res
