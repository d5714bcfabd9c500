"""CRAIG-MR (least-norm minimum-residual) as a fused ``lax.while_loop``.

JAX-native redesign of the reference CRAIG-MR
(``/root/reference/pykrylov/lls/craigmr.py:13-250``): a minimum-residual
variant of CRAIG for least-norm problems, driven by the same Golub-Kahan
bidiagonalization with rotations of types I, II and III
(``craigmr.py:161-185``).  The solution iterate lives in the *dual* space:
``x`` has dimension m (``craigmr.py:112``).  One forward + one transpose
matvec per iteration (``nMatvec = 2 itn``).

Preserved semantics (SURVEY §2.3):
  * only istop codes 7 (iteration limit) and 8 (truncated direct error)
    are active (``craigmr.py:202-212``);
  * the reference's ``init_data`` multi-solve reset (``craigmr.py:36-49``)
    is moot here — the solver is a pure function.

Reference bug NOT replicated (SURVEY §7): the stray debug
``print itn, xNrgNorm2`` in the hot loop (``craigmr.py:190``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import as_operator, history_init, history_push, promote_rhs
from .lls_common import gk_init, gk_step
from .result import SolveResult

__all__ = ["craigmr", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "the exact solution is x = 0",
    7: "the iteration limit has been reached",
    8: "the truncated direct error is small enough, given etol",
}


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history"))
def _craigmr(A, b, M, N, etol, itnlim, window, store_history):
    m, n = A.nargout, A.nargin
    dtype = b.dtype
    zero = jnp.zeros((), dtype)
    one = jnp.ones((), dtype)

    u, Mu, v, Nv, alpha, beta = gk_init(A, b, M, N, n)
    x_is_zero = (alpha * beta) == 0

    # ---- first-iteration initialization (craigmr.py:104-120) --------------
    alpha_hat = jnp.hypot(alpha, one)
    c = alpha / alpha_hat
    s = 1.0 / alpha_hat
    zeta_hat = beta
    alpha_tilde = alpha_hat
    theta = zero
    d = u / alpha_hat

    hist = history_init(store_history, itnlim, dtype)
    hist = history_push(hist, 0, beta)

    state0 = dict(
        x=jnp.zeros(m, dtype), d=d, dbar=jnp.zeros(m, dtype),
        u=u, Mu=Mu, v=v, Nv=Nv, alpha=alpha, beta=beta,
        c=c, s=s, zeta_hat=zeta_hat, alpha_tilde=alpha_tilde, theta=theta,
        zeta=zero, x_nrg2=zero, d_err=jnp.zeros(window, dtype),
        istop=jnp.zeros((), jnp.int32), itn=jnp.zeros((), jnp.int32),
        done=x_is_zero, hist=hist)

    def cond(st):
        return ~st["done"] & (st["itn"] < itnlim)

    def body(st):
        itn = st["itn"] + 1
        u, Mu, v, Nv, alpha, beta = gk_step(A, M, N, st["v"], st["Mu"],
                                            st["Nv"], st["alpha"])

        # ---- rotations I / II / III (craigmr.py:161-185) -----------------
        beta_hat = st["c"] * beta
        gamma = st["s"] * beta
        delta = jnp.hypot(gamma, one)
        alpha_hat = jnp.hypot(alpha, delta)
        c = alpha / alpha_hat
        s = delta / alpha_hat
        rho = jnp.hypot(st["alpha_tilde"], beta_hat)
        c_hat = st["alpha_tilde"] / rho
        s_hat = beta_hat / rho

        dbar = (st["d"] - st["theta"] * st["dbar"]) / rho
        theta = s_hat * alpha_hat
        alpha_tilde = -c_hat * alpha_hat

        zeta = c_hat * st["zeta_hat"]
        zeta_hat = s_hat * st["zeta_hat"]
        x_nrg2 = st["x_nrg2"] + zeta * zeta
        d = (u - beta_hat * st["d"]) / alpha_hat
        x = st["x"] + zeta * dbar

        # ---- stopping (craigmr.py:202-212) -------------------------------
        d_err = st["d_err"].at[itn % window].set(zeta)
        trnc = jnp.linalg.norm(d_err)
        istop = jnp.where((itn > window) & (trnc < etol * jnp.sqrt(x_nrg2)),
                          jnp.asarray(8, jnp.int32), st["istop"])
        istop = jnp.where(itn >= itnlim, 7, istop).astype(jnp.int32)

        return dict(
            x=x, d=d, dbar=dbar,
            u=u, Mu=Mu, v=v, Nv=Nv, alpha=alpha, beta=beta,
            c=c, s=s, zeta_hat=zeta_hat, alpha_tilde=alpha_tilde,
            theta=theta, zeta=zeta, x_nrg2=x_nrg2, d_err=d_err,
            istop=istop, itn=itn, done=istop > 0,
            hist=history_push(st["hist"], itn, jnp.abs(zeta)))

    st = jax.lax.while_loop(cond, body, state0)
    istop = st["istop"]
    converged = x_is_zero | (istop == 8)
    return SolveResult(
        x=st["x"], converged=converged, istop=istop,
        n_iter=st["itn"], n_matvec=2 * st["itn"],
        resid_norm=jnp.abs(st["zeta"]), resid_norm0=beta,
        resid_history=st["hist"],
        info={"xNrgNorm2": st["x_nrg2"],
              "trncDirErr": jnp.linalg.norm(st["d_err"]),
              "optimal": x_is_zero | (istop == 8)})


def craigmr(A, b, *, M=None, N=None, etol=1.0e-6, window=5, itnlim=None,
            store_history=False, show=False, verify_final=False):
    """Solve the least-norm minimum-residual problem by CRAIG-MR.

    Parameters
    ----------
    A : rectangular (m x n) LinearOperator or dense array.
    b : length-m right-hand side.
    M, N : optional inner preconditioners (as in :func:`craig`).
    etol, window : truncated direct-error stopping rule — the only active
        convergence test, as in the reference (``craigmr.py:202-212``).
    itnlim : iteration cap, default min(m, n) (``craigmr.py:73-75``).

    Returns :class:`SolveResult`; the iterate is dual-space (length m,
    ``craigmr.py:112``), ``resid_history`` stores |zeta| per iteration.

    ``verify_final=True`` appends ``info["true_dual_resid"]`` =
    ||M(b - A N(A'y)) - y|| — the dual normal-equation certificate
    (with identity weights the iterate solves ``(AA' + I) y = b``);
    two uncounted diagnostic matvecs.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    b = promote_rhs(b, A, M, N)
    if itnlim is None:
        itnlim = min(A.nargout, A.nargin)
    res = _craigmr(A, b, M, N, float(etol), int(itnlim), int(window),
                   bool(store_history))
    if show:
        # reference final block (craigmr.py:214-228; its per-iteration
        # table and most summary lines are commented out upstream)
        print(" ")
        print("CRAIG-MR finished")
        print(ISTOP_MSG.get(int(res.istop), ""))
        print(" ")
        print("xNrgNorm2 = %7.1e   trnDirErr = %7.1e"
              % (float(res.info["xNrgNorm2"]),
                 float(res.info["trncDirErr"])))
        print(" ")
    if verify_final:
        from .common import apply_op, apply_op_T
        xn = apply_op_T(A, res.x)
        xn = apply_op(N, xn) if N is not None else xn
        d = b - apply_op(A, xn)
        d = (apply_op(M, d) if M is not None else d) - res.x
        res.info["true_dual_resid"] = jnp.linalg.norm(d)
    return res
