"""CRAIG (generalized, Arioli & Orban) as a fused ``lax.while_loop``.

JAX-native redesign of the reference CRAIG
(``/root/reference/pykrylov/lls/craig.py:30-520``).  Solves consistent
``Ax = b`` / the regularized problem ``min ||b - Ax||^2_D + ||x||^2_N``,
equivalently the symmetric quasi-definite (SQD) system

    [ M   A ] [ r ]   [ b ]
    [ A' -N ] [ x ] = [ 0 ],     M := inv(D),

via Golub-Kahan bidiagonalization with rotations of types I and II.
One forward + one transpose matvec per iteration (``nMatvec = 2 itn``).

Preserved semantics (SURVEY §2.3):
  * maintains BOTH the primal iterate ``x`` and the dual iterate ``r``
    (``craig.py:248-262,347-365``); ``r`` is returned in ``info['r']``;
  * energy norms ``rNrgNorm2``/``xNrgNorm2`` and the dual-based truncated
    direct-error stop on ``tau`` → istop 8 (``craig.py:370-379``);
  * only istop codes 1/4/7/8 are active (``craig.py:448-457``) — the
    reference's LSQR-style tests 2/3/5/6 are commented out there;
  * convergence test ``sqrt(rnorm)/bnorm <= btol`` (``craig.py:438-441``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import as_operator, history_init, history_push, promote_rhs
from .lls_common import gk_init, gk_step
from .result import SolveResult

__all__ = ["craig", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "the exact solution is x = 0",
    1: "Ax - b is small enough, given atol, btol",
    2: "the least-squares solution is good enough, given atol",
    3: "the estimate of cond(Abar) has exceeded conlim",
    4: "Ax - b is small enough for this machine",
    5: "the least-squares solution is good enough for this machine",
    6: "cond(Abar) seems to be too large for this machine",
    7: "the iteration limit has been reached",
    8: "the truncated direct error is small enough, given etol",
}

_OPTIMAL_CODES = (0, 1, 2, 4, 5, 8)


@partial(jax.jit, static_argnames=("itnlim", "window", "store_history",
                                   "store_iterates"))
def _craig(A, b, M, N, atol, btol, etol, itnlim, window, store_history,
           store_iterates):
    m, n = A.nargout, A.nargin
    dtype = b.dtype
    zero = jnp.zeros((), dtype)

    u, Mu, v, Nv, alpha, beta = gk_init(A, b, M, N, n)
    x_is_zero = beta == 0
    bnorm = beta

    # ---- first-iteration initialization (craig.py:247-268) ---------------
    rho = jnp.hypot(alpha, jnp.ones((), dtype))
    d = u / rho
    tau = beta / rho
    r = tau * d
    rnorm = tau * tau
    c = alpha / rho
    s = 1.0 / rho
    zeta = s * beta
    eta = c * zeta
    xi = s * zeta
    w = c * v
    wbar = s * v
    x = zeta * w
    xnorm = eta * eta
    r1norm = xi * xi

    hist = history_init(store_history, itnlim, dtype)
    hist = history_push(hist, 0, jnp.sqrt(rnorm))
    # Primal and dual iterate histories (the reference's iterates_p /
    # iterates_d, craig.py:100-101,248-262,347-365).
    ip_buf = (jnp.full((itnlim + 1, n), jnp.nan, dtype=dtype).at[0].set(x)
              if store_iterates else None)
    id_buf = (jnp.full((itnlim + 1, m), jnp.nan, dtype=dtype).at[0].set(r)
              if store_iterates else None)

    state0 = dict(
        x=x, r=r, w=w, wbar=wbar, d=d,
        u=u, Mu=Mu, v=v, Nv=Nv, alpha=alpha, beta=beta,
        c=c, s=s, zeta=zeta, tau=tau,
        rnorm=rnorm, r1norm=r1norm, xnorm=xnorm,
        arnorm=zero, r_nrg2=zero, x_nrg2=zero,
        d_err=jnp.zeros(window, dtype),
        istop=jnp.zeros((), jnp.int32), itn=jnp.zeros((), jnp.int32),
        done=x_is_zero, hist=hist, ip=ip_buf, id=id_buf)

    def cond(st):
        return ~st["done"] & (st["itn"] < itnlim)

    def body(st):
        itn = st["itn"] + 1
        u, Mu, v, Nv, alpha, beta = gk_step(A, M, N, st["v"], st["Mu"],
                                            st["Nv"], st["alpha"])
        # Residual of CRAIG's "other" normal equations (craig.py:310-314).
        arnorm = jnp.abs(st["alpha"] * beta * st["s"] * st["zeta"])

        # ---- rotations of types I and II (craig.py:333-345) --------------
        beta_hat = st["c"] * beta
        gamma = st["s"] * beta
        delta = jnp.hypot(gamma, jnp.ones((), dtype))
        s2 = gamma / delta
        c2 = -1.0 / delta
        alpha_hat = jnp.hypot(alpha, delta)
        c = alpha / alpha_hat
        s = delta / alpha_hat

        # ---- dual update (craig.py:347-350) -------------------------------
        d = (u - beta_hat * st["d"]) / alpha_hat
        tau = -beta_hat * st["tau"] / alpha_hat
        r = st["r"] + tau * d

        # ---- primal update (craig.py:354-365) -----------------------------
        zeta = -beta_hat * st["zeta"] / alpha_hat
        eta = c * zeta
        xi = s * zeta
        wbar_s = st["wbar"] * s2
        w = c * v + s * wbar_s
        wbar = -c * wbar_s + s * v
        x = st["x"] + zeta * w

        # ---- energy norms + dual direct-error stop (craig.py:370-379) -----
        r_nrg2 = st["r_nrg2"] + tau * tau
        x_nrg2 = st["x_nrg2"] + zeta * zeta
        d_err = st["d_err"].at[itn % window].set(tau)
        trnc = jnp.linalg.norm(d_err)
        istop = jnp.where((itn > window) & (trnc < etol * jnp.sqrt(r_nrg2)),
                          jnp.asarray(8, jnp.int32), st["istop"])

        rnorm = st["rnorm"] + tau * tau
        xnorm = st["xnorm"] + eta * eta
        r1norm = st["r1norm"] + xi * xi

        # ---- active tests (craig.py:438-457) ------------------------------
        test1 = jnp.sqrt(rnorm) / bnorm
        istop = jnp.where(itn >= itnlim, 7, istop)
        istop = jnp.where(1 + test1 <= 1, 4, istop)
        istop = jnp.where(test1 <= btol, 1, istop)
        istop = istop.astype(jnp.int32)

        return dict(
            x=x, r=r, w=w, wbar=wbar, d=d,
            u=u, Mu=Mu, v=v, Nv=Nv, alpha=alpha, beta=beta,
            c=c, s=s, zeta=zeta, tau=tau,
            rnorm=rnorm, r1norm=r1norm, xnorm=xnorm,
            arnorm=arnorm, r_nrg2=r_nrg2, x_nrg2=x_nrg2, d_err=d_err,
            istop=istop, itn=itn, done=istop > 0,
            hist=history_push(st["hist"], itn, jnp.sqrt(rnorm)),
            ip=history_push(st["ip"], itn, x),
            id=history_push(st["id"], itn, r))

    st = jax.lax.while_loop(cond, body, state0)
    istop = st["istop"]
    optimal = jnp.isin(istop, jnp.asarray(_OPTIMAL_CODES))
    x_out = jnp.where(x_is_zero, jnp.zeros(n, dtype), st["x"])
    return SolveResult(
        x=x_out, converged=optimal, istop=istop,
        n_iter=st["itn"], n_matvec=2 * st["itn"],
        resid_norm=jnp.sqrt(st["rnorm"]), resid_norm0=bnorm,
        resid_history=st["hist"],
        info={"r": jnp.where(x_is_zero, jnp.zeros(m, dtype), st["r"]),
              "r1norm": jnp.sqrt(st["r1norm"]),
              "r2norm": jnp.sqrt(st["rnorm"]),
              "Arnorm": st["arnorm"], "xnorm": st["xnorm"],
              "rNrgNorm2": st["r_nrg2"], "xNrgNorm2": st["x_nrg2"],
              "optimal": optimal,
              **({"iterates_p": st["ip"], "iterates_d": st["id"]}
                 if store_iterates else {})})


def craig(A, b, *, M=None, N=None, atol=1.0e-9, btol=1.0e-9, etol=1.0e-6,
          window=5, itnlim=None, store_history=False,
          store_iterates=False, show=False, verify_final=False):
    """Solve consistent ``Ax = b`` or the SQD system
    ``[M A; A' -N][r; x] = [b; 0]`` by the generalized CRAIG method.

    Parameters
    ----------
    A : rectangular (m x n) LinearOperator or dense array.
    b : length-m right-hand side.
    M, N : optional inner preconditioners applying inv(D) and inv(C)
        (``craig.py:115-117``).
    atol, btol : stopping tolerances (only btol is active, as in the
        reference; ``craig.py:438-457``).
    etol, window : truncated direct-error stop on the dual iterate.
    itnlim : iteration cap, default 3n (``craig.py:177``).

    Returns :class:`SolveResult`; the dual iterate ``r`` (the SQD system's
    first block) is in ``info['r']``, and ``n_matvec = 2 n_iter``.

    ``verify_final=True`` appends the SQD block-equation certificates —
    both expressible with the AVAILABLE (inverse-weight) applies:
    ``info["true_dual_resid"]`` = ||M(b - Ax) - r|| (first block) and
    ``info["true_primal_resid"]`` = ||N(A'r) - x|| (second block); two
    uncounted diagnostic matvecs.
    """
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    N = as_operator(N) if N is not None else None
    b = promote_rhs(b, A, M, N)
    if itnlim is None:
        itnlim = 3 * A.nargin
    if show:
        from .show import craig_preamble
        craig_preamble(A.nargout, A.nargin, float(atol),
                       float(btol), itnlim)
    res = _craig(A, b, M, N, float(atol), float(btol), float(etol),
                  int(itnlim), int(window), bool(store_history),
                  bool(store_iterates))
    if show:
        from .show import print_craig_final
        print_craig_final(res)
    if verify_final:
        from .common import apply_op, apply_op_T
        r = res.info["r"]
        d1 = b - apply_op(A, res.x)
        d1 = (apply_op(M, d1) if M is not None else d1) - r
        d2 = apply_op_T(A, r)
        d2 = (apply_op(N, d2) if N is not None else d2) - res.x
        res.info["true_dual_resid"] = jnp.linalg.norm(d1)
        res.info["true_primal_resid"] = jnp.linalg.norm(d2)
    return res
