"""Verified iterative refinement around any square-system solver.

The f32 parity strategy (SURVEY §7 "compensated algorithms to
match residual histories") generalized beyond CG: ``refined_solve``
wraps ANY of the square-system solvers (cg, minres, symmlq, bicgstab,
cgs, tfqmr) in an outer refinement loop —

  1. run the inner solver on the residual system ``A d = r`` to a
     modest per-leg tolerance (``leg_rtol``, comfortably inside f32's
     reliable range),
  2. accumulate ``x += d`` on a double-f32 (hi, lo) carry
     (:mod:`pykrylov_tpu.utils.ff`),
  3. recompute the TRUE residual ``b - A x`` with the compensated
     matvec when the operator storage supports one
     (:func:`~pykrylov_tpu.solvers.ffmv.resolve_ff_matvec`),
  4. stop only on the verified residual.

This is the same refinement structure ff-CG runs fused inside its
``lax.while_loop`` (``cg.py`` with ``replace_every``), hoisted to a
host-level loop so the inner solver is pluggable: MINRES/SYMMLQ legs
give verified f32 solves of symmetric indefinite systems, BiCGSTAB/
CGS/TFQMR legs the nonsymmetric ones.  The reference needs no such
machinery because it runs f64 NumPy throughout (its unverified
recurrences drift invisibly at its tolerances); in f32 an unverified
stopping test is meaningless for ill-conditioned systems — MINRES on
1138bus at rtol 1e-8 reports a residual estimate 21x below its true
residual.

Each leg is one fused device program (the inner solver's while_loop);
only one scalar rides back to the host per leg for the outer control
flow, so a solve costs ``n_legs`` host synchronisations — for a fully
fused single-program verified CG use
``cg(..., replace_every=...)`` instead.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from .common import (as_operator, apply_op, apply_op_T, promote_rhs,
                     require_square)
from .ffmv import resolve_ff_matvec
from .result import SolveResult

__all__ = ["refined_solve", "refined_solve_batched", "refined_lls", "ISTOP_MSG"]

ISTOP_MSG = {
    0: "verified residual small enough (relative/absolute tolerance "
       "reached)",
    1: "leg budget exhausted before verified convergence",
    2: "inner solver failed (breakdown or indefiniteness); see "
       "info['inner_istop']",
    3: "stagnation: verified residual stopped improving (precision "
       "floor reached)",
}


def _true_residual(ff_mv, block=False):
    """Compensated ``b - A x`` of a double-f32 iterate ``(xh, xl)``,
    rounded to the working dtype: the (hi, lo) apply when the operator
    storage supports one, plain applications otherwise (fused into one
    (n, 2K) product for blocks), combined through an error-free
    ``two_sum``.  Shared body of the square, least-squares and BLOCK
    verifiers (the compensated branch is shape-agnostic)."""
    from ..utils.ff import two_sum

    if ff_mv is not None:
        def rt_of(A, b, xh, xl):
            sh, sl = ff_mv(A._params, xh, xl)
            d, de = two_sum(b, -sh)
            return d + (de - sl)
    elif block:
        from .batched import _apply_block

        def rt_of(A, B, Xh, Xl):
            K = Xh.shape[1]
            SS = _apply_block(A, jnp.concatenate([Xh, Xl], axis=1))
            d, de = two_sum(B, -SS[:, :K])
            return d + (de - SS[:, K:])
    else:
        def rt_of(A, b, xh, xl):
            sh = apply_op(A, xh)
            sl = apply_op(A, xl)
            d, de = two_sum(b, -sh)
            return d + (de - sl)
    return rt_of


@functools.lru_cache(maxsize=None)
def _verifier(ff_mv):
    """Jitted verified-residual evaluation, memoized per compensated
    matvec so equal-storage operators share one compiled program.
    Returns (r, ||r||) with r the compensated ``b - A x`` rounded to
    the working dtype."""
    rt_of = _true_residual(ff_mv)

    @jax.jit
    def verify(A, b, xh, xl):
        rt = rt_of(A, b, xh, xl)
        return rt, jnp.linalg.norm(rt)
    return verify


@jax.jit
def _accumulate(xh, xl, d, dl=None):
    from ..utils.ff import ff_add, ff_add_ff
    if dl is None:
        return ff_add(xh, xl, d)
    return ff_add_ff(xh, xl, d, dl)


def _solver_params(solver):
    import inspect
    try:
        return inspect.signature(solver).parameters
    except (TypeError, ValueError):  # builtins / partials without sig
        return {}


def _accepts_kwarg(solver, name):
    return name in _solver_params(solver)


def _leg_cap_kwarg(solver):
    """Map a leg iteration cap onto the solver's own cap kwarg."""
    for name in ("itnlim", "maxiter", "matvec_max"):
        if name in _solver_params(solver):
            return name
    return None




def _reject_tracers(b, what):
    """The refinement drivers are HOST loops (per-leg verified pulls and
    adaptive tolerances); under jit/vmap they would die deep inside with
    an opaque concretization error — fail at the door instead."""
    import jax.core as _core
    if isinstance(b, _core.Tracer):
        raise ValueError(
            "%s is a host-side driver (per-leg verified residual pulls "
            "+ adaptive leg tolerances) and cannot run inside jit/vmap; "
            "call it outside the traced region, or use the in-loop "
            "verified solvers (cg/minres replace_every=...) which are "
            "single fused programs" % what)


def _prepare_leg_kwargs(solver, solver_kwargs, M, leg_maxiter):
    """Shared leg-kwargs preparation for both refinement drivers:
    strip verify_final (the outer loop is the certificate), forward M,
    map the leg cap onto the solver's own kwarg, and default atol=0.0
    where accepted (inheriting the solvers' absolute default would stop
    small-norm legs immediately and misreport a reachable outer target
    as a precision floor)."""
    kwargs = dict(solver_kwargs)
    kwargs.pop("verify_final", None)
    if M is not None:
        kwargs["M"] = M
    if leg_maxiter is not None:
        cap = _leg_cap_kwarg(solver)
        if cap is not None:
            kwargs.setdefault(cap, int(leg_maxiter))
    if _accepts_kwarg(solver, "atol"):
        kwargs.setdefault("atol", 0.0)
    return kwargs


def refined_solve(solver, A, b, *, rtol=1.0e-6, atol=0.0, x0=None, M=None,
                  leg_rtol=1.0e-2, max_legs=40, stall_factor=0.9,
                  leg_maxiter=None, leg_replace_every="auto",
                  show=False, logger=None, **solver_kwargs):
    """Solve ``A x = b`` to a VERIFIED tolerance by iterative refinement
    with ``solver`` as the inner correction solver.

    Parameters
    ----------
    solver : one of the square-system solver functions (``cg``,
        ``minres``, ``symmlq``, ``bicgstab``, ``cgs``, ``tfqmr``) or any
        callable ``solver(A, rhs, rtol=..., M=..., **kw) -> SolveResult``.
    A, b : operator and right-hand side.
    rtol, atol : OUTER stopping rule on the verified true residual:
        ``||b - A x|| <= max(atol, rtol * ||b - A x0||)`` in the plain
        2-norm (``M`` only accelerates the legs — same contract as
        ff-CG's ``replace_every`` path).
    x0 : optional initial iterate (verified before the first leg).
    M : preconditioner forwarded to every inner leg.
    show, logger : LIVE per-leg progress — the refinement driver is a
        HOST loop, so (unlike the fused while-loop solvers, whose
        tables render post-hoc from device buffers via
        :mod:`pykrylov_tpu.solvers.show`) it can stream a row per leg
        as it completes, the analogue of the reference's per-iteration
        ``logger.info`` lines (``/root/reference/pykrylov/cg/cg.py:
        106-111``).  ``show=True`` prints to stdout; ``logger`` (a
        ``logging.Logger``) receives the same rows at INFO level.
    leg_rtol : INITIAL per-leg tolerance; each leg solves ``A d = r``
        with this inner ``rtol``.  1e-2 is comfortably inside f32's
        reliable range; smaller values mean fewer legs but risk the
        inner recurrence drifting within a leg.  Because some solvers'
        stopping tests are scaled (MINRES's test1 divides by
        ``Anorm*ynorm``), the leg tolerance ADAPTS: legs that fail to
        shrink the verified residual below ``stall_factor`` times the
        previous one tighten the inner rtol 10x (worsening legs are
        reverted first); five consecutive no-progress legs declare the
        precision floor (istop 3).
    max_legs : outer iteration cap.
    stall_factor : minimum per-leg verified-residual reduction that
        counts as progress.
    leg_maxiter : optional per-leg iteration cap (mapped onto the
        solver's ``itnlim``/``maxiter``/``matvec_max`` kwarg).  An f32
        MINRES recurrence drifts DESTRUCTIVELY past a few hundred
        iterations (measured on 1138bus: a 300-iteration leg multiplies
        the true residual by 3.6); capping legs keeps each correction
        inside the drift-free range.
    **solver_kwargs : forwarded verbatim to every inner leg (e.g.
        ``shift=``, ``check_curvature=``; ``verify_final`` is stripped
        — the outer loop is the certificate).  Legs additionally receive
        ``atol=0.0`` when the solver accepts it (inheriting the
        solvers' absolute default would stop small-norm legs
        immediately and misreport a reachable outer target as a
        precision floor).

    Notes
    -----
    Refinement restarts lose Krylov momentum: once the verified
    residual concentrates in the operator's worst-conditioned subspace,
    a fresh leg needs the asymptotic (superlinear-delayed) iteration
    count to make progress — on 1138bus/Jacobi that is 600-1200
    iterations per 100-1000x leg.  Plain f32 MINRES legs drift
    destructively long before that (round 2's measured ~1e-4 floor);
    the default ff-MINRES legs (``leg_replace_every="auto"``) carry
    the whole recurrence as double-f32 pairs and stay drift-free
    through momentum-length legs, reaching VERIFIED rtol 1e-6 on
    kappa~1e7 systems, SPD and (realistically-)indefinite alike —
    give legs room (``leg_maxiter`` >= ~n) on such systems.  SPD
    systems can also use ``cg`` legs or fused ff-CG
    (``cg(replace_every=...)``).

    Returns
    -------
    :class:`SolveResult` — ``x`` is the double-f32 high part
    (``info["x_lo"]`` the low part), ``resid_norm`` the VERIFIED true
    residual norm, ``resid_history`` the per-leg verified norms,
    ``n_matvec`` the total inner matvecs plus one compensated (or two
    plain) applications per verification, and ``info`` carries
    ``n_legs``, ``inner_istop``, ``inner_converged`` and
    ``inner_n_iter`` telemetry.
    """
    _reject_tracers(jnp.asarray(b), "refined_solve")
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    b = promote_rhs(b, A, M)
    require_square(A, b, "refined_solve")
    n = b.shape[0]

    ff = resolve_ff_matvec(A)
    verify = _verifier(ff)
    verify_cost = 1 if ff is not None else 2

    n_matvec = 0
    if x0 is None:
        xh = jnp.zeros(n, b.dtype)
        xl = jnp.zeros(n, b.dtype)
        r = b
        resid = jnp.linalg.norm(b)
    else:
        xh = jnp.asarray(x0, b.dtype)
        xl = jnp.zeros(n, b.dtype)
        r, resid = verify(A, b, xh, xl)
        n_matvec += verify_cost
    resid0 = resid
    thresh = max(float(atol), float(rtol) * float(resid0))

    leg_resids = [float(resid)]
    inner_istops, inner_iters, inner_conv = [], [], []
    inner_nmv = []
    istop = 1
    n_iter = 0
    kwargs = _prepare_leg_kwargs(solver, solver_kwargs, M, leg_maxiter)
    if leg_replace_every is not None and \
            _accepts_kwarg(solver, "replace_every"):
        # ff MINRES legs by default: minres(replace_every=) carries its
        # whole Lanczos/Givens recurrence as double-f32 pairs and
        # verifies its own leg target WITHOUT restarting, so legs no
        # longer drift — this is what moved the verified MINRES floor
        # on 1138bus/Jacobi from ~1e-4 to 1e-6 (measured; the leg's
        # x_lo is folded into the accumulator).  "auto" deliberately
        # skips cg: ff-CG's replace_every RESTARTS its direction at
        # each in-loop verification, which inside a refinement leg
        # burns the leg's iteration budget on redundant restarts
        # (measured: refined ff-CG legs stall at 5e-4 on 1138bus where
        # plain legs converge — the OUTER loop already verifies).
        if leg_replace_every == "auto":
            leg_replace_every = \
                50 if getattr(solver, "__name__", "") == "minres" else None
        if leg_replace_every is not None:
            kwargs.setdefault("replace_every", int(leg_replace_every))

    # Solvers with SCALED stopping tests (MINRES's test1 divides by
    # Anorm*ynorm) satisfy a fixed leg_rtol long before reducing the
    # actual leg residual by that factor, so the leg tolerance adapts:
    # whenever a leg fails to shrink the verified residual below
    # ``stall_factor`` times the previous one, the inner rtol tightens
    # 10x and a WORSENING leg is reverted; after ``_MAX_TIGHTENS``
    # consecutive no-progress legs the compensated evaluation's floor is
    # declared (istop 3).
    def _emit(line):
        if show:
            print(line)
        if logger is not None:
            logger.info(line)

    if show or logger is not None:
        _emit("%4s  %10s  %6s  %6s  %12s  %9s"
              % ("leg", "leg rtol", "iters", "istop", "verified resid",
                 "ratio"))
        _emit("%4d  %10s  %6s  %6s  %12.5e  %9s"
              % (0, "-", "-", "-", float(resid), "-"))

    _MAX_TIGHTENS = 4
    inner_rtol = float(leg_rtol)
    tightens = 0
    for _ in range(int(max_legs)):
        if float(resid) <= thresh:
            istop = 0
            break
        res = solver(A, r, rtol=inner_rtol, **kwargs)
        n_matvec += int(res.n_matvec)
        n_iter += int(res.n_iter)
        inner_istops.append(int(res.istop))
        inner_iters.append(int(res.n_iter))
        inner_nmv.append(int(res.n_matvec))
        inner_conv.append(bool(res.converged))
        xh2, xl2 = _accumulate(xh, xl, res.x,
                               (res.info or {}).get("x_lo"))
        r2, new_resid = verify(A, b, xh2, xl2)
        n_matvec += verify_cost
        leg_resids.append(float(new_resid))
        if show or logger is not None:
            _emit("%4d  %10.1e  %6d  %6d  %12.5e  %9.3e"
                  % (len(inner_istops), inner_rtol, int(res.n_iter),
                     int(res.istop), float(new_resid),
                     float(new_resid) / max(float(resid), 1e-300)))
        bad = not bool(jnp.isfinite(new_resid))
        if bad or float(new_resid) >= float(resid):
            # worsening (or non-finite) correction: revert to the last
            # verified iterate before retrying tighter
            if bad and not bool(res.converged):
                istop = 2   # inner breakdown produced garbage
                break
            tightens += 1
            inner_rtol *= 0.1
        elif float(new_resid) > stall_factor * float(resid):
            # progress, but too slow: keep it and tighten the legs
            xh, xl, r, resid = xh2, xl2, r2, new_resid
            tightens += 1
            inner_rtol *= 0.1
        else:
            xh, xl, r, resid = xh2, xl2, r2, new_resid
            tightens = 0
        if tightens > _MAX_TIGHTENS:
            istop = 3
            break
    if float(resid) <= thresh:
        istop = 0

    info = {
        "x_lo": xl,
        "n_legs": len(inner_istops),
        "inner_istop": jnp.asarray(inner_istops or [0], jnp.int32),
        "inner_n_iter": jnp.asarray(inner_iters or [0], jnp.int32),
        "inner_n_matvec": jnp.asarray(inner_nmv or [0], jnp.int32),
        "inner_converged": jnp.asarray(inner_conv or [False]),
        "true_resid_norm": resid,
    }
    return SolveResult(
        x=xh, converged=jnp.asarray(istop == 0),
        istop=jnp.asarray(istop, jnp.int32),
        n_iter=jnp.asarray(n_iter, jnp.int32),
        n_matvec=jnp.asarray(n_matvec, jnp.int32),
        resid_norm=resid, resid_norm0=resid0,
        resid_history=jnp.asarray(leg_resids, jnp.result_type(resid)),
        info=info)


@functools.lru_cache(maxsize=None)
def _lls_verifier(ff_mv):
    """Jitted verified least-squares metrics, memoized per compensated
    matvec.  Returns ``(rt, ||rt||, ||A' rt||)``: the true residual
    ``b - A x`` from the double-f32 iterate (compensated forward matvec
    when the storage supports one) and the Euclidean optimality
    residual — the quantity LSQR/LSMR's recursive ``normar`` estimates
    and an f32 recurrence misreports (the estimate keeps shrinking
    while the true optimality residual stalls orders higher)."""
    rt_of = _true_residual(ff_mv)

    @jax.jit
    def verify(A, b, xh, xl):
        rt = rt_of(A, b, xh, xl)
        return rt, jnp.linalg.norm(rt), \
            jnp.linalg.norm(apply_op_T(A, rt))
    return verify


def refined_lls(solver, A, b, *, atol=1.0e-5, btol=1.0e-6, x0=None,
                leg_tol=1.0e-3, max_legs=20, stall_factor=0.9,
                leg_maxiter=None, show=False, logger=None,
                **solver_kwargs):
    """Solve ``min ||A x - b||`` to a VERIFIED optimality tolerance by
    iterative refinement with ``solver`` (``lsqr`` or ``lsmr``) as the
    inner correction solver.

    The least-squares analogue of :func:`refined_solve`: because the
    outer iterate keeps ``r = b - A x`` exact (double-f32 x carry +
    compensated residual evaluation), the augmented-system refinement
    of Björck (1967) reduces to plain corrections — each leg solves
    ``min ||A d - r||`` (whose exact solution is exactly the error
    ``x* - x`` for full-column-rank A), accumulated on the (hi, lo)
    carry.  Stopping runs on the TRUE Euclidean optimality residual
    ``||A' (b - A x)||``, not the legs' recursive estimates.

    Parameters
    ----------
    solver : ``lsqr`` or ``lsmr`` (any callable
        ``solver(A, rhs, atol=..., btol=...) -> SolveResult`` whose
        stopping follows the LSQR conventions).
    atol : outer optimality stop — converged when
        ``||A' rt|| <= atol * ||A|| * ||rt||`` (LSQR's test2, evaluated
        on the verified residual; ``||A||`` is the max of the legs'
        running Frobenius-ish estimates and the verified lower bounds
        ``||A'rt||/||rt||``, so the test stays armed even for leg
        solvers exposing no norm estimate).  The verification itself
        evaluates
        ``A' rt`` with one plain (working-precision) transpose product,
        so certificates much below ``sqrt(n)*eps`` are not resolvable
        — in f32 keep ``atol >= ~1e-6``.
    btol : consistent-system stop — converged when
        ``||rt|| <= btol * ||b||`` (LSQR's test1 with the xnorm term
        dropped).
    x0 : optional initial iterate (verified before the first leg).
    leg_tol : initial per-leg ``atol``/``btol``; adapts exactly like
        :func:`refined_solve`'s ``leg_rtol`` (tighten 10x on stall,
        revert worsening legs, five consecutive no-progress legs
        declare the precision floor → istop 3).
    max_legs, stall_factor, leg_maxiter : as in :func:`refined_solve`
        (stall is measured on the optimality norm — for inconsistent
        systems ``||rt||`` floors at the incompatible component and
        carries no progress signal).
    **solver_kwargs : forwarded to every leg (``verify_final`` is
        stripped — the outer loop is the certificate).  ``damp``, ``M``
        and ``N`` are REJECTED: a damped/preconditioned correction leg
        solves a different correction equation than the outer verified
        metric (the damped correction needs
        ``(A'A + damp^2 I) d = A'r - damp^2 x``, which LSQR's damped
        mode cannot express for nonzero x) — for damped refinement,
        refine the explicitly augmented operator ``[A; damp I]``
        instead; use ``verify_final=True`` on a direct solve for the
        one-shot certificate.

    Notes
    -----
    What refinement buys (measured, f32 storage, 600x200 dense,
    singular values 1..10^k): at cond 10^3 a single f32 LSQR run floors
    at true test2 ~ 7e-2 (its internal estimates report convergence);
    refinement reaches ~3e-4 — a 200x better certificate.  The error
    DISTRIBUTION differs from a long single run's: refinement drives
    the optimality residual, which weights the error by A'A, so the
    remaining error concentrates in the small-singular-value subspace;
    a long single Krylov run may reach smaller ``||x - x*||`` while
    certifying a far worse optimality residual.  Refinement certifies
    optimality — the quantity LS users can actually check.

    Returns
    -------
    :class:`SolveResult` — ``resid_norm`` is the verified
    ``||b - A x||``; ``info["true_normar"]`` the verified optimality
    norm, ``info["normar_history"]`` its per-leg trajectory,
    ``info["anorm"]`` the norm estimate used in the stopping test, plus
    the :func:`refined_solve` telemetry (``x_lo``, ``n_legs``,
    ``inner_*``).
    """
    damp = solver_kwargs.pop("damp", None)
    rejected = [name for name, val
                in (("damp", damp), ("M", solver_kwargs.pop("M", None)),
                    ("N", solver_kwargs.pop("N", None)))
                if val is not None and not (name == "damp" and not val)]
    if rejected:
        raise ValueError(
            "refined_lls does not support %r legs (the correction "
            "equation differs from the outer verified metric); "
            "refine the augmented operator instead, or use "
            "verify_final=True on a direct solve" % rejected[0])
    # the outer loop IS the certificate — per-leg certificates would be
    # discarded at 2 extra matvecs per leg
    solver_kwargs.pop("verify_final", None)
    _reject_tracers(jnp.asarray(b), "refined_lls")
    A = as_operator(A)
    b = promote_rhs(b, A, None)
    m, n = A.shape
    if jnp.ndim(b) != 1 or jnp.shape(b)[0] != m:
        raise ValueError("refined_lls: rhs has shape %s, expected (%d,)"
                         % (jnp.shape(b), m))

    ff = resolve_ff_matvec(A)
    verify = _lls_verifier(ff)
    # one forward application (two when uncompensated) + one transpose
    verify_cost = (1 if ff is not None else 2) + 1

    bnorm = float(jnp.linalg.norm(b))
    n_matvec = 0
    if x0 is None:
        xh = jnp.zeros(n, b.dtype)
        xl = jnp.zeros(n, b.dtype)
        r = b
        resid = jnp.linalg.norm(b)
        normar = jnp.linalg.norm(apply_op_T(A, b))
        n_matvec += 1   # b - A*0 is known; only A'b is computed
    else:
        xh = jnp.asarray(x0, b.dtype)
        xl = jnp.zeros(n, b.dtype)
        r, resid, normar = verify(A, b, xh, xl)
        n_matvec += verify_cost
    resid0 = resid

    normar_hist = [float(normar)]
    leg_resids = [float(resid)]
    inner_istops, inner_iters, inner_conv = [], [], []
    istop = 1
    n_iter = 0
    # running ||A|| estimate for the optimality test: the max of the
    # legs' Frobenius-ish estimates and the verified LOWER bounds
    # ||A'rt|| / ||rt|| (valid since ||A'rt|| <= ||A||*||rt||); the
    # bound keeps the atol stop armed even for leg solvers that expose
    # no Anorm, and a lower bound only makes the test stricter
    anorm = 0.0

    def absorb_anorm(est):
        nonlocal anorm
        est = float(est)
        if math.isfinite(est) and est > anorm:
            anorm = est

    def stopped():
        if float(resid) <= float(btol) * bnorm or float(normar) == 0.0:
            return True
        return anorm > 0 and float(normar) <= (
            float(atol) * anorm * max(float(resid), 1e-300))

    if float(resid) > 0:
        absorb_anorm(float(normar) / float(resid))
    kwargs = dict(solver_kwargs)
    if leg_maxiter is not None:
        cap = _leg_cap_kwarg(solver)
        if cap is not None:
            kwargs.setdefault(cap, int(leg_maxiter))
    if _accepts_kwarg(solver, "etol"):
        # legs are optimality-driven: the energy-norm direct-error stop
        # would end legs early on an unrelated criterion
        kwargs.setdefault("etol", 0.0)

    def _emit(line):
        if show:
            print(line)
        if logger is not None:
            logger.info(line)

    if show or logger is not None:
        # live per-leg rows (host-loop driver; see refined_solve)
        _emit("%4s  %10s  %6s  %6s  %12s  %12s"
              % ("leg", "leg tol", "iters", "istop", "||r||",
                 "||A'r||"))
        _emit("%4d  %10s  %6s  %6s  %12.5e  %12.5e"
              % (0, "-", "-", "-", float(resid), float(normar)))

    _MAX_TIGHTENS = 4
    tighten_mult = 1.0
    tightens = 0
    for _ in range(int(max_legs)):
        if stopped():
            istop = 0
            break
        # A leg stopping at its own test2 <= tol leaves the verified
        # optimality residual at ~tol*||A||*||rt|| — it CANNOT land
        # below the outer target unless its tolerance is tied to that
        # target, so once ||A|| is known legs aim 4x inside ``atol``
        # (with the stall multiplier tightening further on top).
        base = float(leg_tol)
        if anorm > 0 and float(atol) > 0:
            base = min(base, 0.25 * float(atol))
        inner_tol = base * tighten_mult
        res = solver(A, r, atol=inner_tol, btol=inner_tol, **kwargs)
        n_matvec += int(res.n_matvec)
        n_iter += int(res.n_iter)
        inner_istops.append(int(res.istop))
        inner_iters.append(int(res.n_iter))
        inner_conv.append(bool(res.converged))
        leg_anorm = res.info.get("Anorm", res.info.get("normA"))
        if leg_anorm is not None:
            # a diverged leg's estimate (inf/garbage) must not loosen
            # the certificate threshold — absorb finite values only
            absorb_anorm(leg_anorm)
        xh2, xl2 = _accumulate(xh, xl, res.x)
        r2, new_resid, new_normar = verify(A, b, xh2, xl2)
        n_matvec += verify_cost
        leg_resids.append(float(new_resid))
        normar_hist.append(float(new_normar))
        if show or logger is not None:
            _emit("%4d  %10.1e  %6d  %6d  %12.5e  %12.5e"
                  % (len(inner_istops), inner_tol, int(res.n_iter),
                     int(res.istop), float(new_resid),
                     float(new_normar)))
        if bool(jnp.isfinite(new_normar)) and float(new_resid) > 0:
            absorb_anorm(float(new_normar) / float(new_resid))
        bad = not bool(jnp.isfinite(new_normar))
        if bad or float(new_normar) >= float(normar):
            if bad and not bool(res.converged):
                istop = 2
                break
            tightens += 1
            tighten_mult *= 0.1
        elif float(new_normar) > stall_factor * float(normar):
            xh, xl, r, resid, normar = xh2, xl2, r2, new_resid, new_normar
            tightens += 1
            tighten_mult *= 0.1
        else:
            xh, xl, r, resid, normar = xh2, xl2, r2, new_resid, new_normar
            tightens = 0
        if tightens > _MAX_TIGHTENS:
            istop = 3
            break
    if stopped():
        istop = 0

    info = {
        "x_lo": xl,
        "n_legs": len(inner_istops),
        "inner_istop": jnp.asarray(inner_istops or [0], jnp.int32),
        "inner_n_iter": jnp.asarray(inner_iters or [0], jnp.int32),
        "inner_converged": jnp.asarray(inner_conv or [False]),
        "true_resid_norm": resid,
        "true_normar": normar,
        "normar_history": jnp.asarray(normar_hist,
                                      jnp.result_type(normar)),
        "anorm": jnp.asarray(anorm, jnp.result_type(normar)),
    }
    return SolveResult(
        x=xh, converged=jnp.asarray(istop == 0),
        istop=jnp.asarray(istop, jnp.int32),
        n_iter=jnp.asarray(n_iter, jnp.int32),
        n_matvec=jnp.asarray(n_matvec, jnp.int32),
        resid_norm=resid, resid_norm0=resid0,
        resid_history=jnp.asarray(leg_resids, jnp.result_type(resid)),
        info=info)


# ---------------------------------------------------------------------------
# Block (multi-RHS) refinement driver (round 4)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _verifier_block(ff_mm):
    """Jitted per-column verified-residual evaluation on (n, K) blocks,
    memoized per compensated block product.  Returns ``(R, ||R||_cols)``
    with R the compensated ``B - A X``."""
    rt_of = _true_residual(ff_mm, block=True)

    @jax.jit
    def verify(A, B, Xh, Xl):
        rt = rt_of(A, B, Xh, Xl)
        return rt, jnp.linalg.norm(rt, axis=0)
    return verify


def refined_solve_batched(solver, A, B, *, rtol=1.0e-6, atol=0.0,
                          x0=None, M=None, leg_rtol=1.0e-2, max_legs=40,
                          stall_factor=0.9, leg_maxiter=None,
                          **solver_kwargs):
    """Block counterpart of :func:`refined_solve`: verified iterative
    refinement where every leg is ONE fused multi-RHS solve.

    ``solver`` is a *batched* square-system solver
    (``bicgstab_batched``, ``cgs_batched``, ``tfqmr_batched``,
    ``cg_batched``, ``minres_batched``) with the
    ``solver(A, B, rtol=..., **kw) -> SolveResult`` block contract;
    this is the verified path for GENERAL (nonsymmetric) rhs blocks,
    which have no in-loop ff machinery (symmetric blocks prefer
    ``cg_batched``/``minres_batched`` with ``replace_every`` — in-loop
    verification keeps Krylov momentum).

    Per-column semantics mirror the single-RHS driver: each column has
    its own verified threshold ``max(atol, rtol * ||b_k||)``, its own
    progress/stall accounting and istop (0 converged / 1 legs
    exhausted / 2 inner breakdown / 3 precision floor); converged and
    frozen columns ride zero leg right-hand sides (the batched freeze
    masks stop them at leg iteration 0).  One DELIBERATE deviation:
    the adaptive leg tolerance is shared across columns (batched
    solvers take one ``rtol``), tightened when ANY active column fails
    its ``stall_factor`` reduction — per-column floors still trip
    individually via their own no-progress streaks.

    Returns :class:`SolveResult` with per-column fields; ``x`` (n, K)
    is the double-f32 high part (``info["x_lo"]`` the low part),
    ``resid_norm`` the per-column VERIFIED true residuals,
    ``resid_history`` the (legs+1, K) per-leg verified norms.
    """
    import numpy as _np

    from .ffmv import resolve_ff_matmat

    _reject_tracers(jnp.asarray(B), "refined_solve_batched")
    A = as_operator(A)
    M = as_operator(M) if M is not None else None
    B = jnp.asarray(B)
    if B.ndim == 1:
        B = B[:, None]
    if B.ndim != 2 or B.shape[0] != A.shape[1] \
            or A.shape[0] != A.shape[1]:
        from ..ops.base import ShapeError
        raise ShapeError("refined_solve_batched: operator %r with rhs "
                         "block %s" % (A, B.shape))
    B = promote_rhs(B, A, M)
    n, K = B.shape

    ff = resolve_ff_matmat(A)
    verify = _verifier_block(ff)
    verify_cost = 1 if ff is not None else 2

    n_matvec0 = 0
    if x0 is None:
        Xh = jnp.zeros((n, K), B.dtype)
        Xl = jnp.zeros((n, K), B.dtype)
        R = B
        Rnorm = jnp.linalg.norm(B, axis=0)
    else:
        # the initial iterate is the OUTER accumulator, verified before
        # the first leg — forwarding it as every leg's inner guess
        # would make leg 2+'s rtol stop relative to ||R - A x0||
        # instead of the correction system (round-4 review finding)
        Xh = jnp.asarray(x0, B.dtype)
        if Xh.ndim == 1:
            Xh = jnp.broadcast_to(Xh[:, None], (n, K))
        Xl = jnp.zeros((n, K), B.dtype)
        R, Rnorm = verify(A, B, Xh, Xl)
        n_matvec0 = verify_cost
    resid = _np.asarray(Rnorm, _np.float64)
    resid0 = resid.copy()
    thresh = _np.maximum(float(atol), float(rtol) * resid0)

    active = resid > thresh
    istop = _np.where(active, 1, 0).astype(_np.int32)
    tightens = _np.zeros(K, _np.int32)
    leg_resids = [resid.copy()]
    inner_istops, inner_conv = [], []
    n_matvec = n_matvec0
    n_iter = 0

    kwargs = _prepare_leg_kwargs(solver, solver_kwargs, M, leg_maxiter)

    _MAX_TIGHTENS = 4
    inner_rtol = float(leg_rtol)
    for _ in range(int(max_legs)):
        if not active.any():
            break
        Ract = jnp.where(jnp.asarray(active)[None, :], R,
                         jnp.zeros_like(R))
        res = solver(A, Ract, rtol=inner_rtol, **kwargs)
        n_matvec += int(res.n_matvec)
        n_iter += int(res.n_iter)
        inner_istops.append(_np.asarray(res.istop, _np.int32))
        inner_conv.append(_np.asarray(res.converged))
        Dl = (res.info or {}).get("x_lo")
        Xh2, Xl2 = _accumulate(Xh, Xl, res.x, Dl)
        R2, new_norm = verify(A, B, Xh2, Xl2)
        n_matvec += verify_cost
        nr = _np.asarray(new_norm, _np.float64)
        leg_resids.append(_np.where(active, nr, resid))
        finite = _np.isfinite(nr)
        improved = active & finite & (nr < resid)
        good = improved & (nr <= stall_factor * resid)
        keep = jnp.asarray(improved)[None, :]
        Xh = jnp.where(keep, Xh2, Xh)
        Xl = jnp.where(keep, Xl2, Xl)
        R = jnp.where(keep, R2, R)
        resid = _np.where(improved, nr, resid)
        # inner breakdown that produced garbage: freeze with istop 2
        broke = active & ~finite & ~_np.asarray(res.converged)
        istop[broke] = 2
        active &= ~broke
        # convergence FIRST: a slow leg that nevertheless crosses the
        # threshold is converged, not a floor (the single driver's
        # unconditional post-loop promotion has the same effect)
        done_cols = active & (resid <= thresh)
        istop[done_cols] = 0
        active &= ~done_cols
        # stall accounting per column; shared leg-tolerance adaptation
        not_good = active & ~good
        tightens = _np.where(good, 0,
                             _np.where(active, tightens + 1, tightens))
        floor = active & (tightens > _MAX_TIGHTENS)
        istop[floor] = 3
        active &= ~floor
        if not_good.any():
            inner_rtol *= 0.1
    done_cols = resid <= thresh
    istop[done_cols] = 0

    info = {
        "x_lo": Xl,
        "n_legs": len(inner_istops),
        "inner_istop": jnp.asarray(
            _np.stack(inner_istops) if inner_istops
            else _np.zeros((1, K), _np.int32)),
        "inner_converged": jnp.asarray(
            _np.stack(inner_conv) if inner_conv
            else _np.zeros((1, K), bool)),
        "true_resid_norm": jnp.asarray(resid, B.dtype),
    }
    return SolveResult(
        x=Xh, converged=jnp.asarray(istop == 0),
        istop=jnp.asarray(istop),
        n_iter=jnp.asarray(n_iter, jnp.int32),
        n_matvec=jnp.asarray(n_matvec, jnp.int32),
        resid_norm=jnp.asarray(resid, B.dtype),
        resid_norm0=jnp.asarray(resid0, B.dtype),
        resid_history=jnp.asarray(_np.stack(leg_resids), B.dtype),
        info=info)
