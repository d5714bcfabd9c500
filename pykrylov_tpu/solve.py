"""Top-level ``solve`` front door with automatic method selection.

The reference makes users pick a solver class; this convenience picks a
sensible method from the operator's shape and declared symmetry (something
scipy users expect from ``spsolve``-style entry points):

  * rectangular (m != n)            → LSMR (monotone ‖Aᵀr‖, safe stops)
  * square + symmetric/hermitian    → CG, falling back to MINRES when CG's
    curvature check detects an indefinite operator
  * square, general                 → Bi-CGSTAB, falling back to TFQMR if
    the recurrence breaks down

Explicit ``method=`` accepts any solver name exported by
:mod:`pykrylov_tpu.solvers`.

Traceability contract: outside ``jit`` the automatic fallbacks (CG→MINRES,
BiCGSTAB→TFQMR) dispatch on the *concrete* stop code (one host
synchronization).  Inside ``jit``/``vmap`` the stop code is a tracer, so
the fallback is FUSED instead: the second solver runs under a
``lax.cond`` selected by the first solver's stop code, inside the same
compiled program — a traced ``solve`` on an indefinite operator returns
the converged MINRES-path result, never a silently degraded CG abort.
Both branches of a ``lax.cond`` must return one pytree structure, so the
traced path returns a *stripped* result: ``resid_history=None`` and
``info={"fallback_used": <bool>}`` (``istop`` then belongs to the solver
named by ``fallback_used``); ``store_history``/``store_iterates``/
``verify_final`` raise under tracing — call a concrete solver directly
when those are needed.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from . import solvers as _S
from .solvers.common import as_operator, apply_op

__all__ = ["solve"]

_METHODS = ("cg", "cg_pipelined", "minres", "symmlq", "bicgstab", "cgs",
            "tfqmr", "lsqr", "lsmr", "craig", "craigmr")


def _concrete_istop(res):
    """The stop code as a host int, or None when it is a tracer (inside
    jit/vmap, where fallback dispatch is impossible)."""
    try:
        return int(res.istop)
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError, TypeError):
        return None


def solve(A, b, method=None, verified=False, **opts):
    """Solve ``A x = b`` (or ``min ‖Ax-b‖`` for rectangular A).

    Returns a :class:`~pykrylov_tpu.solvers.SolveResult`.  ``opts`` pass
    through to the chosen solver.

    ``verified=True`` wraps the chosen square-system method in
    :func:`~pykrylov_tpu.solvers.refine.refined_solve`: the stopping
    test runs on the TRUE residual (compensated double-f32 evaluation),
    the f32-on-chip answer to the reference's f64 tolerances.
    Rectangular problems (and explicit ``method="lsqr"/"lsmr"``) route
    through :func:`~pykrylov_tpu.solvers.refine.refined_lls`, which
    stops on the verified Euclidean optimality residual
    ``||A'(b - A x)||``; CRAIG/CRAIG-MR solve the SQD system, for which
    no refinement wrapper exists — they get the post-solve certificate
    via ``verify_final=True``.

    A 2-D ``b`` of shape (n, K) dispatches to the fused multi-RHS
    family (``cg_batched`` for symmetric square, ``bicgstab_batched``
    for general square, ``lsqr_batched`` for rectangular; explicit
    ``method=`` picks its ``*_batched`` twin — EVERY method has one:
    cg, cg_pipelined, bicgstab, cgs, tfqmr, minres, symmlq, lsqr,
    lsmr, craig and craigmr (round 5 closed the last gap) — the
    sparse operators' SpMM kernels then stream A once per iteration
    for all K systems.
    ``verified=True`` with a block covers every square class:
    symmetric systems ride ``cg_batched(replace_every=...)`` (per-
    column double-f32 carries, per-column verified stops on recomputed
    true residuals), ``method="minres"`` the indefinite-capable
    verified ff-MINRES block path, and GENERAL square systems
    (method=None/'bicgstab'/'cgs'/'tfqmr') the block iterative-
    refinement driver :func:`~pykrylov_tpu.solvers.
    refined_solve_batched` (fused batched legs, per-column verified
    thresholds); remaining methods/shapes raise (solve columns
    individually).
    """
    A = as_operator(A)
    b_arr = jnp.asarray(b)
    if b_arr.ndim == 2:
        return _solve_block(A, b_arr, method, verified, opts)
    if method is not None:
        if method not in _METHODS:
            raise ValueError("unknown method %r (have %s)"
                             % (method, ", ".join(_METHODS)))
        fn = getattr(_S, method)
        if verified:
            if method in ("lsqr", "lsmr"):
                return _S.refined_lls(fn, A, b, **opts)
            if method in ("craig", "craigmr"):
                raise ValueError(
                    "verified=True is unsupported for the SQD solvers; "
                    "use verify_final=True for the post-solve "
                    "certificate")
            return _S.refined_solve(fn, A, b, **opts)
        return fn(A, b, **opts)

    m, n = A.shape
    if m != n:
        if verified:
            return _S.refined_lls(_S.lsmr, A, b, **opts)
        return _S.lsmr(A, b, **opts)
    if verified:
        if A.symmetric or A.hermitian:
            # CG legs (their double-f32 in-loop carries survive long
            # legs), with the same indefinite safety net as the
            # unverified path: a curvature abort in any leg reroutes to
            # refined MINRES legs
            copts = dict(opts)
            copts.setdefault("check_curvature", True)
            res = _S.refined_solve(_S.cg, A, b, **copts)
            inner = res.info.get("inner_istop")
            if (not bool(res.converged) and inner is not None
                    and bool(jnp.any(inner == 2))):
                import inspect
                ok = (set(inspect.signature(_S.minres).parameters)
                      | set(inspect.signature(
                          _S.refined_solve).parameters))
                mopts = {k: v for k, v in opts.items() if k in ok}
                return _S.refined_solve(_S.minres, A, b, **mopts)
            return res
        return _S.refined_solve(_S.bicgstab, A, b, **opts)

    if A.symmetric or A.hermitian:
        res = _S.cg(A, b, check_curvature=True, **opts)
        code = _concrete_istop(res)
        if code == 2:  # indefinite → MINRES handles it
            return _minres_fallback(A, b, res, opts)
        if code is None:  # tracer: fused lax.cond fallback
            return _fused_sym_fallback(A, b, res, opts)
        return res

    res = _S.bicgstab(A, b, **opts)
    code = _concrete_istop(res)
    if code == 3:  # breakdown → different recurrence
        # BiCGSTAB and TFQMR share their whole keyword surface, so every
        # option (x0, rtol, atol, matvec_max, store_history, M) carries over.
        return _S.tfqmr(A, b, **opts)
    if code is None:
        return _fused_gen_fallback(A, b, res, opts)
    return res


_BATCHED = {"cg": "cg_batched",
            "cg_pipelined": "cg_pipelined_batched",
            "bicgstab": "bicgstab_batched",
            "cgs": "cgs_batched", "tfqmr": "tfqmr_batched",
            "minres": "minres_batched", "symmlq": "symmlq_batched",
            "lsqr": "lsqr_batched", "lsmr": "lsmr_batched",
            "craig": "craig_batched", "craigmr": "craigmr_batched"}


def _solve_block(A, B, method, verified, opts):
    """Multi-RHS dispatch: the fused batched family when the method has
    one, the generic per-column driver otherwise."""
    if verified:
        # Verified blocks ride cg_batched's residual-replacement mode:
        # per-column double-f32 carries, per-column stops on recomputed
        # TRUE residuals.  Only the CG recurrence has a
        # verified block twin so far.
        sym = A.symmetric or A.hermitian
        if (method in (None, "cg")) and sym and A.shape[0] == A.shape[1]:
            copts = dict(opts)
            copts.setdefault("replace_every", 50)
            if not copts["replace_every"]:
                raise ValueError(
                    "verified=True requires replace_every >= 1 (0/None "
                    "would silently run the unverified batched solver)")
            # same indefinite safety net as the 1-D verified path: an
            # indefinite operator must fail loud per column (istop 2,
            # definite=False), not grind to maxiter claiming progress
            copts.setdefault("check_curvature", True)
            return _S.cg_batched(A, B, **copts)
        if ((method in ("bicgstab", "cgs", "tfqmr")
             or (method is None and not sym))
                and A.shape[0] == A.shape[1]):
            # GENERAL square verified blocks: per-column iterative
            # refinement with ONE fused batched leg solver per leg
            leg = {None: "bicgstab_batched",
                   "bicgstab": "bicgstab_batched",
                   "cgs": "cgs_batched",
                   "tfqmr": "tfqmr_batched"}[method]
            return _S.refined_solve_batched(getattr(_S, leg), A, B,
                                            **opts)
        if method == "minres" and sym and A.shape[0] == A.shape[1]:
            # indefinite-capable verified blocks: restart-free
            # double-f32 ff-MINRES per column
            mopts = dict(opts)
            mopts.setdefault("replace_every", 50)
            if not mopts["replace_every"]:
                raise ValueError(
                    "verified=True requires replace_every >= 1 (0/None "
                    "would silently run the unverified batched solver)")
            mopts.setdefault("rtol", 1e-6)
            return _S.minres_batched(A, B, **mopts)
        raise ValueError(
            "verified=True for (n, K) right-hand-side blocks is "
            "supported for square systems: symmetric via the batched "
            "CG path (method=None or 'cg') or the ff-MINRES path "
            "(method='minres', indefinite-capable), general via "
            "block iterative refinement (method=None/'bicgstab'/"
            "'cgs'/'tfqmr'); solve rectangular blocks column by "
            "column for verified stops")
    if method is not None:
        if method not in _METHODS:
            raise ValueError("unknown method %r (have %s)"
                             % (method, ", ".join(_METHODS)))
        if method in _BATCHED:
            return getattr(_S, _BATCHED[method])(A, B, **opts)
        # per-column driver, restacked into one block-shaped result so
        # the front door's contract is uniform (per-column results ride
        # in info["columns"])
        cols = _S.solve_columns(getattr(_S, method), A, B, **opts)
        return _S.SolveResult(
            x=jnp.stack([r.x for r in cols], axis=1),
            converged=jnp.stack([r.converged for r in cols]),
            istop=jnp.stack([r.istop for r in cols]),
            n_iter=max(int(r.n_iter) for r in cols),
            n_matvec=max(int(r.n_matvec) for r in cols),
            resid_norm=jnp.stack([r.resid_norm for r in cols]),
            resid_norm0=jnp.stack([r.resid_norm0 for r in cols]),
            resid_history=None, info={"columns": cols})
    m, n = A.shape
    if m != n:
        return _S.lsqr_batched(A, B, **opts)
    if A.symmetric or A.hermitian:
        return _S.cg_batched(A, B, **opts)
    return _S.bicgstab_batched(A, B, **opts)


_UNTRACEABLE_OPTS = ("store_history", "store_iterates", "store_resids",
                     "verify_final", "show")


def _strip_result(res, fallback_used, rdtype):
    """Coerce a SolveResult onto the one pytree structure both branches
    of the fused-fallback ``lax.cond`` must share."""
    return _S.SolveResult(
        x=res.x,
        converged=jnp.asarray(res.converged, jnp.bool_),
        istop=jnp.asarray(res.istop, jnp.int32),
        n_iter=jnp.asarray(res.n_iter, jnp.int32),
        n_matvec=jnp.asarray(res.n_matvec, jnp.int32),
        resid_norm=jnp.asarray(res.resid_norm, rdtype),
        resid_norm0=jnp.asarray(res.resid_norm0, rdtype),
        resid_history=None,
        info={"fallback_used": jnp.asarray(fallback_used, jnp.bool_)})


def _check_traceable_opts(opts, what):
    bad = [k for k in _UNTRACEABLE_OPTS if opts.get(k)]
    if bad:
        raise ValueError(
            "solve() under jit/vmap fuses the %s fallback with lax.cond, "
            "which cannot carry %s across branches; call a concrete "
            "solver (pykrylov_tpu.solvers.*) directly, or pass method=."
            % (what, "/".join(bad)))


def _fused_sym_fallback(A, b, cg_res, opts):
    """Traced counterpart of :func:`_minres_fallback`: MINRES runs under
    ``lax.cond(istop == 2)`` inside the caller's program, so a jit'd
    ``solve`` on an indefinite operator still returns the MINRES-path
    result.  Costs one extra compiled while_loop in the program; pass
    ``method="cg"`` to skip it when the operator is known definite."""
    _check_traceable_opts(opts, "CG→MINRES")
    from .solvers.common import promote_rhs
    from .solvers.minres import _minres
    M0 = opts.get("M")
    # the public minres() wrapper promotes the rhs against A/M; calling
    # _minres directly must do the same, or a mixed-dtype traced solve
    # leaves the two lax.cond branches with different result dtypes
    b = promote_rhs(b, A, as_operator(M0) if M0 is not None else None)
    rdtype = jnp.zeros((), b.dtype).real.dtype
    n = b.shape[0]
    itnlim = int(opts.get("maxiter") or opts.get("matvec_max") or 5 * n)
    M = opts.get("M")
    M = as_operator(M) if M is not None else None
    rtol = jnp.asarray(opts.get("rtol", 1e-12), rdtype)
    atol = opts.get("atol")
    if atol is not None:
        # fold CG's absolute tolerance into MINRES's relative one via the
        # measured initial residual (traced arithmetic — no host pull)
        resid0 = jnp.asarray(cg_res.resid_norm0, rdtype)
        rtol = jnp.maximum(rtol, jnp.asarray(atol, rdtype)
                           / jnp.maximum(resid0, jnp.finfo(rdtype).tiny))
    etol = jnp.asarray(opts.get("etol", 1e-6), rdtype)
    window = int(opts.get("window", 5))
    x0 = opts.get("x0")
    x0 = jnp.asarray(x0, b.dtype) if x0 is not None else None

    def run_minres(_):
        rhs = b if x0 is None else b - apply_op(A, x0)
        mr = _minres(A, rhs, M, jnp.zeros((), rdtype), rtol, etol,
                     itnlim, window, False, False)
        if x0 is not None:
            mr = dataclasses.replace(mr, x=mr.x + x0,
                                     n_matvec=mr.n_matvec + 1)
        return _strip_result(mr, True, rdtype)

    def keep_cg(_):
        return _strip_result(cg_res, False, rdtype)

    return jax.lax.cond(cg_res.istop == 2, run_minres, keep_cg, None)


def _fused_gen_fallback(A, b, bicg_res, opts):
    """Traced BiCGSTAB→TFQMR fallback: TFQMR runs under
    ``lax.cond(istop == 3)`` (recurrence breakdown) in the same compiled
    program; the two solvers share their whole keyword surface."""
    _check_traceable_opts(opts, "BiCGSTAB→TFQMR")
    rdtype = jnp.zeros((), b.dtype).real.dtype

    def run_tfqmr(_):
        return _strip_result(_S.tfqmr(A, b, **opts), True, rdtype)

    def keep(_):
        return _strip_result(bicg_res, False, rdtype)

    return jax.lax.cond(bicg_res.istop == 3, run_tfqmr, keep, None)


def _minres_fallback(A, b, cg_res, opts):
    """Re-solve an indefinite system with MINRES, preserving the square-
    solver options CG accepted.

    MINRES has no ``x0``/``atol`` knobs (reference ``minres.py:115-130``),
    so ``x0`` is honored by solving the residual system ``A d = b - A x0``
    and returning ``x0 + d``, and ``atol`` is folded into MINRES's relative
    tolerance via the initial residual norm measured by the CG attempt.
    """
    minres_opts = {k: v for k, v in opts.items()
                   if k in ("M", "rtol", "etol", "window", "store_history")}
    # Map the square-solver caps onto MINRES's itnlim.
    if "maxiter" in opts:
        minres_opts["itnlim"] = opts["maxiter"]
    elif "matvec_max" in opts:
        minres_opts["itnlim"] = opts["matvec_max"]
    atol = opts.get("atol")
    if atol is not None:
        resid0 = float(cg_res.resid_norm0)
        if resid0 > 0:
            minres_opts["rtol"] = max(float(minres_opts.get("rtol", 1e-12)),
                                      float(atol) / resid0)
    x0 = opts.get("x0")
    if x0 is None:
        return _S.minres(A, b, **minres_opts)
    x0 = jnp.asarray(x0)
    res = _S.minres(A, b - apply_op(A, x0.astype(b.dtype)), **minres_opts)
    return dataclasses.replace(
        res, x=res.x + x0.astype(res.x.dtype),
        n_matvec=res.n_matvec + 1)
