"""Shared solver plumbing: operator coercion, thresholds, history buffers.

Stopping-rule semantics follow the reference square-system solvers:
``threshold = max(abstol, reltol * residNorm0)`` (``cg/cg.py:102``,
``bicgstab/bicgstab.py:70``, ``cgs/cgs.py:65``, ``tfqmr/tfqmr.py:64``) with
a matvec cap defaulting to 2n (``cg/cg.py:97``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..ops.base import BaseLinearOperator, LinearOperator, MatrixOperator

__all__ = ["as_operator", "as_apply_pair", "apply_op", "apply_op_T",
           "apply_op_H", "threshold_of", "history_init", "history_push",
           "table_init", "table_push", "attach_true_residual",
           "default_maxiter", "promote_rhs", "require_square", "dotu"]


def _apply_lo(op, x):
    return op.apply_with(op._mv, x)


def _apply_lo_T(op, x):
    return op.apply_with(op._rmv, x)


def _apply_lo_H(op, x):
    return op.apply_with(op._hmv, x)


def as_operator(A) -> LinearOperator:
    """Coerce to a LinearOperator pytree (arrays become MatrixOperator)."""
    if isinstance(A, BaseLinearOperator):
        return A
    if isinstance(A, (jnp.ndarray, np.ndarray)):
        return MatrixOperator(A)
    raise TypeError("cannot interpret %r as a linear operator" % (type(A),))


def as_apply_pair(A):
    """Return (operator pytree, apply, apply_T, apply_H) for solvers that
    need the adjoint (LLS family)."""
    op = as_operator(A)
    return op, _apply_lo, _apply_lo_T, _apply_lo_H


def apply_op(op, x):
    return _apply_lo(op, x)


def apply_op_T(op, x):
    return _apply_lo_T(op, x)


def apply_op_H(op, x):
    return _apply_lo_H(op, x)


def dotu(a, b):
    """Unconjugated vector dot — the reference's ``np.dot`` semantics
    (``bicgstab.py:103``, ``cgs.py:83``): for complex operands this is
    sum(a*b), NOT the inner product.  Full-precision reduction.
    """
    import jax
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def promote_rhs(b, *ops):
    """Promote b to the joint dtype of the rhs and all participating
    operators, mirroring the reference's NumPy promotion
    (``np.result_type(self.op.dtype, rhs.dtype)``, e.g.
    ``bicgstab/bicgstab.py:55``).  Keeps ``lax.while_loop`` carries
    type-stable when e.g. a float64 preconditioner meets a float32 system.
    """
    b = jnp.asarray(b)
    dt = jnp.result_type(b.dtype,
                         *[np.dtype(o.dtype) for o in ops if o is not None])
    return b.astype(dt)


def threshold_of(resid0, rtol, atol):
    """Reference stopping threshold max(abstol, reltol*resid0)."""
    return jnp.maximum(jnp.asarray(atol, resid0.dtype),
                       jnp.asarray(rtol, resid0.dtype) * resid0)


def default_maxiter(n, matvecs_per_iter=1, matvec_max=None):
    """Iteration cap from the reference's matvec_max (default 2n)."""
    if matvec_max is None:
        matvec_max = 2 * n
    return max(1, int(matvec_max) // int(matvecs_per_iter))


def history_init(store: bool, maxiter: int, dtype):
    if not store:
        return None
    return jnp.full((maxiter + 1,), jnp.nan, dtype=dtype)


def history_push(hist, k, value):
    if hist is None:
        return None
    return hist.at[k].set(value)


def table_init(store: bool, maxiter: int, ncols: int, dtype):
    """Per-iteration scalar telemetry for post-hoc ``show`` tables.

    The reference prints its iteration log live from the Python loop
    (e.g. ``minres/minres.py:375-393``); a fused ``lax.while_loop``
    does not call the host mid-flight, so solvers record the table's columns in a device buffer
    and :mod:`pykrylov_tpu.solvers.show` renders it afterwards."""
    if not store:
        return None
    return jnp.full((maxiter + 1, ncols), jnp.nan, dtype=dtype)


def table_push(tab, k, *cols):
    if tab is None:
        return None
    return tab.at[k].set(jnp.stack([jnp.asarray(c, tab.dtype)
                                    for c in cols]))


def attach_true_residual(A, b, res, shift=0.0):
    """Post-solve verification for solvers whose recurrences are trusted
    unverified: compute the true residual ``b - (A - shift I) x`` — with
    the compensated double-f32 matvec when the operator storage supports
    one (see ``ffmv.resolve_ff_matvec``; the plain f32 matvec floors at
    ~eps·|A||x|) — and record its 2-norm as ``info["true_resid_norm"]``.
    One diagnostic matvec, NOT counted in ``n_matvec`` (the reference
    has no analogue to mirror)."""
    from .ffmv import resolve_ff_matvec
    ff = resolve_ff_matvec(A)
    if ff is not None:
        from ..utils.ff import two_sum
        sh, sl = ff(A._params, res.x, jnp.zeros_like(res.x))
        d, de = two_sum(b, -sh)
        rt = d + (de - sl)
    else:
        rt = b - apply_op(A, res.x)
    if shift:
        rt = rt + shift * res.x
    res.info["true_resid_norm"] = jnp.linalg.norm(rt)
    return res


def attach_true_lls_residual(A, b, res, damp=0.0):
    """Post-solve verification for the least-squares family: the true
    residual ``rt = b - A x`` (compensated forward matvec when the
    operator storage supports one) and the least-squares optimality
    residual ``A' rt - damp^2 x`` — the quantity LSQR/LSMR's ``normar``
    estimates recursively and an f32 recurrence can misreport.  Both
    norms are Euclidean (M/N inner preconditioners are NOT folded in:
    this is the certificate an external user would compute).  Recorded
    as ``info["true_resid_norm"]`` / ``info["true_normar"]``; two
    diagnostic matvecs, NOT counted in ``n_matvec``."""
    from .ffmv import resolve_ff_matvec
    ff = resolve_ff_matvec(A)
    if ff is not None:
        from ..utils.ff import two_sum
        sh, sl = ff(A._params, res.x, jnp.zeros_like(res.x))
        d, de = two_sum(b, -sh)
        rt = d + (de - sl)
    else:
        rt = b - apply_op(A, res.x)
    ar = apply_op_T(A, rt)
    if damp:
        ar = ar - (damp * damp) * res.x
    res.info["true_resid_norm"] = jnp.linalg.norm(rt)
    res.info["true_normar"] = jnp.linalg.norm(ar)
    return res


def require_square(A, b, solver_name):
    """Shape guard for square-system solvers: A square, b length-matched."""
    m, n = A.shape
    if m != n:
        raise ValueError(
            "%s expects a square operator, got %dx%d (use lsqr/lsmr/craig "
            "for rectangular systems)" % (solver_name, m, n))
    if jnp.ndim(b) != 1 or jnp.shape(b)[0] != n:
        raise ValueError(
            "%s: rhs has shape %s, expected (%d,)"
            % (solver_name, (jnp.shape(b),), n))
