"""Compensated (double-f32) matvec resolution shared by the verified
solver paths.

Verified convergence in an f32 solve: the machinery
(ff-CG's ``replace_every``, :func:`~pykrylov_tpu.solvers.refine.
refined_solve`, the ``verify_final`` certificates) instead evaluates
true residuals with an error-compensated matvec when the operator's
STORAGE supports one — the plain f32 matvec floors at ~eps·|A||x|
(measured 2.3e-6 relative on 1138bus), above the reference's f64
rtol 1e-6 target (``/root/reference/pykrylov/cg/cg.py`` runs f64
NumPy throughout).

The check is STRUCTURAL (container types in ``_params``), not
``isinstance`` on the operator class: pytree round-trips inside an
outer jit reconstruct operators as plain ``LinearOperator``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["resolve_ff_matvec", "resolve_ff_matmat",
           "register_ff_matvec"]

# Sharded operators register their compensated matvec against the
# (memoized, permanent) shard_map-wrapped matvec FUNCTION OBJECT their
# pytree aux carries: the structural _params sniffs below cannot see a
# mesh/schedule, but the mv function identity survives pytree
# round-trips inside an outer jit (it IS aux data).  Keys are the
# lru_cached factory outputs, so the dict stays bounded.
_MV_REGISTRY = {}


def register_ff_matvec(mv_fn, ff_fn, ff_mm=None):
    """Associate a compensated matvec (and optional block product) with
    an operator's matvec function object (see module docstring).  The
    default block product is a column vmap of the matvec."""
    if ff_mm is None:
        ff_mm = _columns_of(ff_fn)
    _MV_REGISTRY[mv_fn] = (ff_fn, ff_mm)


def _ff_ell(params, xh, xl):
    from ..sparse import formats as SF
    return SF.ell_matvec_ff(params[0], xh, xl)


def _ff_dense(params, xh, xl):
    from ..utils.ff import two_prod, two_sum
    a = params
    m, n = a.shape
    p, pe = two_prod(a, xh[None, :])
    pe = pe + a * xl[None, :]

    def body(j, carry):
        yh, yl = carry
        s, e = two_sum(yh, jax.lax.dynamic_slice_in_dim(p, j, 1, 1)[:, 0])
        return two_sum(s, yl + e
                       + jax.lax.dynamic_slice_in_dim(pe, j, 1, 1)[:, 0])

    z = jnp.zeros(m, dtype=a.dtype)
    return jax.lax.fori_loop(0, n, body, (z, z))


def resolve_ff_matvec(A):
    """Pick a compensated (double-f32) matvec ``(params, xh, xl) ->
    (yh, yl)`` for the operator's storage, or ``None`` when no
    compensated path exists (callers then fall back to two plain
    applies, limited by the f32 matvec floor)."""
    from ..sparse import formats as SF
    reg = _MV_REGISTRY.get(getattr(A, "_mv", None))
    if reg is not None:
        return reg[0]
    params = getattr(A, "_params", None)
    if (isinstance(params, tuple) and len(params) >= 1
            and isinstance(params[0], SF.ELL)):
        return _ff_ell
    # dense MatrixOperator storage: a 2-D params array whose SHAPE is
    # the operator's shape — a bare ndim==2 sniff also matched
    # HaloDiaOperator's (ndiag, m) diagonal array and fed it to the
    # dense path (round-4 review finding)
    if (getattr(params, "ndim", None) == 2
            and tuple(params.shape) == (A.shape[0], A.shape[1])):
        return _ff_dense
    return None


def _columns_of(ff_mv):
    def mm(params, Xh, Xl):
        return jax.vmap(lambda xh, xl: ff_mv(params, xh, xl),
                        in_axes=(1, 1), out_axes=1)(Xh, Xl)
    return mm


_FF_MM = {id(_ff_ell): _columns_of(_ff_ell),
          id(_ff_dense): _columns_of(_ff_dense)}


def resolve_ff_matmat(A):
    """Block counterpart of :func:`resolve_ff_matvec`: a compensated
    product ``(params, Xh, Xl) -> (Yh, Yl)`` on (n, K) column blocks, or
    ``None``.

    Implemented as a trace-time ``vmap`` of the compensated matvec over
    columns — safe here because all compensated storages (ELL, dense,
    the registered sharded XLA paths) are XLA-level code.  The verified batched path therefore streams A's data per
    column; it trades the SpMM amortization for the certificate."""
    reg = _MV_REGISTRY.get(getattr(A, "_mv", None))
    if reg is not None:
        return reg[1] if reg[1] is not None else _columns_of(reg[0])
    mv = resolve_ff_matvec(A)
    if mv is None:
        return None
    return _FF_MM[id(mv)]


# historical name (pre-refactor callers imported this from solvers.cg)
_resolve_ff = resolve_ff_matvec
