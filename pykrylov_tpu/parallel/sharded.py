"""Row-block sharding of vectors and sparse operators.

Places ``NamedSharding`` on the row dimension of sparse containers and on
vectors, then lets XLA's SPMD partitioner compile the *unchanged* solver
loops into per-device programs with the right collectives:

  * dots (``jnp.vdot``) over row-sharded vectors → local partial dot +
    ``psum`` over the ``rows`` axis;
  * axpys stay local (no communication);
  * ELL matvec ``sum(data * x[cols], axis=1)`` with row-sharded data and
    row-sharded x → all-gather of x + local gather/reduce — the generic
    fallback; :class:`~pykrylov_tpu.parallel.gather.GatherEllOperator`
    replaces it with a partition-time schedule that ships only the
    referenced entries (SURVEY §7 "halo exchange generality");
  * DIA matvec via :class:`~pykrylov_tpu.parallel.halo.HaloDiaOperator`
    uses explicit neighbor exchange instead (cheaper for stencils).

Rows are padded to a multiple of the mesh size with zero rows/cols so every
shard is equally shaped (static shapes are non-negotiable under jit).
The padding is benign for all solvers: padded entries of b are zero and the
padded block of the operator is zero, so padded components of every Krylov
vector stay exactly zero.  Use :func:`pad_system`'s returned slice to read
the solution back.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..sparse import formats as F
from ..sparse.linop import SparseOperator
from .mesh import ROW_AXIS

__all__ = ["shard_vector", "replicate", "shard_operator", "pad_to_multiple",
           "sharded_poisson3d"]


def pad_to_multiple(n, d):
    return (n + d - 1) // d * d


def shard_vector(x, mesh, axis=ROW_AXIS):
    """Shard a vector's single dimension over the mesh's row axis."""
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def replicate(x, mesh):
    """Replicate an array over the mesh (preconditioner diagonals etc.)."""
    return jax.device_put(x, NamedSharding(mesh, P()))


def _shard_ell(ell: F.ELL, mesh, axis) -> F.ELL:
    m, n = ell.shape
    d = mesh.shape[axis]
    mp = pad_to_multiple(m, d)
    data = np.zeros((mp, ell.data.shape[1]), dtype=ell.data.dtype)
    cols = np.zeros((mp, ell.cols.shape[1]), dtype=np.int32)
    data[:m] = np.asarray(ell.data)
    cols[:m] = np.asarray(ell.cols)
    sh = NamedSharding(mesh, P(axis, None))
    return F.ELL(jax.device_put(data, sh),
                 jax.device_put(cols, sh), (mp, n))


def _shard_dia(dia: F.DIA, mesh, axis) -> F.DIA:
    m, n = dia.shape
    d = mesh.shape[axis]
    mp = pad_to_multiple(m, d)
    data = np.zeros((dia.data.shape[0], mp), dtype=dia.data.dtype)
    data[:, :m] = np.asarray(dia.data)
    sh = NamedSharding(mesh, P(None, axis))
    return F.DIA(jax.device_put(data, sh), dia.offsets, (mp, n))


def shard_operator(op, mesh, axis=ROW_AXIS):
    """Row-block-shard a square :class:`SparseOperator` over ``mesh``.

    Returns ``(sharded_op, pad)``: the operator acts on vectors of length
    ``m + pad`` (sharded with :func:`shard_vector`); the trailing ``pad``
    entries are structurally zero.  Supported container formats: ELL (the
    general case — transpose container sharded the same way) and DIA.
    """
    params = getattr(op, "_params", None)
    if (not isinstance(params, tuple) or len(params) != 2
            or not isinstance(params[0], (F.ELL, F.DIA))):
        raise TypeError(
            "shard_operator expects a SparseOperator over ELL/DIA "
            "containers; got %s" % type(op).__name__)
    fwd, bwd = params
    m, n = fwd.shape
    if m != n:
        raise ValueError("shard_operator expects a square operator")
    d = mesh.shape[axis]
    mp = pad_to_multiple(m, d)

    if isinstance(fwd, F.ELL):
        fwd_s = _shard_ell(fwd, mesh, axis)
        bwd_s = _shard_ell(bwd, mesh, axis) if bwd is not None else None
    elif isinstance(fwd, F.DIA):
        fwd_s = _shard_dia(fwd, mesh, axis)
        bwd_s = _shard_dia(bwd, mesh, axis) if bwd is not None else None
    else:
        raise TypeError("shard_operator supports ELL/DIA containers, got %s"
                        % type(fwd).__name__)
    # The padded operator maps R^{mp} -> R^{mp}; column space also padded.
    fwd_s = type(fwd_s)(*fwd_s[:-1], (mp, mp))
    if bwd_s is not None:
        bwd_s = type(bwd_s)(*bwd_s[:-1], (mp, mp))
    sharded = SparseOperator(fwd_s, bwd_s, symmetric=op.symmetric)
    return sharded, mp - m


def sharded_poisson3d(n, mesh, dtype=np.float64, halo=True,
                      matrix_free=False):
    """Generated 3-D Poisson system sharded over ``mesh`` — the multi-host
    weak-scaling workload (SURVEY §7 stage 7, BASELINE north-star #5).

    Returns ``(op, b, exact, pad)`` with ``b = A·e`` sharded on rows.
    ``halo=True`` uses the ppermute halo-exchange DIA operator; otherwise
    the generic sharded-DIA path (XLA-chosen collectives).
    ``matrix_free=True`` returns the zero-storage stencil operator
    instead (fastest for this constant-coefficient class — no matrix
    traffic at all; requires the mesh extent to divide ``n``).
    """
    from ..gallery.poisson import poisson3d_dia
    from .halo import HaloDiaOperator

    if matrix_free:
        from .stencil import HaloStencilPoisson3DOperator
        op = HaloStencilPoisson3DOperator(n, mesh, dtype=dtype)
        e = shard_vector(jnp.ones(n ** 3, dtype=dtype), mesh)
        return op, op * e, e, 0

    dia = poisson3d_dia(n, dtype=dtype)
    shape = dia.shape
    if halo:
        op = HaloDiaOperator(dia, mesh)
        pad = op.pad
    else:
        base = SparseOperator(dia, None, symmetric=True)
        op, pad = shard_operator(base, mesh)
    m = shape[0]
    e = np.zeros(m + pad, dtype=dtype)
    e[:m] = 1.0
    e = shard_vector(e, mesh)
    b = op * e
    return op, b, e, pad
