"""Operators backed by sparse containers, with automatic format choice.

This is the device counterpart of ``PysparseLinearOperator``
(``/root/reference/pykrylov/linop/linop.py:688-720``): the solver-facing
object is still a :class:`~pykrylov_tpu.ops.LinearOperator`, but its matvec
is a device kernel over a :mod:`pykrylov_tpu.sparse.formats` container
rather than a host call into a C extension.

Format policy (SURVEY §7 "hard parts"): matrices whose nonzeros live on few
distinct diagonals (stencils, banded systems) use DIA — index-free shifted
axpys that XLA fuses into one streaming pass.  General sparsity uses ELL —
padded-row gathers, no scatters.  ``sparse_operator`` picks automatically.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.base import LinearOperator, _register_as_linop
from . import formats as F

__all__ = ["SparseOperator", "sparse_operator", "operator_from_coo",
           "jacobi_preconditioner", "diag_of_coo"]


def _mv_fwd(params, x):
    fwd, _ = params
    if isinstance(fwd, F.DIA):
        return F.dia_matvec(fwd, x)
    if isinstance(fwd, F.ELL):
        return F.ell_matvec(fwd, x)
    if isinstance(fwd, F.CSR):
        return F.csr_matvec(fwd, x)
    return F.coo_matvec(fwd, x)


def _mv_bwd(params, x):
    fwd, bwd = params
    if bwd is None:  # symmetric
        return _mv_fwd(params, x)
    return _mv_fwd((bwd, None), x)


class SparseOperator(LinearOperator):
    """LinearOperator over a sparse container.

    ``params = (forward_container, transpose_container_or_None)``.  The
    transpose container is materialized at construction (host-side) unless
    the matrix is symmetric — runtime transposition of sparse structure is
    hostile to static-shape compilation, and Krylov solvers apply A^T as
    often as A, so prebuilt structure is the right trade.
    """

    def __init__(self, fwd, bwd=None, symmetric=False, **kwargs):
        m, n = fwd.shape
        is_complex = np.issubdtype(fwd.data.dtype, np.complexfloating)
        super().__init__(
            n, m, matvec=_mv_fwd,
            matvec_transp=_mv_bwd if (bwd is not None or symmetric) else None,
            params=(fwd, bwd if not symmetric else None),
            _takes_params=True,
            symmetric=symmetric,
            hermitian=symmetric and not is_complex,
            dtype=fwd.data.dtype, **kwargs)

    @property
    def container(self):
        return self._params[0]

    def to_array(self):
        return F.to_dense(self._params[0])


_register_as_linop(SparseOperator)


def operator_from_coo(vals, rows, cols, shape, symmetric=False,
                      fmt="auto", dtype=None, dia_density_threshold=0.25,
                      max_diags=64):
    """Build a SparseOperator from COO triples, choosing a compute format.

    ``fmt`` is one of ``auto | dia | ell | csr | coo``.  ``auto`` picks
    DIA when the nonzeros land on at most ``max_diags`` distinct diagonals
    with at least ``dia_density_threshold`` fill, else ELL.  Both are
    plain XLA programs: the choice depends only on the matrix.
    """
    # Host-resident intermediate: every conversion below reads the triples
    # on the host, and device round-trips dominate construction cost.
    coo = F.coo_from_arrays(vals, rows, cols, shape, dtype=dtype,
                            device=False)
    if fmt == "auto":
        ndiag, density = F.bandwidth_profile(coo)
        fmt = "dia" if (ndiag <= max_diags and
                        density >= dia_density_threshold) else "ell"
    if fmt == "dia":
        fwd = F.dia_from_coo(coo)
        bwd = None if symmetric else F.dia_from_coo(F.transpose_coo(coo))
    elif fmt == "ell":
        fwd = F.ell_from_coo(coo, pad_to=4)
        bwd = None if symmetric else F.ell_from_coo(F.transpose_coo(coo),
                                                    pad_to=4)
    elif fmt == "csr":
        fwd = F.csr_from_coo(coo)
        bwd = None if symmetric else F.csr_from_coo(F.transpose_coo(coo))
    elif fmt == "coo":
        fwd = F.coo_from_arrays(coo.data, coo.row, coo.col, coo.shape,
                                sort=False)  # device-resident
        bwd = None if symmetric else F.transpose_coo(coo, device=True)
    else:
        raise ValueError("unknown format %r" % fmt)
    return SparseOperator(fwd, bwd, symmetric=symmetric)


def sparse_operator(source, symmetric=False, fmt="auto", dtype=None):
    """Convenience front door: source may be COO triples tuple, a container,
    a dense array, or a bundled-matrix name (str)."""
    if isinstance(source, str):
        from ..io.datasets import load_bundled
        vals, rows, cols, shape = load_bundled(source, dtype=dtype or np.float64)
        return operator_from_coo(vals, rows, cols, shape,
                                 symmetric=symmetric, fmt=fmt, dtype=dtype)
    # Containers first: COO is itself a length-4 NamedTuple, so the
    # plain-triples check below would otherwise capture (and rebuild) it.
    if isinstance(source, (F.COO, F.CSR, F.ELL, F.DIA)):
        return SparseOperator(source, None, symmetric=symmetric)
    if isinstance(source, tuple) and len(source) == 4:
        vals, rows, cols, shape = source
        return operator_from_coo(vals, rows, cols, shape,
                                 symmetric=symmetric, fmt=fmt, dtype=dtype)
    if isinstance(source, (np.ndarray, jnp.ndarray)):
        a = np.asarray(source)
        rows, cols = np.nonzero(a)
        return operator_from_coo(a[rows, cols], rows, cols, a.shape,
                                 symmetric=symmetric, fmt=fmt, dtype=dtype)
    raise TypeError("cannot build a sparse operator from %r" % type(source))


def diag_of_coo(vals, rows, cols, n):
    """Extract the main diagonal from COO triples (host-side)."""
    d = np.zeros(n, dtype=np.asarray(vals).dtype)
    mask = np.asarray(rows) == np.asarray(cols)
    np.add.at(d, np.asarray(rows)[mask], np.asarray(vals)[mask])
    return d


def jacobi_preconditioner(source, floor=0.0, dtype=None):
    """Diagonal (Jacobi) preconditioner M = diag(1/|d_i|) as an operator.

    Mirrors the reference benchmark's ``DiagonalPrec`` (max(|diag|, 1),
    ``examples/bmark.py:14-23``) when ``floor=1``.  ``dtype`` sets the
    diagonal's dtype (default: the source's, float64 for bundled
    matrices) — pass the system's dtype to keep an f32 solve in f32.
    """
    import os
    from ..ops.base import DiagonalOperator
    if isinstance(source, str):
        if os.path.exists(source):  # a .mtx file path
            from ..io.matrix_market import read_matrix_market
            vals, rows, cols, shape, _ = read_matrix_market(source)
        else:
            from ..io.datasets import load_bundled
            vals, rows, cols, shape = load_bundled(source)
        d = diag_of_coo(vals, rows, cols, shape[0])
    elif isinstance(source, tuple) and len(source) == 4:
        vals, rows, cols, shape = source
        d = diag_of_coo(vals, rows, cols, shape[0])
    elif isinstance(source, SparseOperator):
        d = np.diag(np.asarray(source.to_array()))
    else:
        d = np.diag(np.asarray(source))
    d = np.abs(d)
    if floor:
        d = np.maximum(d, floor)
    # Structurally zero diagonal entries (saddle-point/constraint rows)
    # would make 1/d infinite and poison the first preconditioner apply;
    # act as the identity on those rows instead.
    d = np.where(d == 0, 1.0, d)
    return DiagonalOperator((1.0 / d).astype(dtype or d.dtype))

