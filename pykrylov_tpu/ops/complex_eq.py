"""Complex linear systems via the real-equivalent formulation.

The reference supports complex operators natively (dtype whitelists
``/root/reference/pykrylov/tools/types.py:1-16``, conjugation-inferred
``.H`` twins ``linop/linop.py:172-211``), and so does this package's
operator layer.  This module offers the alternative for backends or
solvers that want real arithmetic only: a complex system ``A z = b``
is solved as the REAL system

    [ Re A   -Im A ] [ Re z ]   [ Re b ]
    [ Im A    Re A ] [ Im z ] = [ Im b ]

with the isometric packing ``pack_complex(z) = [Re z; Im z]``.  Every
property the solvers rely on carries over exactly:

* ``||pack(z)||_2 = ||z||_2`` and ``<pack u, pack v> = Re <u, v>`` —
  residual norms, stopping tests and energy identities are preserved;
* A Hermitian  ⇒  the real equivalent is SYMMETRIC; Hermitian positive
  definite ⇒ SPD, so CG/MINRES apply with their full theory;
* the real equivalent's spectrum is the complex spectrum with each
  eigenvalue doubled (λ and its conjugate) — for Hermitian A the
  eigenvalues are real and simply double in multiplicity, so CG/MINRES
  iteration counts MATCH the complex-arithmetic recurrence (tested);
  for general A the doubled conjugate pairs can change nonsymmetric
  Krylov trajectories (documented deviation, not a wrong answer: the
  stopping rule still certifies the true complex residual);
* least squares: ``min ||A z - b||`` over complex z is EXACTLY the
  real-equivalent least-squares problem (the packing is isometric), so
  LSQR/LSMR/CRAIG apply unchanged.

One real-equivalent matvec costs the same four real block products a
complex matvec performs in complex arithmetic — no redundant work; the
four blocks share two sparsity patterns, and explicitly-zero Re/Im
blocks are dropped at packing time (a real-valued matrix costs exactly
2x nnz, not 4x).

A real-arithmetic complex solve is therefore one wrapper away:
``complex_solve(cg, A, b, rtol=...)`` packs, solves with the real
sparse operators, and unpacks a complex result.  Whether it beats
native complex arithmetic on the GPU is not measured.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

__all__ = ["pack_complex", "unpack_complex", "real_equivalent_dense",
           "real_equivalent_coo", "real_equivalent_operator",
           "complex_solve"]


def _real_dtype(dtype):
    return np.zeros((), np.dtype(dtype)).real.dtype


def pack_complex(z):
    """(m,) or (m, K) complex -> (2m,) or (2m, K) real ``[Re; Im]``.

    Isometric: ``||pack(z)|| = ||z||`` and
    ``pack(u) . pack(v) = Re(u^H v)``.  Real inputs pack with a zero
    imaginary half.  Host-side (NumPy): packing happens before the
    operands move to the device.
    """
    z = np.asarray(z)
    return np.concatenate([z.real, z.imag], axis=0).astype(
        _real_dtype(z.dtype))


def unpack_complex(x):
    """(2m,) or (2m, K) real -> complex (m,) or (m, K): inverse of
    :func:`pack_complex`.  Accepts device arrays (pulls to host)."""
    x = np.asarray(x)
    m2 = x.shape[0]
    if m2 % 2:
        raise ValueError("unpack_complex: leading dimension %d is odd"
                         % m2)
    m = m2 // 2
    # Pair every sub-double float (f32, and the bf16/f16 blocks that
    # low-precision solves produce) with complex64; only f64 widens to
    # complex128 — upcasting bf16 results to c128 would fabricate
    # precision.
    ct = np.complex128 if x.dtype == np.float64 else np.complex64
    return (x[:m] + 1j * x[m:]).astype(ct)


def real_equivalent_dense(a):
    """Complex (m, n) dense -> real (2m, 2n) ``[[Re, -Im], [Im, Re]]``."""
    a = np.asarray(a)
    re, im = a.real, a.imag
    return np.block([[re, -im], [im, re]]).astype(_real_dtype(a.dtype))


def real_equivalent_coo(vals, rows, cols, shape, drop_zeros=True):
    """Complex COO triples -> real-equivalent COO triples of shape
    (2m, 2n).

    Entry ``(r, c, v)`` contributes up to four real entries:
    ``(r, c, Re v)``, ``(r, c+n, -Im v)``, ``(r+m, c, Im v)``,
    ``(r+m, c+n, Re v)``.  With ``drop_zeros`` (default) exact-zero
    Re/Im parts emit nothing — a real-valued complex matrix packs to
    2x nnz, a purely imaginary one to 2x, a dense-complex one to 4x.
    Triples must store the FULL pattern (both triangles of a Hermitian
    matrix); the one-triangle convention is not expanded here.
    """
    m, n = shape
    vals = np.asarray(vals)
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    re, im = vals.real, vals.imag
    rt = _real_dtype(vals.dtype)
    out_v, out_r, out_c = [], [], []
    for blk_v, dr, dc in ((re, 0, 0), (re, m, n), (-im, 0, n), (im, m, 0)):
        if drop_zeros:
            keep = blk_v != 0
            if not keep.any():
                continue
            out_v.append(blk_v[keep].astype(rt))
            out_r.append(rows[keep] + dr)
            out_c.append(cols[keep] + dc)
        else:
            out_v.append(blk_v.astype(rt))
            out_r.append(rows + dr)
            out_c.append(cols + dc)
    if not out_v:           # all-zero matrix: one explicit zero entry
        out_v, out_r, out_c = [np.zeros(1, rt)], [np.zeros(1, np.int64)], \
            [np.zeros(1, np.int64)]
    return (np.concatenate(out_v), np.concatenate(out_r),
            np.concatenate(out_c), (2 * m, 2 * n))


def real_equivalent_operator(source, hermitian=False, fmt="auto",
                             dtype=None):
    """Build a REAL (2m, 2n) LinearOperator equivalent to a complex
    matrix.

    ``source``: complex dense ndarray or COO triples
    ``(vals, rows, cols, shape)`` (full pattern).  ``hermitian=True``
    marks the real equivalent symmetric (valid iff A is Hermitian —
    NOT for merely complex-symmetric A, whose real equivalent is
    unsymmetric).  ``dtype`` is the REAL compute dtype (e.g.
    ``jnp.float32`` for complex64 inputs).

    A DENSE source builds a dense :class:`MatrixOperator` over the
    (2m, 2n) real-equivalent array — one dense matmul per product (the
    sparse formats are pathological on fully dense patterns).  COO
    triples go through the sparse front door
    (:func:`pykrylov_tpu.sparse.sparse_operator`); ``fmt`` passes through there (or force ``fmt="dense"`` to
    densify small triples).

    The returned operator carries ``m_complex``/``n_complex``
    attributes with the original complex shape.
    """
    from ..sparse.linop import sparse_operator
    from .base import linop_from_ndarray

    dense_src = not (isinstance(source, tuple) and len(source) == 4)
    if dense_src:
        a = np.asarray(source)
        if a.ndim != 2:
            raise ValueError("real_equivalent_operator: expected a 2-D "
                             "matrix or COO triples, got shape %s"
                             % (a.shape,))
        shape = a.shape
    else:
        vals, rows, cols, shape = source

    if fmt == "dense" or (dense_src and fmt == "auto"):
        if not dense_src:
            a = np.zeros(shape, dtype=np.asarray(vals).dtype)
            np.add.at(a, (np.asarray(rows), np.asarray(cols)),
                      np.asarray(vals))
        ar = real_equivalent_dense(a)
        if dtype is not None:
            ar = ar.astype(dtype)
        op = linop_from_ndarray(jnp.asarray(ar),
                                symmetric=bool(hermitian))
    else:
        if dense_src:
            rows, cols = np.nonzero(a)
            vals = a[rows, cols]
        vals4 = real_equivalent_coo(vals, rows, cols, shape)
        op = sparse_operator(vals4, symmetric=bool(hermitian), fmt=fmt,
                             dtype=dtype)
    op.m_complex, op.n_complex = shape
    return op


def complex_solve(solver, A, b, *, x0=None, **kwargs):
    """Solve a complex system/least-squares problem with a REAL solver
    on the real-equivalent formulation.

    Parameters
    ----------
    solver : any solver from :mod:`pykrylov_tpu.solvers` (``cg``,
        ``minres``, ``bicgstab``, ``lsqr``, ..., or a batched variant —
        anything with the ``solver(A, b, **kwargs)`` contract).
    A : the complex matrix — dense ndarray, COO triples tuple, or an
        operator already built by :func:`real_equivalent_operator`
        (pass ``hermitian=True`` there for Hermitian systems so
        CG/MINRES accept it).
    b : complex right-hand side, (m,) or (m, K) for batched solvers.
    x0 : optional complex initial guess (packed automatically).
    kwargs : passed through to the solver.  Preconditioners (``M``,
        ``N``) must already BE real-equivalent operators — build them
        with :func:`real_equivalent_operator`, or act directly in the
        packed space (e.g. a Jacobi diagonal repeated twice).

    Returns the solver's :class:`SolveResult` with ``x`` replaced by
    the UNPACKED complex solution (host-side NumPy array).  Norm fields
    (``resid_norm``, ``resid_norm0``, histories) are exact complex
    residual norms by the packing isometry.  ``n_matvec`` counts
    real-equivalent products — each is the same work as one complex
    matvec.
    """
    import dataclasses

    from ..ops.base import BaseLinearOperator

    if isinstance(A, BaseLinearOperator):
        op = A
    else:
        # Hermitian detection is the caller's statement, not sniffed:
        # default to the general (unsymmetric) real equivalent
        op = real_equivalent_operator(A)
    bp = jnp.asarray(pack_complex(b))
    if x0 is not None:
        kwargs["x0"] = jnp.asarray(pack_complex(x0))
    res = solver(op, bp, **kwargs)
    return dataclasses.replace(res, x=unpack_complex(res.x))
