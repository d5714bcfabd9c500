"""Sparse-matrix containers as JAX pytrees.

JAX-native replacement for the reference's pysparse delegation and
pure-Python COO loops (``/root/reference/pykrylov/linop/linop.py:638-685``).
Four formats, chosen for how they map to device memory and vector lanes:

  * :class:`COO`   — interchange format; matvec = gather + ``segment_sum``.
  * :class:`CSR`   — storage/interchange; carries precomputed ``row_ids``
    so its matvec is the COO kernel without a searchsorted.
  * :class:`ELL`   — padded rows (n_rows x K), the general *compute* format:
    the matvec is K lane-aligned gathers + multiply-accumulate, no scatter.
  * :class:`DIA`   — diagonal storage for banded/stencil matrices: the
    matvec is a static sum of shifted axpys — no indices at all, the
    speed-of-light format (HBM traffic = values + x + y).

All containers are immutable pytrees (arrays as children, shape/offsets as
static aux data) so they can be jit arguments, sharded with
``NamedSharding``, and live inside ``lax.while_loop`` carries.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["COO", "CSR", "ELL", "DIA",
           "coo_from_arrays", "csr_from_coo", "ell_from_coo", "dia_from_coo",
           "coo_matvec", "csr_matvec", "ell_matvec", "dia_matvec",
           "to_dense", "transpose_coo", "bandwidth_profile"]


class COO(NamedTuple):
    """Coordinate triples. ``shape`` is static metadata."""
    data: jnp.ndarray
    row: jnp.ndarray
    col: jnp.ndarray
    shape: Tuple[int, int]


class CSR(NamedTuple):
    """Compressed sparse rows + precomputed per-nnz row ids."""
    data: jnp.ndarray
    indices: jnp.ndarray
    indptr: jnp.ndarray
    row_ids: jnp.ndarray
    shape: Tuple[int, int]


class ELL(NamedTuple):
    """Padded-row format: ``data``/``cols`` are (n_rows, K); padding slots
    have ``data == 0`` and ``cols`` pointing at row 0 (harmless gather)."""
    data: jnp.ndarray
    cols: jnp.ndarray
    shape: Tuple[int, int]


class DIA(NamedTuple):
    """Diagonal format: ``offsets`` static tuple, ``data`` is (ndiag, n)
    where ``data[d, i]`` multiplies ``x[i + offsets[d]]`` into ``y[i]``
    (rows of length n = shape[0]; out-of-range slots are zero)."""
    data: jnp.ndarray
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]


# NamedTuples are pytrees automatically, but their ``shape``/``offsets``
# fields must be static.  Register custom flattening to pull them into aux.
def _reg(cls, array_fields, static_fields):
    def flatten(v):
        return tuple(getattr(v, f) for f in array_fields), \
               tuple(getattr(v, f) for f in static_fields)

    def unflatten(aux, children):
        kw = dict(zip(array_fields, children))
        kw.update(dict(zip(static_fields, aux)))
        return cls(**kw)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)


_reg(COO, ("data", "row", "col"), ("shape",))
_reg(CSR, ("data", "indices", "indptr", "row_ids"), ("shape",))
_reg(ELL, ("data", "cols"), ("shape",))
_reg(DIA, ("data",), ("offsets", "shape"))


# ---------------------------------------------------------------------------
# Construction (host-side; NumPy in, device arrays out)
# ---------------------------------------------------------------------------


def coo_from_arrays(vals, rows, cols, shape, dtype=None, sort=True,
                    device=True) -> COO:
    """Build a COO container from triples (host-side sort).

    ``device=False`` keeps the fields as NumPy arrays — use it for
    intermediate containers in conversion pipelines: pulling arrays back
    from a (possibly remote) device for the next host-side conversion
    step is far more expensive than the conversion itself.
    """
    vals = np.asarray(vals)
    if dtype is not None:
        vals = vals.astype(dtype)
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    if sort:
        order = np.lexsort((cols, rows))
        vals, rows, cols = vals[order], rows[order], cols[order]
    if not device:
        return COO(vals, rows, cols, (int(shape[0]), int(shape[1])))
    return COO(jnp.asarray(vals), jnp.asarray(rows), jnp.asarray(cols),
               (int(shape[0]), int(shape[1])))


def csr_from_coo(coo: COO, assume_sorted=False, device=True) -> CSR:
    m, n = coo.shape
    rows = np.asarray(coo.row)
    cols = np.asarray(coo.col)
    data = np.asarray(coo.data)
    if not assume_sorted:  # coo_from_arrays(sort=True) already row-sorted
        order = np.lexsort((cols, rows))
        rows, cols, data = rows[order], cols[order], data[order]
    indptr = np.zeros(m + 1, dtype=np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    arr = jnp.asarray if device else (lambda a: a)
    return CSR(arr(data), arr(cols.astype(np.int32)),
               arr(indptr), arr(rows.astype(np.int32)), (m, n))


def ell_from_coo(coo: COO, pad_to: int = 1, assume_sorted=False,
                 device=True) -> ELL:
    """Build padded-row ELL.  ``pad_to`` rounds K up (lane alignment).

    Packing runs in the native C++ pipeline when available
    (:mod:`pykrylov_tpu.native`), else as vectorized NumPy.
    """
    m, n = coo.shape
    rows = np.asarray(coo.row)
    cols = np.asarray(coo.col)
    data = np.asarray(coo.data)
    counts = np.bincount(rows, minlength=m)
    K = int(counts.max()) if len(counts) and counts.max() > 0 else 1
    K = max(1, -(-K // pad_to) * pad_to)
    if assume_sorted:
        rows_s, cols_s, data_s = rows, cols, data
    else:
        order = np.lexsort((cols, rows))
        rows_s, cols_s, data_s = rows[order], cols[order], data[order]

    filled = None
    try:
        from ..native import ell_fill_native
        filled = ell_fill_native(rows_s, cols_s, data_s, m, K)
    except Exception:
        filled = None
    if filled is not None:
        ed, ec = filled
        ed = ed.astype(data.dtype, copy=False)
    else:
        # Vectorized fallback: slot k of row r = position within the row.
        starts = np.zeros(m + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        slots = np.arange(len(rows_s), dtype=np.int64) - starts[rows_s]
        ed = np.zeros((m, K), dtype=data.dtype)
        ec = np.zeros((m, K), dtype=np.int32)
        ed[rows_s, slots] = data_s
        ec[rows_s, slots] = cols_s
    if not device:
        return ELL(ed, ec, (m, n))
    return ELL(jnp.asarray(ed), jnp.asarray(ec), (m, n))


def dia_from_coo(coo: COO, max_diags: int = 4096, device=True) -> DIA:
    """Build diagonal storage; raises if the matrix has too many distinct
    diagonals to be a sensible DIA candidate."""
    m, n = coo.shape
    rows = np.asarray(coo.row).astype(np.int64)
    cols = np.asarray(coo.col).astype(np.int64)
    data = np.asarray(coo.data)
    offs = np.unique(cols - rows)
    if len(offs) > max_diags:
        raise ValueError("matrix has %d distinct diagonals (> %d): use ELL"
                         % (len(offs), max_diags))
    dd = None
    try:
        from ..native import dia_fill_native
        dd = dia_fill_native(rows, cols, data, m, offs)
    except Exception:
        dd = None
    if dd is not None:
        dd = dd.astype(data.dtype, copy=False)
    else:
        # Vectorized fallback: diagonal index by binary search.
        # add.at: duplicate COO entries accumulate, matching to_dense/
        # coo_matvec/ELL/BSR semantics.
        k = np.searchsorted(offs, cols.astype(np.int64) - rows)
        dd = np.zeros((len(offs), m), dtype=data.dtype)
        np.add.at(dd, (k, rows), data)
    if not device:
        return DIA(dd, tuple(int(o) for o in offs), (m, n))
    return DIA(jnp.asarray(dd), tuple(int(o) for o in offs), (m, n))


def transpose_coo(coo: COO, device=None) -> COO:
    if device is None:  # preserve the input's host/device residency
        device = isinstance(coo.data, jnp.ndarray)
    return coo_from_arrays(np.asarray(coo.data), np.asarray(coo.col),
                           np.asarray(coo.row),
                           (coo.shape[1], coo.shape[0]), device=device)


def bandwidth_profile(coo: COO):
    """(n_distinct_diagonals, density inside DIA storage) — format chooser."""
    rows = np.asarray(coo.row).astype(np.int64)
    cols = np.asarray(coo.col).astype(np.int64)
    offs = np.unique(cols - rows)
    nnz = len(rows)
    dia_slots = len(offs) * coo.shape[0]
    return len(offs), nnz / max(dia_slots, 1)


# ---------------------------------------------------------------------------
# Matvecs (pure XLA)
# ---------------------------------------------------------------------------


def coo_matvec(a: COO, x):
    return jax.ops.segment_sum(a.data * x[a.col], a.row,
                               num_segments=a.shape[0])


def coo_rmatvec(a: COO, x):
    return jax.ops.segment_sum(a.data * x[a.row], a.col,
                               num_segments=a.shape[1])


def csr_matvec(a: CSR, x):
    # row_ids make this the COO kernel: sorted segment ids → XLA lowers the
    # scatter-add to an efficient segmented reduction.
    return jax.ops.segment_sum(a.data * x[a.indices], a.row_ids,
                               num_segments=a.shape[0],
                               indices_are_sorted=True)


def csr_rmatvec(a: CSR, x):
    return jax.ops.segment_sum(a.data * x[a.row_ids], a.indices,
                               num_segments=a.shape[1])


def ell_matvec(a: ELL, x):
    # (m, K) gather of x at cols, multiply, reduce over K: no scatter.  K is small and static, so XLA emits one fused pass.
    return jnp.sum(a.data * x[a.cols], axis=1)


def ell_matvec_ff(a: ELL, xh, xl):
    """Compensated (double-f32) ELL matvec: ``A (xh + xl)`` as an
    (hi, lo) pair accurate to ~2x-f32.

    Error-free TwoProd per slot + a TwoSum cascade over the K row slots
    (static unroll; K is small).  Used by the verified-convergence CG
    residual replacement (:mod:`pykrylov_tpu.utils.ff`) — the plain f32
    matvec cannot evaluate residuals below ~eps·|A||x|.
    """
    from ..utils.ff import two_prod, two_sum
    gh = xh[a.cols]
    gl = xl[a.cols]
    p, pe = two_prod(a.data, gh)
    pe = pe + a.data * gl
    m, K = p.shape
    yh = jnp.zeros(m, dtype=p.dtype)
    yl = jnp.zeros(m, dtype=p.dtype)
    for k in range(K):  # static unroll over the padded row width
        s, e = two_sum(yh, p[:, k])
        yh, yl = two_sum(s, yl + e + pe[:, k])
    return yh, yl


def dia_matvec(a: DIA, x):
    """y[i] = sum_d data[d, i] * x[i + off_d] as static shifted slices.

    Each diagonal contributes a shifted window of x; shifts are static so
    XLA compiles this to vector adds with no gathers or scatters.
    """
    m, n = a.shape
    lo = min(0, *a.offsets) if a.offsets else 0
    hi = max(0, *a.offsets) if a.offsets else 0
    pad_lo, pad_hi = -lo, max(0, m + hi - n)
    xp = jnp.pad(x, (pad_lo, pad_hi))
    y = jnp.zeros(m, dtype=jnp.result_type(a.data.dtype, x.dtype))
    for d, off in enumerate(a.offsets):  # static unroll
        start = pad_lo + off
        y = y + a.data[d] * jax.lax.dynamic_slice_in_dim(xp, start, m)
    return y


def dia_rmatvec(a: DIA, x):
    """A^T has the negated offsets with data realigned: (A^T)[j,i]=A[i,j];
    diagonal off in A becomes -off with data shifted by off."""
    m, n = a.shape
    lo = min(0, *(-o for o in a.offsets)) if a.offsets else 0
    hi = max(0, *(-o for o in a.offsets)) if a.offsets else 0
    pad_lo, pad_hi = -lo, max(0, n + hi - m)
    xp = jnp.pad(x, (pad_lo, pad_hi))
    y = jnp.zeros(n, dtype=jnp.result_type(a.data.dtype, x.dtype))
    for d, off in enumerate(a.offsets):
        # value data[d, i] sits at (i, i+off); contributes to y[i+off] from
        # x[i]: y[j] += data[d, j-off] * x[j-off] for valid j.
        # Realign: shifted data row by +off.
        drow = a.data[d]
        # Build data of the transposed diagonal (-off): dT[j] = data[d, j-off]
        if off >= 0:
            dT = jnp.pad(drow, (off, max(0, n - m - off)))[:n]
        else:
            dT = jnp.pad(drow[-off:], (0, max(0, n - (m + off))))[:n]
        start = pad_lo + (-off)
        y = y + dT * jax.lax.dynamic_slice_in_dim(xp, start, n)
    return y


def to_dense(a):
    if isinstance(a, COO):
        d = jnp.zeros(a.shape, dtype=a.data.dtype)
        return d.at[a.row, a.col].add(a.data)
    if isinstance(a, CSR):
        d = jnp.zeros(a.shape, dtype=a.data.dtype)
        return d.at[a.row_ids, a.indices].add(a.data)
    if isinstance(a, ELL):
        m, n = a.shape
        d = jnp.zeros((m, n), dtype=a.data.dtype)
        rows = jnp.broadcast_to(jnp.arange(m)[:, None], a.cols.shape)
        return d.at[rows, a.cols].add(a.data)
    if isinstance(a, DIA):
        m, n = a.shape
        d = jnp.zeros((m, n), dtype=a.data.dtype)
        for k, off in enumerate(a.offsets):
            i = jnp.arange(m)
            j = i + off
            ok = (j >= 0) & (j < n)
            d = d.at[jnp.where(ok, i, 0), jnp.where(ok, j, 0)].add(
                jnp.where(ok, a.data[k], 0.0))
        return d
    raise TypeError(type(a))
