"""MatrixMarket I/O.

The reference delegates all .mtx reading to pysparse C code
(``/root/reference/examples/bmark.py:34``, ``demo_common.py:15``); SURVEY
§2.5 requires an own loader with symmetric expansion.  This is the portable
NumPy implementation (a native C++ fast-path parser lives in ``native/``
and is used automatically when built — see :func:`read_matrix_market`).

Supports the coordinate and array formats with real / integer / complex /
pattern fields and general / symmetric / skew-symmetric / hermitian
qualifiers.  Returns COO triples; symmetric-family storage is expanded to
full explicitly (strictly-off-diagonal entries mirrored), which suits the
device containers where compute formats want the full pattern.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

__all__ = ["MMInfo", "read_matrix_market", "write_matrix_market",
           "mm_to_coo", "read_matrix_market_partitioned"]


@dataclass
class MMInfo:
    shape: tuple
    nnz_stored: int
    fmt: str          # "coordinate" | "array"
    field: str        # "real" | "integer" | "complex" | "pattern"
    symmetry: str     # "general" | "symmetric" | "skew-symmetric" | "hermitian"


def _open(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_matrix_market(path, expand_symmetric=True, dtype=None):
    """Parse a MatrixMarket file.

    Returns ``(vals, rows, cols, shape, info)`` with 0-based indices.
    When ``expand_symmetric`` (default), symmetric / skew-symmetric /
    hermitian storage is expanded to the full pattern.

    Tries the native C++ parser first (10-50x faster on large files) and
    falls back to the pure-NumPy path.
    """
    try:
        from ..native import mm_parse_native
        out = mm_parse_native(path)
    except Exception:
        out = None
    if out is not None:
        vals, rows, cols, shape, field, symmetry = out
        info = MMInfo(shape, len(vals), "coordinate", field, symmetry)
        return _finish(vals, rows, cols, shape, info, expand_symmetric, dtype)

    with _open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file: %s" % path)
        parts = header.strip().split()
        if len(parts) < 5 or parts[1].lower() != "matrix":
            raise ValueError("unsupported MatrixMarket header: %s" % header)
        fmt, field, symmetry = (parts[2].lower(), parts[3].lower(),
                                parts[4].lower())

        # Skip comments.
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        size = line.split()

        if fmt == "coordinate":
            m, n, nnz = int(size[0]), int(size[1]), int(size[2])
            data = np.loadtxt(f, ndmin=2) if nnz else np.zeros((0, 3))
            if data.shape[0] != nnz:
                raise ValueError("expected %d entries, found %d"
                                 % (nnz, data.shape[0]))
            rows = data[:, 0].astype(np.int64) - 1
            cols = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vals = np.ones(nnz, dtype=np.float64)
            elif field == "complex":
                vals = data[:, 2] + 1j * data[:, 3]
            else:
                vals = data[:, 2].astype(np.float64)
        elif fmt == "array":
            m, n = int(size[0]), int(size[1])
            raw = np.loadtxt(f, ndmin=2)
            if field == "complex":
                flat = raw[:, 0] + 1j * raw[:, 1]
            else:
                flat = raw.ravel()
            if symmetry == "general":
                dense = flat.reshape(n, m).T  # column-major storage
                rows, cols = np.nonzero(np.ones((m, n), bool))
                vals = dense[rows, cols]
            else:
                # packed lower triangle, column-major; skew-symmetric
                # array storage omits the (zero) diagonal
                k = -1 if symmetry == "skew-symmetric" else 0
                rows_l, cols_l = np.tril_indices(m, k=k)
                order = np.lexsort((rows_l, cols_l))
                rows, cols = rows_l[order], cols_l[order]
                vals = flat
            nnz = len(vals)
        else:
            raise ValueError("unknown MatrixMarket format %r" % fmt)

    info = MMInfo((m, n), nnz, fmt, field, symmetry)
    return _finish(vals, rows, cols, (m, n), info, expand_symmetric, dtype)


def _finish(vals, rows, cols, shape, info, expand_symmetric, dtype):
    vals = np.asarray(vals)
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    if dtype is not None:
        vals = vals.astype(dtype)
    if expand_symmetric and info.symmetry in ("symmetric", "skew-symmetric",
                                              "hermitian"):
        off = rows != cols
        mr, mc, mv = cols[off], rows[off], vals[off]
        if info.symmetry == "skew-symmetric":
            mv = -mv
        elif info.symmetry == "hermitian":
            mv = np.conj(mv)
        rows = np.concatenate([rows, mr])
        cols = np.concatenate([cols, mc])
        vals = np.concatenate([vals, mv])
    return vals, rows, cols, shape, info


def mm_to_coo(path, dtype=np.float64):
    """Convenience: load a .mtx file as expanded COO triples."""
    vals, rows, cols, shape, _ = read_matrix_market(path, dtype=dtype)
    return vals, rows, cols, shape


def read_matrix_market_partitioned(path, n_parts, keep=None,
                                   chunk_entries=1 << 20,
                                   expand_symmetric=True, dtype=None):
    """Stream-parse a coordinate MatrixMarket file into row-block
    partitions WITHOUT materializing the full COO (SURVEY §2.5
    "host-sharded ingestion"; VERDICT r4 #4).

    The coordinate section is read in ``chunk_entries``-sized chunks;
    each chunk's entries (plus their symmetric-expansion mirrors) are
    routed to the row-block owner ``row // Lrow`` with ``Lrow =
    pad_to_multiple(m, n_parts) // n_parts`` — the SAME partition the
    sharded operators (:mod:`pykrylov_tpu.parallel`) use, so part k is
    exactly shard k's slab.

    ``keep=k`` retains only part ``k`` while streaming and discards the
    rest chunk by chunk: per-process peak memory is one chunk plus the
    kept slab (~nnz/n_parts) — the multi-host ingestion mode, where
    process k calls with ``keep=jax.process_index()``-owned parts.
    ``keep=None`` returns all parts (single-host construction of a
    sharded operator: ship each part to its device).

    Returns ``(parts, shape, info)`` where ``parts`` is a list of
    ``(vals, rows, cols)`` triples with GLOBAL row indices (the single
    kept part when ``keep`` is given).  Entry order within a part is
    file order (mirrors appended per chunk).
    """
    from ..parallel.sharded import pad_to_multiple

    with _open(path) as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file: %s" % path)
        parts_h = header.strip().split()
        fmt, field, symmetry = (parts_h[2].lower(), parts_h[3].lower(),
                                parts_h[4].lower())
        if fmt != "coordinate":
            raise ValueError("partitioned ingestion supports the "
                             "coordinate format only (got %r)" % fmt)
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        size = line.split()
        m, n, nnz = int(size[0]), int(size[1]), int(size[2])
        info = MMInfo((m, n), nnz, fmt, field, symmetry)
        Lrow = pad_to_multiple(m, n_parts) // n_parts

        buckets = [([], [], []) for _ in range(n_parts)]

        def route(vv, rr, cc):
            owner = rr // Lrow
            for k in (range(n_parts) if keep is None else (keep,)):
                sel = owner == k
                if sel.any():
                    bv, br, bc = buckets[k]
                    bv.append(vv[sel])
                    br.append(rr[sel])
                    bc.append(cc[sel])

        remaining = nnz
        ncols_file = 4 if field == "complex" else (
            2 if field == "pattern" else 3)
        while remaining > 0:
            take = min(remaining, int(chunk_entries))
            data = np.loadtxt(f, max_rows=take, ndmin=2)
            if data.shape[0] != take:
                raise ValueError("expected %d more entries, found %d"
                                 % (take, data.shape[0]))
            if data.shape[1] != ncols_file:
                raise ValueError("bad column count %d for field %r"
                                 % (data.shape[1], field))
            rr = data[:, 0].astype(np.int64) - 1
            cc = data[:, 1].astype(np.int64) - 1
            if field == "pattern":
                vv = np.ones(take, dtype=np.float64)
            elif field == "complex":
                vv = data[:, 2] + 1j * data[:, 3]
            else:
                vv = data[:, 2]
            if dtype is not None:
                vv = vv.astype(dtype)
            route(vv, rr, cc)
            if expand_symmetric and symmetry in (
                    "symmetric", "skew-symmetric", "hermitian"):
                off = rr != cc
                mv = vv[off]
                if symmetry == "skew-symmetric":
                    mv = -mv
                elif symmetry == "hermitian":
                    mv = np.conj(mv)
                route(mv, cc[off], rr[off])
            remaining -= take

    def cat(b):
        if not b[0]:
            dt = np.float64 if dtype is None else dtype
            return (np.zeros(0, dt), np.zeros(0, np.int64),
                    np.zeros(0, np.int64))
        return (np.concatenate(b[0]), np.concatenate(b[1]),
                np.concatenate(b[2]))

    if keep is not None:
        return [cat(buckets[keep])], (m, n), info
    return [cat(b) for b in buckets], (m, n), info


def write_matrix_market(path, vals, rows, cols, shape, symmetry="general",
                        comment=None):
    """Write COO triples to a coordinate-format MatrixMarket file."""
    vals = np.asarray(vals)
    field = "complex" if np.iscomplexobj(vals) else "real"
    with open(path, "w") as f:
        f.write("%%%%MatrixMarket matrix coordinate %s %s\n" % (field, symmetry))
        if comment:
            for line in str(comment).splitlines():
                f.write("%% %s\n" % line)
        f.write("%d %d %d\n" % (shape[0], shape[1], len(vals)))
        for v, r, c in zip(vals, rows, cols):
            if field == "complex":
                f.write("%d %d %.16e %.16e\n" % (r + 1, c + 1, v.real, v.imag))
            else:
                f.write("%d %d %.16e\n" % (r + 1, c + 1, v))
