"""Generated *general-sparsity* test matrices.

The reference ships two small general matrices (``examples/jpwh_991.mtx``,
``examples/1138bus.mtx``); its SpMV hot path for them is pysparse C
(``/root/reference/pykrylov/linop/linop.py:697-706``).  Benchmarking a
device SpMV needs the same *sparsity class* at HBM-filling sizes, so this
module scales a bundled pattern up by block-diagonal tiling with weak
random coupling between adjacent tiles — per-row degree distribution,
column scatter, and band structure inside each tile are exactly the
original's.

Host-side NumPy only: the triples feed host-side format conversions.
"""

from __future__ import annotations

import numpy as np

__all__ = ["tiled_general_coo"]


def tiled_general_coo(base: str = "jpwh_991", tiles: int = 1024,
                      coupling: int = 4, seed: int = 0,
                      dtype=np.float32):
    """COO triples for a ``tiles``-fold block-diagonal tiling of a bundled
    matrix, with ``coupling`` random entries tying each tile to the next.

    Returns ``(vals, rows, cols, shape)`` NumPy triples: shape is
    ``(tiles*n, tiles*n)`` for an n×n base — e.g. jpwh_991 × 1024 tiles
    → 1,014,784 rows / ~6.18M nnz, the "≥1M-row general matrix" bench
    case of jpwh-class sparsity.
    """
    from ..io.datasets import load_bundled

    bvals, brows, bcols, bshape = load_bundled(base)
    n = bshape[0]
    if bshape[0] != bshape[1]:
        raise ValueError("tiling needs a square base matrix")
    bvals = np.asarray(bvals, dtype=dtype)
    brows = np.asarray(brows, dtype=np.int64)
    bcols = np.asarray(bcols, dtype=np.int64)
    bnnz = len(bvals)

    offs = np.arange(tiles, dtype=np.int64) * n
    rows = (brows[None, :] + offs[:, None]).reshape(-1)
    cols = (bcols[None, :] + offs[:, None]).reshape(-1)
    vals = np.tile(bvals, tiles)

    if coupling and tiles > 1:
        rng = np.random.default_rng(seed)
        nc = coupling * (tiles - 1)
        t = np.repeat(np.arange(tiles - 1, dtype=np.int64), coupling)
        # entries in the last rows of tile t pointing into the first
        # columns of tile t+1, and vice versa — keeps the bandwidth of
        # the tiled matrix at ~n (same class as the base, RCM-free).
        cr = t * n + rng.integers(n - 64, n, size=nc)
        cc = (t + 1) * n + rng.integers(0, 64, size=nc)
        cv = rng.standard_normal(2 * nc).astype(dtype) * float(
            np.abs(bvals).mean())
        rows = np.concatenate([rows, cr, cc])
        cols = np.concatenate([cols, cc, cr])
        vals = np.concatenate([vals, cv])

    return vals, rows, cols, (tiles * n, tiles * n)
