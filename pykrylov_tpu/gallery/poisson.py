"""Poisson model problems (matrix-free and sparse forms).

JAX-native expansion of the reference gallery
(``/root/reference/pykrylov/gallery/gallery.py:3-29``): the 1-D tridiagonal
(2,-1) stencil and the 2-D 5-point stencil, written as slice/pad expressions
that XLA fuses into a single vectorized pass (no Python loops over grid
lines), plus a 3-D 7-point stencil used for multi-chip weak-scaling runs
(SURVEY §7 stage 7) and COO constructors for the sparse-format tests.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.base import LinearOperator


# ---------------------------------------------------------------------------
# Matrix-free matvecs
# ---------------------------------------------------------------------------


def poisson1d_matvec(x):
    """y = T x with T = tridiag(-1, 2, -1) (``gallery.py:3-8``)."""
    y = 2.0 * x
    y = y.at[:-1].add(-x[1:])
    y = y.at[1:].add(-x[:-1])
    return y


def poisson2d_matvec(x):
    """5-point stencil on an n x n grid, x flattened C-order
    (``gallery.py:10-29``); diagonal 4, off-diagonals -1."""
    n2 = x.shape[0]
    n = int(round(np.sqrt(n2)))
    u = x.reshape(n, n)
    y = 4.0 * u
    y = y.at[:, :-1].add(-u[:, 1:])
    y = y.at[:, 1:].add(-u[:, :-1])
    y = y.at[:-1, :].add(-u[1:, :])
    y = y.at[1:, :].add(-u[:-1, :])
    return y.reshape(n2)


def poisson3d_matvec(x):
    """7-point stencil on an n x n x n grid (diagonal 6)."""
    n3 = x.shape[0]
    n = int(round(n3 ** (1.0 / 3.0)))
    u = x.reshape(n, n, n)
    y = 6.0 * u
    y = y.at[:, :, :-1].add(-u[:, :, 1:])
    y = y.at[:, :, 1:].add(-u[:, :, :-1])
    y = y.at[:, :-1, :].add(-u[:, 1:, :])
    y = y.at[:, 1:, :].add(-u[:, :-1, :])
    y = y.at[:-1, :, :].add(-u[1:, :, :])
    y = y.at[1:, :, :].add(-u[:-1, :, :])
    return y.reshape(n3)


# Reference-style aliases (``gallery.py:3,10``).
Poisson1dMatvec = poisson1d_matvec
Poisson2dMatvec = poisson2d_matvec


# ---------------------------------------------------------------------------
# Operators
# ---------------------------------------------------------------------------


def _p1d_mv(params, x):
    return poisson1d_matvec(x)


def _p2d_mv(params, x):
    return poisson2d_matvec(x)


def _p3d_mv(params, x):
    return poisson3d_matvec(x)


_MODULE_MV = {poisson1d_matvec: _p1d_mv, poisson2d_matvec: _p2d_mv,
              poisson3d_matvec: _p3d_mv}


def _op(n, mv, dtype):
    # Module-level apply functions keep the pytree aux data identical for
    # equal configurations, so jitted solvers don't retrace per instance.
    return LinearOperator(n, n, matvec=_MODULE_MV[mv], params=(),
                          _takes_params=True, symmetric=True, hermitian=True,
                          dtype=np.dtype(dtype))


def poisson1d_operator(n, dtype=jnp.float32):
    return _op(n, poisson1d_matvec, dtype)


def poisson2d_operator(n, dtype=jnp.float32):
    return _op(n * n, poisson2d_matvec, dtype)


def poisson3d_operator(n, dtype=jnp.float32):
    return _op(n * n * n, poisson3d_matvec, dtype)


# ---------------------------------------------------------------------------
# Sparse constructors (host-side numpy; used to build CSR/DIA containers)
# ---------------------------------------------------------------------------


def poisson1d_coo(n, dtype=np.float64):
    i = np.arange(n)
    rows = np.concatenate([i, i[:-1], i[1:]])
    cols = np.concatenate([i, i[1:], i[:-1]])
    vals = np.concatenate([2 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)])
    return vals.astype(dtype), rows, cols, (n, n)


def poisson2d_coo(n, dtype=np.float64):
    idx = np.arange(n * n).reshape(n, n)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [4 * np.ones(n * n)]
    for (sl_r, sl_c) in (((slice(None), slice(None, -1)), (slice(None), slice(1, None))),
                         ((slice(None, -1), slice(None)), (slice(1, None), slice(None)))):
        r = idx[sl_r].ravel(); c = idx[sl_c].ravel()
        rows += [r, c]; cols += [c, r]
        vals += [-np.ones(r.size), -np.ones(r.size)]
    rows = np.concatenate(rows); cols = np.concatenate(cols)
    vals = np.concatenate(vals).astype(dtype)
    return vals, rows, cols, (n * n, n * n)


def poisson3d_coo(n, dtype=np.float64):
    idx = np.arange(n ** 3).reshape(n, n, n)
    rows, cols, vals = [idx.ravel()], [idx.ravel()], [6 * np.ones(n ** 3)]
    slices = [
        ((slice(None), slice(None), slice(None, -1)),
         (slice(None), slice(None), slice(1, None))),
        ((slice(None), slice(None, -1), slice(None)),
         (slice(None), slice(1, None), slice(None))),
        ((slice(None, -1), slice(None), slice(None)),
         (slice(1, None), slice(None), slice(None))),
    ]
    for sl_r, sl_c in slices:
        r = idx[sl_r].ravel(); c = idx[sl_c].ravel()
        rows += [r, c]; cols += [c, r]
        vals += [-np.ones(r.size), -np.ones(r.size)]
    rows = np.concatenate(rows); cols = np.concatenate(cols)
    vals = np.concatenate(vals).astype(dtype)
    return vals, rows, cols, (n ** 3, n ** 3)


def poisson3d_dia(n, dtype=np.float64):
    """The 7-point 3-D Poisson matrix directly in DIA storage (host-side).

    Same matrix as ``dia_from_coo(poisson3d_coo(n))`` without building,
    sorting and scanning ``7 n³`` triples, which dominates set-up at
    card-filling grids.
    """
    from ..sparse.formats import DIA

    m = n ** 3
    k, j, i = np.indices((n, n, n)).reshape(3, m)   # plane, row, column
    offsets = (-n * n, -n, -1, 0, 1, n, n * n)
    live = (k > 0, j > 0, i > 0, None, i < n - 1, j < n - 1, k < n - 1)
    data = np.empty((7, m), dtype=dtype)
    for d, ok in enumerate(live):
        data[d] = 6.0 if ok is None else np.where(ok, -1.0, 0.0)
    return DIA(data, offsets, (m, m))


def poisson_eigenvalue_bounds(n, dim=1):
    """Analytic extreme eigenvalues of the d-D Poisson matrix on an n-grid.

    Used for condition-number-aware test tolerances, mirroring
    ``cg/tests/test_diagdom.py:33-36,69-72``.
    """
    h = np.pi / (2.0 * (n + 1))
    lmin = dim * 4.0 * np.sin(h) ** 2
    lmax = dim * 4.0 * np.cos(h) ** 2
    return lmin, lmax
