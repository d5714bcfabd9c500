"""Native block-product (SpMM) paths: the matmat protocol on the
operator layer, and block products of the sparse operators.

Reference analogue: the per-RHS loop multi-solve inherits from
``generic/generic.py:79-87``; this redesign amortizes the matrix stream
over the RHS block instead (SURVEY §2.5).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from pykrylov_tpu.sparse import formats as F
from pykrylov_tpu.sparse import SparseOperator
from pykrylov_tpu.ops.base import (LinearOperator, DiagonalOperator,
                                   linop_from_ndarray)


def _rand_coo(rng, m, n, nnz, bw):
    r = rng.integers(0, m, nnz)
    c = np.clip(r * n // m + rng.integers(-bw, bw, nnz), 0, n - 1)
    v = rng.standard_normal(nnz).astype(np.float32)
    d = np.zeros((m, n), np.float32)
    np.add.at(d, (r, c), v)
    return v, r, c, d


def test_cgs_batched_sigma_breakdown_restores_iterate():
    # single-RHS parity: an exact sigma==0 step must restore the
    # pre-step iterate instead of committing a rho/_safe(0) garbage
    # update (round-3 review finding)
    from pykrylov_tpu.solvers.batched import cgs_batched
    # r0' A r0 == 0 at the first step: antisymmetric-ish construction
    a = np.array([[0.0, 1.0], [-1.0, 0.0]], np.float32)
    op = linop_from_ndarray(jnp.asarray(a))
    B = jnp.asarray(np.array([[1.0, 1.0], [0.0, 2.0]], np.float32))
    res = cgs_batched(op, B, rtol=1e-10)
    # column 0: r0 = [1, 0], A r0 = [0,-1], sigma = 0 -> breakdown with
    # x kept at the initial iterate (zeros)
    assert int(res.istop[0]) == 3
    assert float(jnp.abs(res.x[:, 0]).max()) == 0.0
    assert np.isfinite(float(res.resid_norm[0]))


def test_dia_matmat_matches_dense():
    rng = np.random.default_rng(7)
    m = 1024
    offsets = (-128, -3, 0, 2, 130)
    d = np.zeros((m, m), np.float32)
    for off in offsets:
        i = np.arange(max(0, -off), min(m, m - off))
        d[i, i + off] = rng.standard_normal(len(i)).astype(np.float32)
    rr, cc = np.nonzero(d)
    dia = F.dia_from_coo(F.coo_from_arrays(d[rr, cc], rr, cc, (m, m),
                                           device=False))
    op = SparseOperator(dia)
    K = 3
    X = rng.standard_normal((m, K)).astype(np.float32)
    Y = np.asarray(op @ jnp.asarray(X))
    np.testing.assert_allclose(Y, d @ X, rtol=1e-4, atol=1e-4)


def test_dia_operator_block_product():
    rng = np.random.default_rng(8)
    m = 640
    offsets = (-2, 0, 5)
    data = rng.standard_normal((len(offsets), m)).astype(np.float32)
    dia = F.DIA(jnp.asarray(data), offsets, (m, m))
    dia_t = F.dia_from_coo(F.transpose_coo(F.coo_from_arrays(
        *_dia_triples(data, offsets, m), (m, m), device=False)))
    op = SparseOperator(dia, dia_t)
    X = rng.standard_normal((op.nargin, 4)).astype(np.float32)
    Y2 = np.asarray(op @ jnp.asarray(X))
    cols = np.stack([np.asarray(op @ jnp.asarray(X[:, k]))
                     for k in range(4)], axis=1)
    np.testing.assert_allclose(Y2, cols, rtol=1e-5, atol=1e-5)
    YT = np.asarray(op.T @ jnp.asarray(X))
    colsT = np.stack([np.asarray(op.T @ jnp.asarray(X[:, k]))
                      for k in range(4)], axis=1)
    np.testing.assert_allclose(YT, colsT, rtol=1e-5, atol=1e-5)


def _dia_triples(data, offsets, m):
    """COO triples of a square DIA matrix (slots past the edge dropped)."""
    vals, rows, cols = [], [], []
    for k, off in enumerate(offsets):
        i = np.arange(max(0, -off), min(m, m - off))
        vals.append(data[k, i])
        rows.append(i)
        cols.append(i + off)
    return np.concatenate(vals), np.concatenate(rows), np.concatenate(cols)


def test_matmat_propagates_through_algebra():
    rng = np.random.default_rng(9)
    n = 96
    a = rng.standard_normal((n, n)).astype(np.float32)
    A = linop_from_ndarray(a)
    D = DiagonalOperator(jnp.arange(1, n + 1, dtype=jnp.float32))
    dd = np.diag(np.arange(1, n + 1, dtype=np.float32))
    C = (2.0 * A + D) @ A.T
    cd = (2.0 * a + dd) @ a.T
    assert C._mm is not None
    X = rng.standard_normal((n, 3)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(C @ jnp.asarray(X)), cd @ X,
                               rtol=2e-4, atol=2e-4)
    P = A ** 2
    np.testing.assert_allclose(np.asarray(P @ jnp.asarray(X)),
                               a @ (a @ X), rtol=2e-3, atol=2e-3)


def test_matmat_kwarg_plain_closure():
    n = 17
    Aop = LinearOperator(n, n, matvec=lambda x: 2.0 * x,
                         matmat=lambda X: 2.0 * X, symmetric=True)
    X = jnp.ones((n, 3), jnp.float32)
    assert Aop._mm is not None and Aop._rmm is Aop._mm
    np.testing.assert_allclose(np.asarray(Aop @ X), 2.0 * np.ones((n, 3)))


def test_batched_cg_uses_block_product():
    # cg_batched over a DIA sparse operator: one block product per
    # iteration for all K columns
    from pykrylov_tpu.solvers.batched import cg_batched
    m = 512
    rng = np.random.default_rng(11)
    main = 4.0 + rng.random(m).astype(np.float32)
    off = -np.ones(m, np.float32)
    data = np.stack([off, main, off])
    data[0, 0] = data[2, -1] = 0.0      # slots past the edge
    dia = F.DIA(jnp.asarray(data), (-1, 0, 1), (m, m))
    op = SparseOperator(dia, symmetric=True)
    d = np.zeros((m, m), np.float32)
    d[np.arange(m), np.arange(m)] = main
    d[np.arange(1, m), np.arange(m - 1)] = -1
    d[np.arange(m - 1), np.arange(1, m)] = -1
    K = 4
    Xs = rng.standard_normal((m, K)).astype(np.float32)
    B = jnp.asarray(d @ Xs)
    res = cg_batched(op, B, rtol=1e-6)
    assert bool(res.converged.all())
    err = np.abs(np.asarray(res.x) - Xs).max()
    assert err < 1e-3, err
