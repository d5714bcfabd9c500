"""Row-sharded general-sparsity operator (``GatherEllOperator``) on the
virtual 8-device CPU mesh: the partition-time ppermute schedule (SURVEY §7
"halo exchange generality") with XLA ELL local compute, checked product by
product, through the transpose's reversed schedule, with uneven padding,
and through the solvers that run on it.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pykrylov_tpu.parallel import make_mesh, shard_vector, GatherEllOperator
from pykrylov_tpu.sparse import formats as F
from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.solvers.cg import cg


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _dense(vals, rows, cols, shape):
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    return a


def _banded(n, bw, seed, per_row=6):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=len(rows)),
                   0, n - 1)
    vals = rng.standard_normal(len(rows))
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    return rows[first], cols[first], vals[first]


def test_matches_dense_and_schedule_accounting(mesh):
    n = 3000
    rows, cols, vals = _banded(n, 300, 5)
    a = _dense(vals, rows, cols, (n, n))
    coo = F.coo_from_arrays(vals, rows, cols, (n, n), device=False)
    op = GatherEllOperator(coo, mesh)
    x = np.random.default_rng(6).standard_normal(op.nargin)
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op @ xs)
    np.testing.assert_allclose(y[:n], a @ x[:n], rtol=1e-11, atol=1e-11)
    assert np.all(y[n:] == 0)
    # the schedule ships fewer entries than an all-gather of x
    assert op.comm_entries_true <= op.comm_entries_per_matvec
    assert op.comm_entries_per_matvec < op.allgather_entries_per_matvec
    # output stays sharded over the full mesh
    out = jax.jit(lambda p, v: op._mv(p, v))(op._params, xs)
    assert len(out.sharding.device_set) == 8


def test_jpwh_bundled(mesh):
    vals, rows, cols, shape = load_bundled("jpwh_991")
    a = _dense(vals, rows, cols, shape)
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=False)
    op = GatherEllOperator(coo, mesh)
    x = np.random.default_rng(7).standard_normal(op.nargin)
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op @ xs)
    np.testing.assert_allclose(y[:shape[0]], a @ x[:shape[1]],
                               rtol=1e-11, atol=1e-11)


def test_cg_through_sharded_ell(mesh):
    n = 600
    rng = np.random.default_rng(3)
    a = np.zeros((n, n))
    for off in (-7, -1, 0, 1, 7):
        a += np.diag(rng.standard_normal(n - abs(off)) * 0.1, off)
    a = a @ a.T + np.eye(n) * 4
    rr, cc = np.nonzero(a)
    coo = F.coo_from_arrays(a[rr, cc], rr, cc, (n, n), device=False)
    op = GatherEllOperator(coo, mesh, symmetric=True)
    b = np.zeros(op.nargin)
    b[:n] = rng.standard_normal(n)
    bs = shard_vector(jnp.asarray(b), mesh)
    res = cg(op, bs, rtol=1e-10, atol=0.0, maxiter=4 * n)
    x = np.asarray(res.x)[:n]
    assert np.linalg.norm(a @ x - b[:n]) <= 1e-8 * np.linalg.norm(b)


def test_uneven_rows_pad(mesh):
    # n not divisible by d: rows pad to the mesh multiple, padded rows
    # produce zeros
    n = 1003
    rows, cols, vals = _banded(n, 60, 9, per_row=4)
    a = _dense(vals, rows, cols, (n, n))
    coo = F.coo_from_arrays(vals, rows, cols, (n, n), device=False)
    op = GatherEllOperator(coo, mesh)
    assert op.pad == op.shape[0] - n
    x = np.random.default_rng(10).standard_normal(op.nargin)
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op @ xs)
    np.testing.assert_allclose(y[:n], a @ x[:n], rtol=1e-11, atol=1e-11)
    assert np.all(y[n:] == 0)


def test_transpose_matches_dense_oracle(mesh):
    # reversed-schedule A' x
    vals, rows, cols, shape = load_bundled("jpwh_991")
    a = _dense(vals, rows, cols, shape)
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=False)
    op = GatherEllOperator(coo, mesh)
    rng = np.random.default_rng(7)
    x = np.zeros(op.nargout)
    x[:shape[0]] = rng.standard_normal(shape[0])
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op.T @ xs)
    np.testing.assert_allclose(y[:shape[1]], a.T @ x[:shape[0]],
                               rtol=1e-10, atol=1e-10)
    # forward still intact
    yf = np.asarray(op @ xs)
    np.testing.assert_allclose(yf[:shape[0]], a @ x[:shape[0]],
                               rtol=1e-10, atol=1e-10)


def test_transpose_banded_uneven(mesh):
    n = 1001  # does not divide the 8-device mesh
    rows, cols, vals = _banded(n, 60, 11)
    a = _dense(vals, rows, cols, (n, n))
    coo = F.coo_from_arrays(vals, rows, cols, (n, n), device=False)
    op = GatherEllOperator(coo, mesh)
    rng = np.random.default_rng(12)
    x = np.zeros(op.nargout)
    x[:n] = rng.standard_normal(n)
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op.T @ xs)
    np.testing.assert_allclose(y[:n], a.T @ x[:n], rtol=1e-10,
                               atol=1e-10)


def test_lsqr_through_sharded_ell(mesh):
    from pykrylov_tpu.solvers.lsqr import lsqr
    vals, rows, cols, shape = load_bundled("jpwh_991")
    a = _dense(vals, rows, cols, shape)
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=False)
    op = GatherEllOperator(coo, mesh)
    n = shape[0]
    b = np.zeros(op.nargin)
    b[:n] = a @ np.ones(n)
    bs = shard_vector(jnp.asarray(b), mesh)
    res = lsqr(op, bs, atol=1e-10, btol=1e-10, itnlim=4 * n)
    x = np.asarray(res.x)[:n]
    assert np.linalg.norm(a @ x - b[:n]) <= 2e-6 * np.linalg.norm(b)


def test_symmetric_rectangular_raises(mesh):
    coo = F.coo_from_arrays(np.ones(3), np.arange(3), np.arange(3),
                            (5, 3), device=False)
    with pytest.raises(ValueError, match="square"):
        GatherEllOperator(coo, mesh, symmetric=True)


def test_rectangular_products_and_lsmr(mesh):
    # rectangular container: forward + reversed-schedule transpose vs the
    # dense oracle, then a fully sharded LSMR solve (both sides sharded,
    # no replicated n-side)
    from pykrylov_tpu.solvers.lsmr import lsmr
    rng = np.random.default_rng(31)
    m, n = 280, 104
    a = np.zeros((m, n))
    for i in range(n):
        a[(i * 5 + 2) % m, i] = 3.0 + rng.standard_normal()
    idx = rng.integers(0, m, 1500), rng.integers(0, n, 1500)
    a[idx] += 0.1 * rng.standard_normal(1500)
    rr, cc = np.nonzero(a)
    coo = F.coo_from_arrays(a[rr, cc], rr, cc, (m, n), device=False)
    op = GatherEllOperator(coo, mesh)
    assert op.nargin == n + op.pad_n and op.nargout == m + op.pad
    x = np.zeros(op.nargin)
    x[:n] = rng.standard_normal(n)
    xs = shard_vector(jnp.asarray(x), mesh)
    np.testing.assert_allclose(np.asarray(op @ xs)[:m], a @ x[:n],
                               rtol=1e-10, atol=1e-10)
    u = np.zeros(op.nargout)
    u[:m] = rng.standard_normal(m)
    us = shard_vector(jnp.asarray(u), mesh)
    np.testing.assert_allclose(np.asarray(op.T @ us)[:n], a.T @ u[:m],
                               rtol=1e-10, atol=1e-10)
    b = rng.standard_normal(m)
    bp = np.zeros(op.nargout)
    bp[:m] = b
    bs = shard_vector(jnp.asarray(bp), mesh)
    res = lsmr(op, bs, atol=1e-10, btol=1e-10, itnlim=8 * n)
    x_ref = np.linalg.lstsq(a, b, rcond=None)[0]
    # LSMR stops on |A'r| <= atol |A| |r|, which bounds the error only
    # through the condition number: the same bound as the f32 test had
    np.testing.assert_allclose(np.asarray(res.x)[:n], x_ref, rtol=2e-3,
                               atol=5e-5)


def test_block_product_matches_columns():
    # matmat protocol on the scheduled-gather operator: forward and
    # transpose block products == per-column matvecs
    mesh = make_mesh(4)
    rng = np.random.default_rng(9)
    m = n = 600
    nnz = 4000
    r = rng.integers(0, m, nnz)
    c = np.clip(r + rng.integers(-80, 80, nnz), 0, n - 1)
    v = rng.standard_normal(nnz).astype(np.float32)
    coo = F.coo_from_arrays(v, r, c, (m, n), device=False)
    op = GatherEllOperator(coo, mesh)
    K = 3
    X = rng.standard_normal((op.nargin, K)).astype(np.float32)
    Y = np.asarray(op @ jnp.asarray(X))
    colsv = np.stack([np.asarray(op @ jnp.asarray(X[:, j]))
                      for j in range(K)], axis=1)
    np.testing.assert_allclose(Y, colsv, rtol=2e-5, atol=2e-5)
    U = rng.standard_normal((op.nargout, K)).astype(np.float32)
    YT = np.asarray(op.T @ jnp.asarray(U))
    colsT = np.stack([np.asarray(op.T @ jnp.asarray(U[:, j]))
                      for j in range(K)], axis=1)
    np.testing.assert_allclose(YT, colsT, rtol=2e-5, atol=2e-5)


def test_verified_cg_certificate(mesh):
    """The operator registers a compensated (double-f32) matvec, so a
    verified CG certifies its f32 solve below the plain-f32 floor
    against the f64 host oracle."""
    from pykrylov_tpu.solvers.ffmv import resolve_ff_matvec
    rng = np.random.default_rng(23)
    n = 128 * 8
    rows = np.repeat(np.arange(n), 4)
    offs = rng.integers(1, 30, len(rows)) * rng.choice([-1, 1], len(rows))
    cols = (rows + offs) % n
    vals = 0.1 * rng.standard_normal(len(rows)).astype(np.float32)
    rows = np.concatenate([rows, cols, np.arange(n)])
    cols2 = np.concatenate([cols, rows[:len(cols)], np.arange(n)])
    vals = np.concatenate([vals, vals, np.full(n, 4.0, np.float32)])
    key = rows * n + cols2
    _, first = np.unique(key, return_index=True)
    coo = F.coo_from_arrays(vals[first], rows[first], cols2[first],
                            (n, n), device=False)
    op = GatherEllOperator(coo, mesh, symmetric=True)
    ff = resolve_ff_matvec(op)
    assert ff is not None
    dense = np.zeros((n, n))
    np.add.at(dense, (rows[first], cols2[first]),
              vals[first].astype(np.float64))
    x32 = rng.standard_normal(n).astype(np.float32)
    xs = shard_vector(jnp.asarray(x32, jnp.float32), mesh)
    yh, yl = ff(op._params, xs, jnp.zeros_like(xs))
    oracle = dense @ x32.astype(np.float64)
    got = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    assert np.abs(got - oracle).max() / np.abs(oracle).max() < 1e-12
    b = op @ shard_vector(jnp.ones(n, jnp.float32), mesh)
    res = cg(op, b, rtol=1e-10, atol=0.0, replace_every=10,
             maxiter=4 * n)
    assert bool(res.converged)
    r64 = (np.asarray(b, np.float64)
           - dense @ np.asarray(res.x, np.float64))
    assert np.linalg.norm(r64) / np.linalg.norm(np.asarray(b)) < 1e-7
