"""Partition-time gather schedule for sharded general sparsity
(`parallel/gather.py`) on the virtual 8-device CPU mesh.

Replaces the all-gather fallback (SURVEY §7 "halo exchange generality"):
results must match the all-gather path exactly while shipping a
measured, much smaller volume.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pykrylov_tpu.parallel import make_mesh, shard_vector, shard_operator
from pykrylov_tpu.parallel.gather import (GatherEllOperator,
                                          build_gather_schedule)
from pykrylov_tpu.sparse import formats as F
from pykrylov_tpu.sparse.linop import SparseOperator
from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.solvers.cg import cg


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def _dense(vals, rows, cols, shape):
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    return a


def test_jpwh_matvec_matches_and_ships_less(mesh):
    vals, rows, cols, shape = load_bundled("jpwh_991")
    a = _dense(vals, rows, cols, shape)
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=False)
    op = GatherEllOperator(coo, mesh)
    x = np.random.default_rng(0).standard_normal(op.nargin)
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op @ xs)
    ref = a @ x[:shape[1]]
    np.testing.assert_allclose(y[:shape[0]], ref, rtol=1e-12, atol=1e-12)
    assert np.all(y[shape[0]:] == 0)
    # scheduled traffic must be far below the all-gather volume
    assert op.comm_entries_per_matvec < op.allgather_entries_per_matvec
    assert op.comm_entries_per_matvec < 0.5 * op.allgather_entries_per_matvec
    assert op.comm_entries_true <= op.comm_entries_per_matvec


def test_matches_allgather_path(mesh):
    # identical results to the generic sharded-ELL (all-gather) operator
    vals, rows, cols, shape = load_bundled("jpwh_991")
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=False)
    ell = F.ell_from_coo(coo, device=False)
    base = SparseOperator(ell, None, symmetric=False)
    ag_op, pad = shard_operator(
        SparseOperator(ell, F.ell_from_coo(F.transpose_coo(coo),
                                           device=False)), mesh)
    g_op = GatherEllOperator(coo, mesh)
    assert g_op.nargin == ag_op.nargin
    x = np.random.default_rng(1).standard_normal(g_op.nargin)
    xs = shard_vector(jnp.asarray(x), mesh)
    np.testing.assert_allclose(np.asarray(g_op @ xs),
                               np.asarray(ag_op @ xs),
                               rtol=1e-13, atol=1e-13)


def test_banded_schedule_is_neighbor_only(mesh):
    # a banded matrix needs entries only from adjacent shards: all rounds
    # beyond shift 1 and d-1 (wraparound neighbor) must be empty
    n = 512
    rng = np.random.default_rng(2)
    rows = np.repeat(np.arange(n), 3)
    cols = np.clip(rows + rng.integers(-20, 21, size=len(rows)), 0, n - 1)
    vals = rng.standard_normal(len(rows))
    coo = F.coo_from_arrays(vals, rows, cols, (n, n), device=False)
    op = GatherEllOperator(coo, mesh)
    data, colsl, send = op._params
    lens = [s.shape[1] for s in send]
    assert lens[0] > 0          # shift 1 (right neighbor)
    assert all(l == 0 for l in lens[1:-1])
    x = rng.standard_normal(op.nargin)
    xs = shard_vector(jnp.asarray(x), mesh)
    a = _dense(vals, rows, cols, (n, n))
    np.testing.assert_allclose(np.asarray(op @ xs)[:n], a @ x[:n],
                               rtol=1e-12, atol=1e-12)


def test_cg_through_gather_operator(mesh):
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


def test_schedule_skips_dead_padding():
    # ELL padding slots (data == 0) must not create remote requests
    d, L = 4, 8
    cols = np.zeros((d * L, 2), dtype=np.int64)
    data = np.zeros((d * L, 2))
    # one live local entry per row; dead slots point at a remote column
    cols[:, 0] = np.arange(d * L)
    data[:, 0] = 1.0
    cols[:, 1] = 0  # owned by device 0: remote for devices 1..3 if live
    cols_local, send, lens = build_gather_schedule(cols, data, d, L)
    assert all(s.shape[1] == 0 for s in send)
    assert np.all(cols_local[:, 1] == 0)


def test_transpose_matches_dense_oracle(mesh):
    # y = A' x via the REVERSED gather schedule must equal the dense
    # oracle on a general (nonsymmetric) matrix
    vals, rows, cols, shape = load_bundled("jpwh_991")
    a = _dense(vals, rows, cols, shape)
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=False)
    op = GatherEllOperator(coo, mesh)
    x = np.zeros(op.nargout)
    x[:shape[0]] = np.random.default_rng(1).standard_normal(shape[0])
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op.T @ xs)
    np.testing.assert_allclose(y[:shape[1]], a.T @ x[:shape[0]],
                               rtol=1e-12, atol=1e-12)
    assert np.all(y[shape[1]:] == 0)


def test_transpose_of_padded_tail_rows(mesh):
    # a size that does NOT divide the mesh: padded rows are all-zero and
    # must contribute nothing to A' x even when x has junk there
    n = 101
    rng = np.random.default_rng(4)
    a = np.zeros((n, n))
    idx = rng.integers(0, n, size=(400, 2))
    a[idx[:, 0], idx[:, 1]] = rng.standard_normal(400)
    rr, cc = np.nonzero(a)
    coo = F.coo_from_arrays(a[rr, cc], rr, cc, (n, n), device=False)
    op = GatherEllOperator(coo, mesh)
    assert op.pad > 0
    x = rng.standard_normal(op.nargout)  # junk beyond n on purpose
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op.T @ xs)
    np.testing.assert_allclose(y[:n], a.T @ x[:n], rtol=1e-12, atol=1e-12)


def test_lsqr_through_gather_operator(mesh):
    # sharded LSQR on a square general system: needs BOTH products
    # through the schedule (SURVEY §2.5 LLS configs under sharding)
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
    assert np.linalg.norm(a @ x - b[:n]) <= 1e-6 * np.linalg.norm(b)


def test_complex_forward_and_adjoint(mesh):
    # complex general sparsity through the schedule: forward,
    # transpose and ADJOINT (conjugated) products vs the dense oracle
    rng = np.random.default_rng(21)
    n = 160
    nnz = 900
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz) + 1j * rng.standard_normal(nnz)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    rows, cols, vals = rows[first], cols[first], vals[first]
    a = np.zeros((n, n), complex)
    a[rows, cols] = vals
    coo = F.coo_from_arrays(vals, rows, cols, (n, n), device=False)
    op = GatherEllOperator(coo, mesh)
    x = rng.standard_normal(op.nargin) + 1j * rng.standard_normal(op.nargin)
    x[n:] = 0
    xs = shard_vector(jnp.asarray(x), mesh)
    np.testing.assert_allclose(np.asarray(op @ xs)[:n], a @ x[:n],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.T @ xs)[:n], a.T @ x[:n],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.H @ xs)[:n],
                               a.conj().T @ x[:n], rtol=1e-12, atol=1e-12)


def test_rectangular_products_match_dense(mesh):
    # RECTANGULAR general sparsity: rows AND columns blocked over the
    # mesh — the both-sides-large LLS regime TallSkinnyOperator's
    # replicated n-side cannot hold
    rng = np.random.default_rng(7)
    m, n, nnz = 300, 180, 2400
    rows = rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    key = rows * n + cols
    _, first = np.unique(key, return_index=True)
    rows, cols, vals = rows[first], cols[first], vals[first]
    a = _dense(vals, rows, cols, (m, n))
    coo = F.coo_from_arrays(vals, rows, cols, (m, n), device=False)
    op = GatherEllOperator(coo, mesh)
    assert op.nargin == n + op.pad_n and op.nargout == m + op.pad
    x = np.zeros(op.nargin)
    x[:n] = rng.standard_normal(n)
    xs = shard_vector(jnp.asarray(x), mesh)
    y = np.asarray(op @ xs)
    np.testing.assert_allclose(y[:m], a @ x[:n], rtol=1e-12, atol=1e-12)
    assert np.all(y[m:] == 0)
    u = np.zeros(op.nargout)
    u[:m] = rng.standard_normal(m)
    us = shard_vector(jnp.asarray(u), mesh)
    z = np.asarray(op.T @ us)
    np.testing.assert_allclose(z[:n], a.T @ u[:m], rtol=1e-12, atol=1e-12)
    assert np.all(z[n:] == 0)


def test_rectangular_wide_products_match_dense(mesh):
    # wide (m < n): the minimum-norm LSQR regime
    rng = np.random.default_rng(8)
    m, n = 90, 260
    a = np.zeros((m, n))
    idx = rng.integers(0, m, 900), rng.integers(0, n, 900)
    a[idx] = rng.standard_normal(900)
    rr, cc = np.nonzero(a)
    coo = F.coo_from_arrays(a[rr, cc], rr, cc, (m, n), device=False)
    op = GatherEllOperator(coo, mesh)
    x = np.zeros(op.nargin)
    x[:n] = rng.standard_normal(n)
    xs = shard_vector(jnp.asarray(x), mesh)
    np.testing.assert_allclose(np.asarray(op @ xs)[:m], a @ x[:n],
                               rtol=1e-12, atol=1e-12)
    u = np.zeros(op.nargout)
    u[:m] = rng.standard_normal(m)
    us = shard_vector(jnp.asarray(u), mesh)
    np.testing.assert_allclose(np.asarray(op.T @ us)[:n], a.T @ u[:m],
                               rtol=1e-12, atol=1e-12)


def test_lsqr_rectangular_fully_sharded(mesh):
    # fully-sharded rectangular least squares: both b (rows) and x
    # (cols) sharded, no replicated side.  n does NOT divide the mesh so
    # the column padding is exercised (padded x must stay exactly zero).
    # etol=0 disables the energy-norm direct-error stop: its 1e-6
    # default legitimately fires (istop 8) before the 1e-7 comparison
    # below is reachable.
    from pykrylov_tpu.solvers.lsqr import lsqr
    rng = np.random.default_rng(9)
    m, n = 400, 121
    a = np.zeros((m, n))
    # full-rank: dense diagonal band + scattered fill
    for i in range(n):
        a[i * 3 % m, i] = 2.0 + rng.standard_normal()
    idx = rng.integers(0, m, 2000), rng.integers(0, n, 2000)
    a[idx] += 0.1 * rng.standard_normal(2000)
    rr, cc = np.nonzero(a)
    coo = F.coo_from_arrays(a[rr, cc], rr, cc, (m, n), device=False)
    op = GatherEllOperator(coo, mesh)
    assert op.pad_n > 0
    b = rng.standard_normal(m)
    bp = np.zeros(op.nargout)
    bp[:m] = b
    bs = shard_vector(jnp.asarray(bp), mesh)
    res = lsqr(op, bs, atol=1e-12, btol=1e-12, etol=0.0, itnlim=8 * n)
    x = np.asarray(res.x)[:n]
    x_ref = np.linalg.lstsq(a, b, rcond=None)[0]
    np.testing.assert_allclose(x, x_ref, rtol=1e-7, atol=1e-9)
    assert np.all(np.asarray(res.x)[n:] == 0)


def test_gather_ell_compensated_matvec(mesh):
    """Round 5: GatherEllOperator registers a
    compensated (double-f32) matvec — (hi, lo) request slices ride
    stacked ppermute rounds; exactness checked against the f64 oracle
    product of the f32-stored matrix."""
    from pykrylov_tpu.solvers.ffmv import resolve_ff_matvec
    rng = np.random.default_rng(11)
    n = 256
    a = np.zeros((n, n), np.float32)
    a[np.arange(n), np.arange(n)] = 4.0
    idx = rng.integers(0, n, 1500), rng.integers(0, n, 1500)
    a[idx] += 0.3 * rng.standard_normal(1500).astype(np.float32)
    rr, cc = np.nonzero(a)
    coo = F.coo_from_arrays(a[rr, cc], rr, cc, (n, n), device=False)
    op = GatherEllOperator(coo, mesh, symmetric=False)
    ff = resolve_ff_matvec(op)
    assert ff is not None
    x32 = rng.standard_normal(n).astype(np.float32)
    xp = np.zeros(op.nargin, np.float32)
    xp[:n] = x32
    xs = shard_vector(jnp.asarray(xp, jnp.float32), mesh)
    yh, yl = ff(op._params, xs, jnp.zeros_like(xs))
    oracle = a.astype(np.float64) @ x32.astype(np.float64)
    got = (np.asarray(yh, np.float64) + np.asarray(yl, np.float64))[:n]
    err = np.abs(got - oracle).max() / np.abs(oracle).max()
    assert err < 1e-12, err


def test_gather_ell_verified_sharded_cg(mesh):
    """Verified CG over a sharded general-sparsity operator certifies a
    residual far below the plain-f32 matvec floor, matching the f64
    host oracle."""
    from pykrylov_tpu.solvers import cg
    rng = np.random.default_rng(7)
    n = 256
    a = np.zeros((n, n), np.float32)
    idx = rng.integers(0, n, 1200), rng.integers(0, n, 1200)
    a[idx] += 0.05 * rng.standard_normal(1200).astype(np.float32)
    a = a + a.T
    a[np.arange(n), np.arange(n)] = 4.0
    rr, cc = np.nonzero(a)
    coo = F.coo_from_arrays(a[rr, cc], rr, cc, (n, n), device=False)
    op = GatherEllOperator(coo, mesh, symmetric=True)
    ep = np.zeros(op.nargin, np.float32)
    ep[:n] = 1.0
    es = shard_vector(jnp.asarray(ep, jnp.float32), mesh)
    b = op @ es
    res = cg(op, b, rtol=1e-10, atol=0.0, replace_every=10,
             maxiter=4000)
    assert bool(res.converged)
    # certificate vs the f64 host oracle of the f32-stored matrix:
    # the returned x is the f32 rounding of the certified (hi, lo)
    # iterate, so its true residual floors at ~eps_f32 * |A||x| —
    # still ~100x below where the PLAIN f32 recurrence stalls
    x = np.asarray(res.x, np.float64)[:n]
    r64 = np.asarray(b, np.float64)[:n] - a.astype(np.float64) @ x
    rel = np.linalg.norm(r64) / np.linalg.norm(np.asarray(b))
    assert rel < 1e-7, rel
