"""Multi-RHS solves (`solvers/batched.py`): each column of the block-
batched CG must meet the same stopping contract as a single-RHS `cg` run
and agree with it to the accuracy that contract implies (the block
product sums in a different order than the single dot, so trajectories
drift at rounding level and stopping iterations can shift)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pykrylov_tpu.ops import DiagonalOperator, linop_from_ndarray
from pykrylov_tpu.solvers import cg, cg_batched, minres, solve_columns


def _spd(n=120, cond=1e3, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.logspace(0, np.log10(cond), n)
    return (Q * lam) @ Q.T


def test_columns_match_single_cg():
    a = _spd()
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    rng = np.random.default_rng(1)
    B = rng.standard_normal((120, 5))
    # column scaling spreads convergence speeds so freeze masking is hit
    B[:, 0] *= 1e3
    B[:, 3] = a @ np.ones(120)
    res = cg_batched(op, jnp.asarray(B), rtol=1e-8, store_history=True)
    assert res.x.shape == (120, 5)
    for j in range(5):
        single = cg(op, jnp.asarray(B[:, j]), rtol=1e-8)
        # the block product's reduction order differs bitwise from the
        # single dot.  At cond 1e3 CG runs past n iterations on lost
        # orthogonality, where rounding moves the stopping iteration by
        # several, so the counts are not compared; what must hold is:
        assert bool(res.converged[j]) == bool(single.converged)
        # stopping contract on the TRUE residuals: both answers meet the
        # rtol threshold (the f64 gap between recursive and true residual
        # is ~eps*cond = 1e-13 relative, far inside the 1% margin)
        bj = B[:, j]
        thr = 1e-8 * np.linalg.norm(bj)
        xb, xs = np.asarray(res.x[:, j]), np.asarray(single.x)
        rb = np.linalg.norm(bj - a @ xb)
        rs = np.linalg.norm(bj - a @ xs)
        assert rb <= 1.01 * thr and rs <= 1.01 * thr, (j, rb, rs, thr)
        # accuracy: xb - xs = A^-1 (rs_vec - rb_vec), and lambda_min(A)
        # is 1 by construction, so |xb - xs| <= rb + rs whatever the
        # two trajectories were (plus rounding of the f64 residuals)
        assert (np.linalg.norm(xb - xs)
                <= (rb + rs) * (1 + 1e-6) + 1e-12 * np.linalg.norm(xs)), j
        # the exact sub-threshold landing value is run-dependent; the
        # contract is the stopping rule itself
        assert (float(res.resid_norm[j])
                <= max(1e-8, 1e-8 * float(res.resid_norm0[j])) * (1 + 1e-12))
    # block iterations = max column iterations
    assert int(res.n_iter) == int(res.info["n_iter_columns"].max())
    # history: NaN beyond each column's own stop
    h = np.asarray(res.resid_history)
    done_early = int(res.info["n_iter_columns"].min())
    assert np.isnan(h[int(res.n_iter), np.argmin(res.info["n_iter_columns"])]) \
        or done_early == int(res.n_iter)


def test_preconditioned_columns_match():
    a = _spd(n=80, cond=1e5, seed=3)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    M = DiagonalOperator(jnp.asarray(1.0 / np.diag(a)))
    rng = np.random.default_rng(4)
    B = rng.standard_normal((80, 3))
    res = cg_batched(op, jnp.asarray(B), M=M, rtol=1e-8, maxiter=2000)
    for j in range(3):
        single = cg(op, jnp.asarray(B[:, j]), M=M, rtol=1e-8, maxiter=2000)
        assert bool(res.converged[j]) and bool(single.converged)
        # high-kappa CG iteration counts are rounding-path sensitive:
        # ~470-iteration runs drift by ~10 between summation orders
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(single.n_iter)) <= 0.1 * int(single.n_iter)
        # at cond 1e5 any solution meeting the stopping rule may differ
        # from another by O(kappa * rtol); pin both to the oracle within
        # that bound instead of to each other
        x_ref = np.linalg.solve(a, B[:, j])
        nrm = np.linalg.norm(x_ref)
        assert np.linalg.norm(np.asarray(res.x[:, j]) - x_ref) < 5e-3 * nrm
        assert np.linalg.norm(np.asarray(single.x) - x_ref) < 5e-3 * nrm


def test_curvature_flags_per_column():
    # indefinite operator: columns abort with istop 2 and report
    # definite=False, exactly like single cg's curvature check
    n = 40
    d = np.ones(n)
    d[-1] = -1.0
    op = DiagonalOperator(jnp.asarray(d))
    rng = np.random.default_rng(5)
    B = rng.standard_normal((n, 2))
    res = cg_batched(op, jnp.asarray(B), check_curvature=True, rtol=1e-10)
    for j in range(2):
        single = cg(op, jnp.asarray(B[:, j]), check_curvature=True,
                    rtol=1e-10)
        assert int(res.istop[j]) == int(single.istop)
        assert bool(res.info["definite"][j]) == bool(single.info["definite"])
        assert int(res.info["n_iter_columns"][j]) == int(single.n_iter)


def test_single_column_rhs_promotes():
    a = _spd(n=30, cond=10, seed=6)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    b = np.random.default_rng(7).standard_normal(30)
    res = cg_batched(op, jnp.asarray(b))
    assert res.x.shape == (30, 1)
    assert bool(res.converged[0])


def test_trivial_rhs_column_converges_at_zero_iters():
    a = _spd(n=30, cond=10, seed=8)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    B = np.zeros((30, 2))
    B[:, 1] = a @ np.ones(30)
    res = cg_batched(op, jnp.asarray(B), rtol=1e-8)
    assert int(res.info["n_iter_columns"][0]) == 0
    assert bool(res.converged[0])
    np.testing.assert_allclose(np.asarray(res.x[:, 1]), np.ones(30),
                               rtol=1e-7)


def test_shape_errors():
    from pykrylov_tpu.ops.base import ShapeError
    a = _spd(n=20, cond=10, seed=9)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    with pytest.raises(ShapeError):
        cg_batched(op, jnp.ones((19, 2)))
    rect = linop_from_ndarray(jnp.ones((10, 20)))
    with pytest.raises(ShapeError):
        cg_batched(rect, jnp.ones((20, 2)))


def test_solve_columns_generic_driver():
    a = _spd(n=50, cond=100, seed=10)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    rng = np.random.default_rng(11)
    B = rng.standard_normal((50, 3))
    results = solve_columns(minres, op, jnp.asarray(B), rtol=1e-8)
    assert len(results) == 3
    for j, r in enumerate(results):
        single = minres(op, jnp.asarray(B[:, j]), rtol=1e-8)
        assert int(r.n_iter) == int(single.n_iter)
        np.testing.assert_allclose(np.asarray(r.x), np.asarray(single.x))


# ---------------------------------------------------------------------------
# lsqr_batched
# ---------------------------------------------------------------------------

def _rect(m=150, n=60, cond=1e2, seed=0):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.logspace(0, np.log10(cond), n)
    return (U * s) @ V.T


def test_lsqr_columns_match_single():
    from pykrylov_tpu.solvers import lsqr, lsqr_batched
    a = _rect()
    op = linop_from_ndarray(jnp.asarray(a))
    rng = np.random.default_rng(1)
    B = rng.standard_normal((150, 4))
    B[:, 2] = a @ np.ones(60)        # consistent column
    # etol=0: the default direct-error stop would end runs at ~1e-5
    # accuracy and mask the atol-driven comparison
    res = lsqr_batched(op, jnp.asarray(B), atol=1e-10, btol=1e-10,
                       etol=0.0)
    assert res.x.shape == (60, 4)
    for j in range(4):
        single = lsqr(op, jnp.asarray(B[:, j]), atol=1e-10, btol=1e-10,
                      etol=0.0)
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(single.n_iter)) <= 5, j
        assert int(res.istop[j]) == int(single.istop), j
        assert bool(res.converged[j]) == bool(single.converged)
        x_ref = np.linalg.lstsq(a, B[:, j], rcond=None)[0]
        nrm = np.linalg.norm(x_ref)
        assert np.linalg.norm(np.asarray(res.x[:, j]) - x_ref) < 1e-6 * nrm
    assert int(res.n_iter) == int(res.info["n_iter_columns"].max())


def test_lsqr_batched_damped():
    from pykrylov_tpu.solvers import lsqr, lsqr_batched
    a = _rect(m=100, n=40, cond=50, seed=2)
    op = linop_from_ndarray(jnp.asarray(a))
    rng = np.random.default_rng(3)
    B = rng.standard_normal((100, 3))
    damp = 0.7
    res = lsqr_batched(op, jnp.asarray(B), damp=damp, atol=1e-10,
                       btol=1e-10, etol=0.0)
    # oracle: Tikhonov normal equations
    H = a.T @ a + damp**2 * np.eye(40)
    for j in range(3):
        x_ref = np.linalg.solve(H, a.T @ B[:, j])
        nrm = np.linalg.norm(x_ref)
        assert np.linalg.norm(np.asarray(res.x[:, j]) - x_ref) < 1e-7 * nrm
        single = lsqr(op, jnp.asarray(B[:, j]), damp=damp, atol=1e-10,
                      btol=1e-10, etol=0.0)
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(single.n_iter)) <= 5


def test_lsqr_batched_zero_column_is_istop0():
    from pykrylov_tpu.solvers import lsqr_batched
    a = _rect(m=80, n=30, cond=10, seed=4)
    op = linop_from_ndarray(jnp.asarray(a))
    B = np.zeros((80, 2))
    B[:, 1] = np.random.default_rng(5).standard_normal(80)
    res = lsqr_batched(op, jnp.asarray(B), atol=1e-10, btol=1e-10)
    assert int(res.istop[0]) == 0 and bool(res.converged[0])
    assert int(res.info["n_iter_columns"][0]) == 0
    np.testing.assert_array_equal(np.asarray(res.x[:, 0]), np.zeros(30))


def test_lsqr_batched_preconditioned_sqd():
    # M/N inner preconditioners (the SQD configuration) batch too
    from pykrylov_tpu.solvers import lsqr, lsqr_batched
    a = _rect(m=90, n=35, cond=30, seed=6)
    op = linop_from_ndarray(jnp.asarray(a))
    M = DiagonalOperator(jnp.asarray(np.full(90, 0.5)))
    N = DiagonalOperator(jnp.asarray(np.full(35, 2.0)))
    rng = np.random.default_rng(7)
    B = rng.standard_normal((90, 2))
    res = lsqr_batched(op, jnp.asarray(B), M=M, N=N, atol=1e-9, btol=1e-9)
    for j in range(2):
        single = lsqr(op, jnp.asarray(B[:, j]), M=M, N=N, atol=1e-9,
                      btol=1e-9)
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(single.n_iter)) <= 3
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(single.x),
                                   rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# batched solvers over sharded operators (vmap composes with shard_map)
# ---------------------------------------------------------------------------

def test_cg_batched_over_sharded_halo_operator():
    from pykrylov_tpu.parallel import make_mesh, HaloDiaOperator
    from pykrylov_tpu.gallery.poisson import poisson3d_coo
    from pykrylov_tpu.sparse import formats as F
    mesh = make_mesh(8)
    vals, rows, cols, shape = poisson3d_coo(12, dtype=np.float32)
    dia = F.dia_from_coo(F.COO(vals, rows.astype(np.int32),
                               cols.astype(np.int32), shape), device=False)
    op = HaloDiaOperator(dia, mesh)
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    B = np.random.default_rng(0).standard_normal(
        (shape[0], 3)).astype(np.float32)
    res = cg_batched(op, jnp.asarray(B), rtol=1e-5)
    assert bool(res.converged.all())
    for j in range(3):
        x = np.asarray(res.x[:, j], np.float64)
        assert (np.linalg.norm(a @ x - B[:, j])
                < 1e-4 * np.linalg.norm(B[:, j]) + 1e-3)


def test_lsqr_batched_over_gather_schedule_operator():
    from pykrylov_tpu.parallel import make_mesh, GatherEllOperator
    from pykrylov_tpu.sparse import formats as F
    from pykrylov_tpu.solvers import lsqr_batched
    mesh = make_mesh(8)
    rng = np.random.default_rng(0)
    m = 264
    a = np.zeros((m, m), np.float32)
    idx = rng.integers(0, m, (2000, 2))
    a[idx[:, 0], idx[:, 1]] = rng.standard_normal(len(idx)).astype(np.float32)
    a += m * np.eye(m, dtype=np.float32)
    rr, cc = np.nonzero(a)
    op = GatherEllOperator(F.coo_from_arrays(a[rr, cc], rr, cc, (m, m),
                                             device=False), mesh)
    B = rng.standard_normal((m, 2)).astype(np.float32)
    res = lsqr_batched(op, jnp.asarray(B), atol=1e-6, btol=1e-6)
    for j in range(2):
        x = np.asarray(res.x[:, j], np.float64)
        assert (np.linalg.norm(a @ x - B[:, j])
                < 1e-5 * np.linalg.norm(B[:, j]))


def test_lsqr_batched_promotes_preconditioner_dtype():
    # CONFIRMED review repro: a float64 preconditioner on a float32
    # system must promote the carry (single lsqr does via promote_rhs);
    # previously this raised a while_loop carry dtype TypeError
    from pykrylov_tpu.solvers import lsqr_batched
    a = _rect(m=80, n=30, cond=10, seed=12).astype(np.float32)
    op = linop_from_ndarray(jnp.asarray(a))
    M = DiagonalOperator(jnp.asarray(np.ones(80, np.float64)))
    B = np.random.default_rng(13).standard_normal((80, 2)).astype(np.float32)
    res = lsqr_batched(op, jnp.asarray(B), M=M, atol=1e-8, btol=1e-8)
    assert res.x.dtype == jnp.float64
    assert bool(res.converged.all())


def test_batched_x0_layout_mistake_raises():
    from pykrylov_tpu.ops.base import ShapeError
    a = _spd(n=30, cond=10, seed=14)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    B = np.random.default_rng(15).standard_normal((30, 3))
    with pytest.raises(ShapeError):
        # (K, n) row-major guesses: size matches, layout wrong — must
        # raise instead of silently reshaping
        cg_batched(op, jnp.asarray(B), x0=jnp.ones((3, 30)))
    res = cg_batched(op, jnp.asarray(B), x0=jnp.zeros((30, 3)))
    assert bool(res.converged.all())


# ---------------------------------------------------------------------------
# bicgstab_batched / tfqmr_batched
# ---------------------------------------------------------------------------

def _jpwh_op():
    from pykrylov_tpu.io.datasets import load_bundled
    from pykrylov_tpu.sparse import sparse_operator
    vals, rows, cols, shape = load_bundled("jpwh_991")
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), vals)
    op = sparse_operator((vals, rows, cols, shape))
    return op, a64


@pytest.mark.parametrize("name", ["bicgstab", "cgs", "tfqmr"])
def test_transpose_free_batched_matches_single_on_jpwh(name):
    # VERDICT r2 #5 done-bar: per-column matvec counts within 1-2 of
    # single-RHS calls on jpwh_991 (the reference bmark trio protocol:
    # rtol 1e-8, guess = 1 + arange(n), matvec_max = 2n).
    from pykrylov_tpu.solvers import (bicgstab, cgs, tfqmr,
                                      bicgstab_batched, cgs_batched,
                                      tfqmr_batched)
    single = {"bicgstab": bicgstab, "cgs": cgs, "tfqmr": tfqmr}[name]
    batched = {"bicgstab": bicgstab_batched, "cgs": cgs_batched,
               "tfqmr": tfqmr_batched}[name]
    op, a64 = _jpwh_op()
    n = a64.shape[0]
    e = np.ones(n)
    rng = np.random.default_rng(7)
    B = np.stack([a64 @ e, a64 @ rng.standard_normal(n),
                  rng.standard_normal(n)], axis=1)
    x0 = np.tile(1.0 + np.arange(n, dtype=np.float64)[:, None], (1, 3))
    res = batched(op, jnp.asarray(B), x0=jnp.asarray(x0), rtol=1e-8,
                  matvec_max=2 * n, store_history=True)
    assert res.x.shape == (n, 3)
    for j in range(3):
        sj = single(op, jnp.asarray(B[:, j]),
                    x0=jnp.asarray(x0[:, j]), rtol=1e-8, matvec_max=2 * n)
        assert bool(res.converged[j]) == bool(sj.converged), (name, j)
        assert abs(int(res.info["n_matvec_columns"][j])
                   - int(sj.n_matvec)) <= 2, (name, j)
        # both satisfy the same stopping rule; compare true residuals
        rj = np.linalg.norm(B[:, j] - a64 @ np.asarray(res.x[:, j]))
        rs = np.linalg.norm(B[:, j] - a64 @ np.asarray(sj.x))
        assert rj <= 10 * max(rs, 1e-10), (name, j, rj, rs)
    assert int(res.n_matvec) == int(res.info["n_matvec_columns"].max())


@pytest.mark.parametrize("name", ["bicgstab", "cgs", "tfqmr"])
def test_transpose_free_batched_preconditioned(name):
    # diagonal-preconditioned bmark protocol; mixed convergence speeds
    # exercise the freeze masks
    from pykrylov_tpu.ops import DiagonalOperator
    from pykrylov_tpu.solvers import (bicgstab, cgs, tfqmr,
                                      bicgstab_batched, cgs_batched,
                                      tfqmr_batched)
    single = {"bicgstab": bicgstab, "cgs": cgs, "tfqmr": tfqmr}[name]
    batched = {"bicgstab": bicgstab_batched, "cgs": cgs_batched,
               "tfqmr": tfqmr_batched}[name]
    op, a64 = _jpwh_op()
    n = a64.shape[0]
    M = DiagonalOperator(jnp.asarray(1.0 / np.maximum(
        np.abs(np.diag(a64)), 1.0)))
    rng = np.random.default_rng(8)
    B = np.stack([a64 @ np.ones(n), 1e3 * rng.standard_normal(n)], axis=1)
    res = batched(op, jnp.asarray(B), M=M, rtol=1e-8, matvec_max=2 * n)
    for j in range(2):
        sj = single(op, jnp.asarray(B[:, j]), M=M, rtol=1e-8,
                    matvec_max=2 * n)
        assert bool(res.converged[j]) == bool(sj.converged), (name, j)
        assert abs(int(res.info["n_matvec_columns"][j])
                   - int(sj.n_matvec)) <= 4, (name, j)


def test_transpose_free_batched_breakdown_column():
    # a column whose rhs drives rho to 0 must freeze with istop 3 while
    # the healthy column converges (mirrors the single solvers' guard)
    from pykrylov_tpu.solvers import bicgstab_batched
    n = 40
    a = np.eye(n) + np.diag(np.full(n - 1, 0.5), 1)
    op = linop_from_ndarray(jnp.asarray(a))
    B = np.stack([a @ np.ones(n), np.zeros(n)], axis=1)
    res = bicgstab_batched(op, jnp.asarray(B), rtol=1e-10)
    assert bool(res.converged[0])
    # zero rhs: resid0 = 0 <= thresh -> istop 0 with x = 0
    assert float(jnp.abs(res.x[:, 1]).max()) == 0.0


# ---------------------------------------------------------------------------
# minres_batched
# ---------------------------------------------------------------------------

def _indef_sym(n=100, n_neg=30, seed=5):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = np.concatenate([np.linspace(1, 50, n - n_neg),
                        -np.linspace(1, 30, n_neg)])
    return (Q * d) @ Q.T


def test_minres_batched_columns_match_single_indefinite():
    from pykrylov_tpu.solvers import minres_batched
    a = _indef_sym()
    n = a.shape[0]
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    rng = np.random.default_rng(6)
    B = np.stack([a @ np.ones(n), 1e3 * rng.standard_normal(n),
                  rng.standard_normal(n)], axis=1)
    res = minres_batched(op, jnp.asarray(B), rtol=1e-10,
                         store_history=True)
    assert res.x.shape == (n, 3)
    for j in range(3):
        sj = minres(op, jnp.asarray(B[:, j]), rtol=1e-10)
        assert bool(res.converged[j]) == bool(sj.converged), j
        assert int(res.istop[j]) == int(sj.istop), j
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(sj.n_iter)) <= 3, j
        rj = np.linalg.norm(B[:, j] - a @ np.asarray(res.x[:, j]))
        rs = np.linalg.norm(B[:, j] - a @ np.asarray(sj.x))
        assert rj <= 10 * max(rs, 1e-12), (j, rj, rs)
    # block iterations = max column iterations; history NaN-masked
    assert int(res.n_iter) == int(res.info["n_iter_columns"].max())
    h = np.asarray(res.resid_history)
    jmin = int(np.argmin(res.info["n_iter_columns"]))
    kmin = int(res.info["n_iter_columns"][jmin])
    if kmin + 1 <= int(res.n_iter):
        assert np.isnan(h[kmin + 1, jmin])


def test_minres_batched_preconditioned_and_shifted():
    from pykrylov_tpu.solvers import minres_batched
    a = _spd(n=90, cond=1e4, seed=9)
    n = a.shape[0]
    shift = -2.5  # (A - shift I) stays SPD
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    M = DiagonalOperator(jnp.asarray(1.0 / np.diag(a)))
    rng = np.random.default_rng(10)
    B = np.stack([(a - shift * np.eye(n)) @ np.ones(n),
                  rng.standard_normal(n)], axis=1)
    # etol=0 disables the direct-error stop: at cond 1e4 the window rule
    # fires first (istop 10, ~1e-4 accuracy) and its stopping iteration
    # is rounding-sensitive, which would make the x comparison moot
    res = minres_batched(op, jnp.asarray(B), M=M, shift=shift, rtol=1e-10,
                         etol=0.0)
    for j in range(2):
        sj = minres(op, jnp.asarray(B[:, j]), M=M, shift=shift,
                    rtol=1e-10, etol=0.0)
        assert bool(res.converged[j]) == bool(sj.converged), j
        # block reductions round differently than single dots; at cond
        # 1e4 over ~100 iterations the stop can shift a few iterations
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(sj.n_iter)) <= 5, j
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(sj.x), rtol=1e-5,
                                   atol=1e-7)
    # forward error ~ cond * residual tolerance at cond 1e4
    np.testing.assert_allclose(np.asarray(res.x[:, 0]), np.ones(n),
                               rtol=1e-4, atol=1e-6)


def test_minres_batched_zero_column_and_indef_precon():
    from pykrylov_tpu.solvers import minres_batched
    a = _spd(n=40, cond=10, seed=11)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    B = np.stack([a @ np.ones(40), np.zeros(40)], axis=1)
    res = minres_batched(op, jnp.asarray(B), rtol=1e-10)
    assert bool(res.converged[0]) and bool(res.converged[1])
    assert int(res.istop[1]) == 0  # beta1 = 0: exact solution x = 0
    assert float(jnp.abs(res.x[:, 1]).max()) == 0.0
    # indefinite preconditioner: the affected column reports istop 9 at
    # entry while the healthy solve proceeds (minres.py:168-171)
    Mbad = DiagonalOperator(jnp.asarray(
        np.concatenate([np.ones(20), -np.ones(20)])))
    # rhs supported on the negative-diagonal half: b' M b < 0 at entry
    bneg = np.concatenate([np.zeros(20), np.ones(20)])
    res2 = minres_batched(op, jnp.asarray(bneg[:, None]), M=Mbad)
    assert int(res2.istop[0]) == 9
    assert not bool(res2.converged[0])


# ---------------------------------------------------------------------------
# lsmr_batched
# ---------------------------------------------------------------------------

def test_lsmr_batched_columns_match_single():
    from pykrylov_tpu.solvers import lsmr, lsmr_batched
    rng = np.random.default_rng(12)
    m, n = 90, 40
    a = rng.standard_normal((m, n))
    op = linop_from_ndarray(jnp.asarray(a))
    B = np.stack([a @ np.ones(n), rng.standard_normal(m),
                  1e2 * rng.standard_normal(m)], axis=1)
    res = lsmr_batched(op, jnp.asarray(B), atol=1e-10, btol=1e-10,
                       store_history=True)
    assert res.x.shape == (n, 3)
    for j in range(3):
        sj = lsmr(op, jnp.asarray(B[:, j]), atol=1e-10, btol=1e-10)
        assert bool(res.converged[j]) == bool(sj.converged), j
        assert int(res.istop[j]) == int(sj.istop), j
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(sj.n_iter)) <= 3, j
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(sj.x), rtol=1e-6,
                                   atol=1e-8)
        # normal-equations optimality: ||A'(Ax - b)|| small
        g = a.T @ (a @ np.asarray(res.x[:, j]) - B[:, j])
        assert np.linalg.norm(g) <= 1e-6 * np.linalg.norm(
            a.T @ B[:, j]), j
    assert int(res.n_iter) == int(res.info["n_iter_columns"].max())


def test_lsmr_batched_damped_and_zero_column():
    from pykrylov_tpu.solvers import lsmr_batched
    rng = np.random.default_rng(13)
    m, n = 60, 25
    a = rng.standard_normal((m, n))
    damp = 0.7
    op = linop_from_ndarray(jnp.asarray(a))
    B = np.stack([rng.standard_normal(m), np.zeros(m)], axis=1)
    res = lsmr_batched(op, jnp.asarray(B), damp=damp, atol=1e-10,
                       btol=1e-10, etol=0.0, itnlim=100)
    # damped normal equations: (A'A + damp^2 I) x = A' b
    xd = np.linalg.solve(a.T @ a + damp**2 * np.eye(n), a.T @ B[:, 0])
    np.testing.assert_allclose(np.asarray(res.x[:, 0]), xd, rtol=1e-6,
                               atol=1e-9)
    # zero rhs: exact solution x = 0 at zero iterations (istop 0)
    assert int(res.istop[1]) == 0
    assert float(jnp.abs(res.x[:, 1]).max()) == 0.0
    assert bool(res.converged.all())


def test_lsmr_batched_preconditioned_sqd():
    # M/N inner preconditioners (the SQD use, lsqr.py:457-472 analogue):
    # columns must match single-RHS lsmr with the same M/N
    from pykrylov_tpu.solvers import lsmr, lsmr_batched
    rng = np.random.default_rng(14)
    m, n = 50, 20
    a = rng.standard_normal((m, n))
    op = linop_from_ndarray(jnp.asarray(a))
    M = DiagonalOperator(jnp.asarray(1.0 / np.linspace(1, 3, m)))
    N = DiagonalOperator(jnp.asarray(1.0 / np.linspace(1, 2, n)))
    B = np.stack([a @ np.ones(n), rng.standard_normal(m)], axis=1)
    # etol=0 + itnlim headroom: the direct-error stop's crossing
    # iteration is rounding-sensitive between block and single dots,
    # and the min(m,n) default puts code 7 within that jitter
    res = lsmr_batched(op, jnp.asarray(B), M=M, N=N, atol=1e-10,
                       btol=1e-10, etol=0.0, itnlim=100)
    for j in range(2):
        sj = lsmr(op, jnp.asarray(B[:, j]), M=M, N=N, atol=1e-10,
                  btol=1e-10, etol=0.0, itnlim=100)
        assert bool(res.converged[j]) == bool(sj.converged), j
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(sj.x), rtol=1e-5,
                                   atol=1e-8)


# ---------------------------------------------------------------------------
# Verified batched CG (replace_every): VERDICT r3 #3
# ---------------------------------------------------------------------------

def test_verified_cg_batched_f32_reaches_1e6_per_column():
    # The done-bar: K >= 4 columns, EACH at verified <= 1e-6 true
    # relative residual on an ill-conditioned SPD system in f32
    # (1138bus, kappa ~ 8.6e6, Jacobi-accelerated legs — the same bar
    # as tests/test_ff.py::test_verified_cg_f32_reaches_1e6 and
    # test_refine.py's kappa~1e7 case, per column).
    from pykrylov_tpu.io.datasets import load_bundled
    from pykrylov_tpu.sparse import sparse_operator
    from pykrylov_tpu import solve

    vals, rows, cols, shape = load_bundled("1138bus")
    n = shape[0]
    # oracle over the f32-ROUNDED matrix — the container stores f32, so
    # measuring against unrounded f64 values would charge the solver
    # with the storage rounding ||dA x|| (dominant for a random rhs
    # whose solution norm is ~kappa times larger)
    vals32 = vals.astype(np.float32)
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), vals32.astype(np.float64))
    op = sparse_operator((vals32, rows, cols, shape),
                         symmetric=True, fmt="ell")
    M = DiagonalOperator(
        jnp.asarray(1.0 / np.abs(np.diag(a64)), jnp.float32))
    rng = np.random.default_rng(7)
    B64 = np.stack([a64 @ np.ones(n),
                    a64 @ rng.standard_normal(n),
                    a64 @ np.linspace(-1, 1, n),
                    rng.standard_normal(n) * 100.0], axis=1)
    B = jnp.asarray(B64, jnp.float32)
    B64 = np.asarray(B, np.float64)  # the f32-stored rhs is the oracle rhs

    # route through the front door: solve(A, B2d, verified=True)
    res = solve(op, B, verified=True, M=M, rtol=1e-6, atol=0.0,
                maxiter=30000, replace_every=500)
    assert res.x.shape == (n, 4)
    assert bool(jnp.all(res.converged)), np.asarray(res.resid_norm)
    X = (np.asarray(res.x, np.float64)
         + np.asarray(res.info["x_lo"], np.float64))
    for j in range(4):
        rn = (np.linalg.norm(a64 @ X[:, j] - B64[:, j])
              / np.linalg.norm(B64[:, j]))
        assert rn < 2.5e-6, (j, rn)
    assert int(jnp.min(res.info["n_replacements"])) >= 1


def test_verified_cg_batched_matches_exact_arithmetic():
    # in f64 (suite x64 default) the replacement machinery must not
    # change converged answers materially vs the plain batched path
    a = _spd(n=150, cond=100, seed=9)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    rng = np.random.default_rng(10)
    B = jnp.asarray(rng.standard_normal((150, 4)))
    r0 = cg_batched(op, B, rtol=1e-10, atol=0.0, maxiter=4000)
    r1 = cg_batched(op, B, rtol=1e-10, atol=0.0, maxiter=4000,
                    replace_every=25)
    assert bool(jnp.all(r0.converged)) and bool(jnp.all(r1.converged))
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-8, atol=1e-10)
    # frozen columns must stay bit-frozen through remaining sweeps:
    # rerun with one fast column and verify its verified residual
    B2 = B.at[:, 0].set(jnp.asarray(a @ np.ones(150)) * 1e-6)
    r2 = cg_batched(op, B2, rtol=1e-10, atol=0.0, maxiter=4000,
                    replace_every=50)
    assert bool(jnp.all(r2.converged))
    for j in range(4):
        rhs = np.asarray(B2[:, j], np.float64)
        rn = (np.linalg.norm(a @ np.asarray(r2.x[:, j], np.float64)
                             - rhs) / np.linalg.norm(rhs))
        assert rn < 1e-9, (j, rn)


def test_verified_block_front_door_rejects_unsupported():
    from pykrylov_tpu import solve
    a = _spd(n=40, cond=10, seed=2)
    B = jnp.asarray(np.random.default_rng(0).standard_normal((40, 3)))
    sym = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    # methods without a verified block twin still fail loud
    with pytest.raises(ValueError, match="verified"):
        solve(sym, B, verified=True, method="symmlq")


# ---------------------------------------------------------------------------
# Batched SYMMLQ
# ---------------------------------------------------------------------------

def test_symmlq_batched_columns_match_single():
    from pykrylov_tpu.solvers import symmlq, symmlq_batched
    # symmetric INDEFINITE system: symmlq's home turf
    rng = np.random.default_rng(21)
    n = 90
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(-40.0, 60.0, n)
    lam[np.abs(lam) < 1.0] = 1.5
    a = (Q * lam) @ Q.T
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    Xs = rng.standard_normal((n, 4))
    Xs[:, 2] *= 1e3                      # spread convergence speeds
    B = jnp.asarray(a @ Xs)
    res = symmlq_batched(op, B, rtol=1e-10)
    assert res.x.shape == (n, 4)
    assert bool(jnp.all(res.converged)), np.asarray(res.istop)
    for j in range(4):
        single = symmlq(op, B[:, j], rtol=1e-10)
        assert int(res.istop[j]) == int(single.istop), j
        assert abs(int(res.info["n_matvec_columns"][j])
                   - int(single.n_matvec)) <= 3, j
        np.testing.assert_allclose(np.asarray(res.x[:, j]),
                                   np.asarray(single.x),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(np.asarray(res.x[:, j]), Xs[:, j],
                                   rtol=1e-5, atol=1e-7)


def test_symmlq_batched_preconditioned_and_shift():
    from pykrylov_tpu.solvers import symmlq, symmlq_batched
    rng = np.random.default_rng(22)
    n = 80
    q = rng.standard_normal((n, n)) * 0.2
    a = q @ q.T + np.diag(np.linspace(1, 50, n))
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    M = DiagonalOperator(jnp.asarray(1.0 / np.diag(a)))
    Xs = rng.standard_normal((n, 3))
    shift = -2.5                          # solves (A - shift I) x = b
    B = jnp.asarray((a - shift * np.eye(n)) @ Xs)
    res = symmlq_batched(op, B, M=M, shift=shift, rtol=1e-10)
    assert bool(jnp.all(res.converged))
    np.testing.assert_allclose(np.asarray(res.x), Xs, rtol=1e-6,
                               atol=1e-8)
    # true final residual columns, as the single solver reports
    for j in range(3):
        single = symmlq(op, B[:, j], M=M, shift=shift, rtol=1e-10)
        np.testing.assert_allclose(float(res.resid_norm[j]),
                                   float(single.resid_norm),
                                   rtol=1e-3, atol=1e-9)


def test_symmlq_batched_zero_column_and_freeze():
    from pykrylov_tpu.solvers import symmlq_batched
    a = _spd(n=60, cond=50, seed=23)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    rng = np.random.default_rng(24)
    B = np.stack([np.zeros(60), a @ np.ones(60),
                  rng.standard_normal(60)], axis=1)
    res = symmlq_batched(op, jnp.asarray(B), rtol=1e-10)
    # zero rhs column: exact solution x = 0, istop 0 convention
    assert bool(res.converged[0])
    np.testing.assert_array_equal(np.asarray(res.x[:, 0]), 0.0)
    assert bool(jnp.all(res.converged))
    np.testing.assert_allclose(np.asarray(res.x[:, 1]), 1.0, rtol=1e-7)


def test_symmlq_batched_front_door():
    from pykrylov_tpu import solve
    a = _spd(n=50, cond=30, seed=25)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    Xs = np.random.default_rng(26).standard_normal((50, 3))
    res = solve(op, jnp.asarray(a @ Xs), method="symmlq", rtol=1e-10)
    assert res.x.shape == (50, 3) and bool(res.converged.all())
    np.testing.assert_allclose(np.asarray(res.x), Xs, rtol=1e-6, atol=1e-8)


def test_replace_every_zero_is_plain_cg():
    # replace_every=0 must disable the verified mode (single cg's falsy
    # coercion), not evaluate (k+1) % 0
    a = _spd(n=60, cond=50, seed=30)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    B = jnp.asarray(np.random.default_rng(31).standard_normal((60, 3)))
    r0 = cg_batched(op, B, rtol=1e-10)
    r1 = cg_batched(op, B, rtol=1e-10, replace_every=0)
    assert "n_replacements" not in r1.info
    np.testing.assert_array_equal(np.asarray(r0.x), np.asarray(r1.x))


def test_verified_block_front_door_indefinite_fails_loud():
    # solve(A_indef, B, verified=True) must flag istop 2 per column
    # (curvature net), not grind to maxiter claiming progress
    from pykrylov_tpu import solve
    n = 40
    d = np.ones(n)
    d[-1] = -1.0
    op = DiagonalOperator(jnp.asarray(d))
    B = jnp.asarray(np.random.default_rng(32).standard_normal((n, 2)))
    res = solve(op, B, verified=True, rtol=1e-10, maxiter=500)
    assert not bool(res.converged.any())
    assert bool((np.asarray(res.istop) == 2).all()), np.asarray(res.istop)
    assert not bool(res.info["definite"].any())


# ---------------------------------------------------------------------------
# Batched CRAIG / CRAIG-MR (SQD family)
# ---------------------------------------------------------------------------

def test_craig_batched_columns_match_single():
    from pykrylov_tpu.solvers import craig, craig_batched
    from pykrylov_tpu.ops import MatrixOperator
    rng = np.random.default_rng(40)
    m, n = 40, 90
    a = rng.standard_normal((m, n))
    op = MatrixOperator(jnp.asarray(a))
    B = np.stack([a @ rng.standard_normal(n) for _ in range(4)], axis=1)
    B[:, 2] *= 1e3
    # CRAIG solves the REGULARIZED SQD problem (M=N=I => Tikhonov),
    # not plain Ax=b: the btol test never fires on an inconsistent-
    # after-regularization rhs, so parity is istop/iterate equality
    # plus the closed-form SQD certificates (CLAUDE.md conventions)
    res = craig_batched(op, jnp.asarray(B), btol=1e-12, etol=0.0,
                        itnlim=400)
    assert res.x.shape == (n, 4) and res.info["r"].shape == (m, 4)
    for j in range(4):
        single = craig(op, jnp.asarray(B[:, j]), btol=1e-12, etol=0.0,
                       itnlim=400)
        assert int(res.istop[j]) == int(single.istop), j
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(single.n_iter)) <= 3, j
        nrm = max(1.0, float(jnp.linalg.norm(single.x)))
        assert float(jnp.linalg.norm(res.x[:, j] - single.x)) \
            < 1e-8 * nrm, j
        # SQD block certificates per column (identity weights)
        x = np.asarray(res.x[:, j])
        r = np.asarray(res.info["r"][:, j])
        bn = np.linalg.norm(B[:, j])
        assert np.linalg.norm((B[:, j] - a @ x) - r) < 1e-6 * bn
        assert np.linalg.norm(a.T @ r - x) < 1e-6 * bn


def test_craigmr_batched_columns_match_single():
    from pykrylov_tpu.solvers import craigmr, craigmr_batched
    from pykrylov_tpu.ops import MatrixOperator
    rng = np.random.default_rng(41)
    m, n = 35, 80
    a = rng.standard_normal((m, n))
    op = MatrixOperator(jnp.asarray(a))
    B = np.stack([a @ rng.standard_normal(n) for _ in range(3)], axis=1)
    res = craigmr_batched(op, jnp.asarray(B), etol=1e-10, itnlim=200)
    assert res.x.shape == (m, 3)       # dual-space iterate
    for j in range(3):
        single = craigmr(op, jnp.asarray(B[:, j]), etol=1e-10,
                         itnlim=200)
        assert int(res.istop[j]) == int(single.istop), j
        nrm = max(1.0, float(jnp.linalg.norm(single.x)))
        assert float(jnp.linalg.norm(res.x[:, j] - single.x)) \
            < 1e-8 * nrm, j


def test_craig_batched_zero_column_and_front_door():
    from pykrylov_tpu import solve
    from pykrylov_tpu.ops import MatrixOperator
    rng = np.random.default_rng(42)
    m, n = 30, 60
    a = rng.standard_normal((m, n))
    op = MatrixOperator(jnp.asarray(a))
    B = np.stack([np.zeros(m), a @ np.ones(n)], axis=1)
    # the etol (truncated direct-error) stop is the practical SQD
    # convergence test: istop 8 per column
    res = solve(op, jnp.asarray(B), method="craig", btol=1e-12,
                etol=1e-10, itnlim=300)
    assert bool(res.converged[0])
    np.testing.assert_array_equal(np.asarray(res.x[:, 0]), 0.0)
    assert bool(res.converged[1]) and int(res.istop[1]) == 8
    res2 = solve(op, jnp.asarray(B), method="craigmr", etol=1e-8,
                 itnlim=100)
    assert res2.x.shape == (m, 2)


# ---------------------------------------------------------------------------
# Verified batched MINRES (round 4)
# ---------------------------------------------------------------------------

def _indef_f32(n=200, nneg=10):
    main = np.full(n, 2.0)
    off = np.full(n - 1, -1.0)
    a = np.diag(main) + np.diag(off, 1) + np.diag(off, -1)
    eig = 2.0 - 2.0 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1))
    shift = 0.5 * (eig[nneg - 1] + eig[nneg])
    a -= shift * np.eye(n)
    return a.astype(np.float32)


def test_verified_minres_batched_f32_indefinite_per_column():
    # per-column counterpart of the single ff-MINRES bar: each column
    # of a symmetric INDEFINITE f32 system verified at a true relative
    # residual the recurrence can attest
    from pykrylov_tpu.solvers import minres, minres_batched
    a32 = _indef_f32()
    a64 = a32.astype(np.float64)
    n = a32.shape[0]
    op = linop_from_ndarray(jnp.asarray(a32), symmetric=True)
    rng = np.random.default_rng(50)
    B64 = np.stack([a64 @ rng.standard_normal(n) for _ in range(4)],
                   axis=1)
    B = jnp.asarray(B64, jnp.float32)
    B64 = np.asarray(B, np.float64)
    res = minres_batched(op, B, rtol=1e-6, atol=0.0, itnlim=4000,
                         replace_every=100)
    assert bool(jnp.all(res.converged)), (np.asarray(res.istop),
                                          np.asarray(res.resid_norm))
    X = (np.asarray(res.x, np.float64)
         + np.asarray(res.info["x_lo"], np.float64))
    for j in range(4):
        rel = (np.linalg.norm(a64 @ X[:, j] - B64[:, j])
               / np.linalg.norm(B64[:, j]))
        assert rel < 2.5e-6, (j, rel)
        # the reported residual IS the verified one
        reported = float(res.resid_norm[j]) / np.linalg.norm(B64[:, j])
        assert abs(reported - rel) <= 0.05 * max(rel, 1e-12), (j,)
    assert int(jnp.min(res.info["n_replacements"])) >= 1
    # columns track the single-RHS verified solver
    for j in range(2):
        single = minres(op, B[:, j], rtol=1e-6, atol=0.0, itnlim=4000,
                        replace_every=100)
        assert abs(int(res.info["n_iter_columns"][j])
                   - int(single.n_iter)) <= 0.05 * int(single.n_iter) + 3


def test_verified_minres_batched_exact_arithmetic():
    # in f64 the verified mode must agree with the plain batched MINRES
    # answers (no replacements change converged results materially)
    from pykrylov_tpu.solvers import minres_batched
    a = _spd(n=120, cond=1e3, seed=51)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    rng = np.random.default_rng(52)
    B = jnp.asarray(rng.standard_normal((120, 3)))
    r0 = minres_batched(op, B, rtol=1e-10, itnlim=2000)
    r1 = minres_batched(op, B, rtol=1e-10, atol=0.0, itnlim=2000,
                        replace_every=25)
    assert bool(jnp.all(r1.converged)), np.asarray(r1.istop)
    # the two modes STOP on different rules (scaled test1/test2 vs the
    # verified plain-2-norm true residual), so compare each against the
    # direct oracle at its own guarantee instead of to each other
    x_ref = np.linalg.solve(a, np.asarray(B))
    nrm = np.linalg.norm(x_ref, axis=0)
    assert np.all(np.linalg.norm(np.asarray(r1.x) - x_ref, axis=0)
                  < 1e-6 * nrm)
    assert np.all(np.linalg.norm(np.asarray(r0.x) - x_ref, axis=0)
                  < 1e-4 * nrm)
    with pytest.raises(ValueError, match="store_history"):
        minres_batched(op, B, replace_every=25, store_history=True)


def test_verified_minres_block_front_door():
    from pykrylov_tpu import solve
    a32 = _indef_f32()
    a64 = a32.astype(np.float64)
    n = a32.shape[0]
    op = linop_from_ndarray(jnp.asarray(a32), symmetric=True)
    rng = np.random.default_rng(53)
    B64 = np.stack([a64 @ rng.standard_normal(n) for _ in range(3)],
                   axis=1)
    B = jnp.asarray(B64, jnp.float32)
    B64 = np.asarray(B, np.float64)
    res = solve(op, B, verified=True, method="minres", rtol=1e-6,
                atol=0.0, itnlim=4000, replace_every=100)
    assert bool(jnp.all(res.converged)), np.asarray(res.istop)
    X = (np.asarray(res.x, np.float64)
         + np.asarray(res.info["x_lo"], np.float64))
    for j in range(3):
        rel = (np.linalg.norm(a64 @ X[:, j] - B64[:, j])
               / np.linalg.norm(B64[:, j]))
        assert rel < 2.5e-6, (j, rel)


def test_minres_eigenvector_rhs_stops_immediately():
    # istop -1 (b is an eigenvector) must FREEZE the column at once —
    # the reference breaks on istop != 0; `> 0` left it grinding to
    # itnlim (round-4 review finding, single and batched)
    from pykrylov_tpu.solvers import minres, minres_batched
    n = 64
    op = linop_from_ndarray(jnp.asarray(2.0 * np.eye(n)), symmetric=True)
    rng = np.random.default_rng(60)
    B = jnp.asarray(rng.standard_normal((n, 3)))
    res = minres_batched(op, B, rtol=1e-10, itnlim=5 * n)
    assert bool(jnp.all(res.istop == -1)), np.asarray(res.istop)
    assert int(jnp.max(res.info["n_iter_columns"])) <= 2
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(B) / 2.0,
                               rtol=1e-7, atol=1e-9)
    single = minres(op, B[:, 0], rtol=1e-10)
    assert int(single.istop) == -1 and int(single.n_iter) <= 2
    # verified mode: same freeze
    resv = minres_batched(op, B, rtol=1e-10, itnlim=5 * n,
                          replace_every=10)
    assert int(jnp.max(resv.info["n_iter_columns"])) <= 2


def test_minres_batched_mode_option_guards():
    from pykrylov_tpu import solve
    from pykrylov_tpu.solvers import minres_batched
    a = _spd(n=30, cond=10, seed=61)
    op = linop_from_ndarray(jnp.asarray(a), symmetric=True)
    B = jnp.ones((30, 2))
    # verified=True must not silently degrade on replace_every=0
    with pytest.raises(ValueError, match="replace_every"):
        solve(op, B, verified=True, replace_every=0)
    with pytest.raises(ValueError, match="replace_every"):
        solve(op, B, verified=True, method="minres", replace_every=0)
    # options that don't exist in the chosen mode fail loud
    with pytest.raises(ValueError, match="etol"):
        minres_batched(op, B, replace_every=10, etol=1e-8)
    with pytest.raises(ValueError, match="atol"):
        minres_batched(op, B, atol=1e-8)


class TestCgPipelinedBatched:
    """Round 5: the last method without a fused block twin."""

    def _spd(self, n=256, seed=3):
        rng = np.random.default_rng(seed)
        a = np.zeros((n, n))
        for off in (-2, -1, 0, 1, 2):
            a += np.diag(0.1 * rng.standard_normal(n - abs(off)), off)
        a = a @ a.T + 3.0 * np.eye(n)
        return a, rng

    def test_matches_single_rhs_columns(self):
        from pykrylov_tpu.solvers import cg_pipelined
        from pykrylov_tpu.solvers.batched import cg_pipelined_batched
        a, rng = self._spd()
        n = a.shape[0]
        B = rng.standard_normal((n, 3))
        res = cg_pipelined_batched(jnp.asarray(a), jnp.asarray(B),
                                   rtol=1e-10)
        assert bool(np.asarray(res.converged).all())
        for k in range(3):
            rk = cg_pipelined(jnp.asarray(a), jnp.asarray(B[:, k]),
                              rtol=1e-10)
            assert (abs(int(res.info["n_iter_columns"][k])
                        - int(rk.n_iter)) <= 1)
            np.testing.assert_allclose(np.asarray(res.x[:, k]),
                                       np.asarray(rk.x), rtol=1e-8,
                                       atol=1e-10)

    def test_matches_classic_cg_iterations(self):
        from pykrylov_tpu.solvers.batched import (cg_batched,
                                                  cg_pipelined_batched)
        a, rng = self._spd()
        B = rng.standard_normal((a.shape[0], 2))
        r1 = cg_batched(jnp.asarray(a), jnp.asarray(B), rtol=1e-8)
        r2 = cg_pipelined_batched(jnp.asarray(a), jnp.asarray(B),
                                  rtol=1e-8)
        assert bool(np.asarray(r2.converged).all())
        assert abs(int(r1.n_iter) - int(r2.n_iter)) <= 2

    def test_replace_every_and_precon(self):
        from pykrylov_tpu.ops import DiagonalOperator
        from pykrylov_tpu.solvers.batched import cg_pipelined_batched
        a, rng = self._spd()
        n = a.shape[0]
        M = DiagonalOperator(jnp.asarray(1.0 / np.diag(a)))
        xstar = rng.standard_normal((n, 2))
        B = jnp.asarray(a @ xstar)
        res = cg_pipelined_batched(jnp.asarray(a), B, M=M, rtol=1e-10,
                                   replace_every=10)
        assert bool(np.asarray(res.converged).all())
        err = np.abs(np.asarray(res.x) - xstar).max()
        assert err < 1e-7, err

    def test_front_door_block_dispatch(self):
        from pykrylov_tpu import solve
        a, rng = self._spd(128)
        B = jnp.asarray(rng.standard_normal((128, 2)))
        res = solve(jnp.asarray(a), B, method="cg_pipelined", rtol=1e-8)
        assert res.x.shape == (128, 2)
        assert bool(np.asarray(res.converged).all())

    def test_sharded_mesh(self):
        from pykrylov_tpu.parallel import sharded_poisson3d
        from pykrylov_tpu.parallel.mesh import make_mesh
        from pykrylov_tpu.solvers.batched import cg_pipelined_batched
        mesh = make_mesh(8)
        op, b, e, pad = sharded_poisson3d(12, mesh, dtype=np.float32,
                                          halo=True)
        B = jnp.stack([b, 0.5 * b], axis=1)
        res = cg_pipelined_batched(op, B, rtol=1e-6, replace_every=10)
        assert bool(np.asarray(res.converged).all())
        err = float(jnp.abs(res.x[:, 0] - e).max())
        assert err < 1e-3, err
