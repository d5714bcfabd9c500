"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The reference has no distributed tests (SURVEY §4); these validate the
JAX-native scaling layer: row-block sharded operators, halo-exchange DIA
matvecs, and full solver runs over sharded pytrees where XLA inserts the
psum/all-gather collectives.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pykrylov_tpu.parallel import (make_mesh, shard_vector, shard_operator,
                                   HaloDiaOperator, sharded_poisson3d,
                                   device_mesh_info)
from pykrylov_tpu.sparse import formats as F
from pykrylov_tpu.sparse import sparse_operator
from pykrylov_tpu.gallery import poisson1d_coo, poisson3d_coo
from pykrylov_tpu.solvers import cg, minres, bicgstab


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


def test_mesh_info(mesh):
    info = device_mesh_info(mesh)
    assert info["n_devices"] == 8
    assert info["shape"] == {"rows": 8}


class TestHaloDia:
    def test_matvec_matches_dense(self, mesh):
        n = 64
        vals, rows, cols, shape = poisson1d_coo(n)
        dia = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape))
        op = HaloDiaOperator(dia, mesh)
        assert op.pad == 0 and op.halo_width == 1
        x = np.linspace(-1, 1, n)
        xs = shard_vector(jnp.asarray(x), mesh)
        y = np.asarray(op * xs)
        A = np.asarray(F.to_dense(dia))
        np.testing.assert_allclose(y, A @ x, atol=1e-12)

    def test_matvec_with_padding(self, mesh):
        n = 61  # not divisible by 8 → padded to 64
        vals, rows, cols, shape = poisson1d_coo(n)
        dia = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape))
        op = HaloDiaOperator(dia, mesh)
        assert op.pad == 3
        x = np.zeros(64)
        x[:n] = np.linspace(-1, 1, n)
        y = np.asarray(op * shard_vector(jnp.asarray(x), mesh))
        A = np.asarray(F.to_dense(dia))
        np.testing.assert_allclose(y[:n], A @ x[:n], atol=1e-12)
        np.testing.assert_allclose(y[n:], 0.0, atol=0)

    def test_wide_band_3d_poisson(self, mesh):
        n = 8  # 512 unknowns, halo width n*n = 64 = rows/device
        vals, rows, cols, shape = poisson3d_coo(n)
        dia = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape))
        op = HaloDiaOperator(dia, mesh)
        assert op.halo_width == n * n
        rng = np.random.default_rng(0)
        x = rng.standard_normal(n**3)
        y = np.asarray(op * shard_vector(jnp.asarray(x), mesh))
        A = np.asarray(F.to_dense(dia))
        np.testing.assert_allclose(y, A @ x, atol=1e-10)

    def test_bandwidth_guard(self, mesh):
        n = 8
        vals, rows, cols, shape = poisson3d_coo(n)
        dia = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape))
        # halo 64 > 8 rows/device on a fake 64-way split is impossible here,
        # so shrink rows instead: n=4 → 64 rows, 8 per device, halo 16.
        vals, rows, cols, shape = poisson3d_coo(4)
        dia_small = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape))
        with pytest.raises(ValueError, match="bandwidth"):
            HaloDiaOperator(dia_small, mesh)


class TestShardedEll:
    def test_general_sparsity_allgather_fallback(self, mesh):
        op = sparse_operator("jpwh_991", symmetric=False, fmt="ell")
        sharded, pad = shard_operator(op, mesh)
        n = 991
        assert pad == pad_expected(n, 8)
        x = np.zeros(n + pad)
        x[:n] = 1.0 + np.arange(n) / n
        xs = shard_vector(jnp.asarray(x), mesh)
        y = np.asarray(sharded * xs)
        y_ref = np.asarray(op * jnp.asarray(x[:n]))
        np.testing.assert_allclose(y[:n], y_ref, rtol=1e-12)
        np.testing.assert_allclose(y[n:], 0.0)
        # transpose path
        yt = np.asarray(sharded.T * xs)
        yt_ref = np.asarray(op.T * jnp.asarray(x[:n]))
        np.testing.assert_allclose(yt[:n], yt_ref, rtol=1e-12)


def pad_expected(n, d):
    return (n + d - 1) // d * d - n


class TestShardedSolves:
    def test_cg_on_sharded_3d_poisson_halo(self, mesh):
        op, b, e, pad = sharded_poisson3d(8, mesh, halo=True)
        res = cg(op, b, rtol=1e-10)
        assert bool(res.converged)
        err = float(jnp.linalg.norm(res.x - e))
        assert err < 1e-6
        # Solution sharding survives the while_loop.
        assert len(res.x.sharding.device_set) == 8

    def test_cg_on_sharded_3d_poisson_generic(self, mesh):
        op, b, e, pad = sharded_poisson3d(8, mesh, halo=False)
        res = cg(op, b, rtol=1e-10)
        assert bool(res.converged)
        assert float(jnp.linalg.norm(res.x - e)) < 1e-6

    def test_minres_on_sharded_system(self, mesh):
        op, b, e, pad = sharded_poisson3d(8, mesh, halo=True)
        res = minres(op, b, rtol=1e-12)
        assert bool(res.converged)
        assert float(jnp.linalg.norm(res.x - e)) < 1e-5

    def test_bicgstab_on_sharded_ell(self, mesh):
        op = sparse_operator("jpwh_991", symmetric=False, fmt="ell")
        sharded, pad = shard_operator(op, mesh)
        n = 991
        e = np.zeros(n + pad)
        e[:n] = 1.0
        es = shard_vector(jnp.asarray(e), mesh)
        b = sharded * es
        res = bicgstab(sharded, b, x0=shard_vector(
            jnp.asarray(np.where(np.arange(n + pad) < n,
                                 1.0 + np.arange(n + pad), 0.0)), mesh),
            rtol=1e-8, matvec_max=2 * n)
        assert bool(res.converged)
        err = float(jnp.linalg.norm(res.x[:n] - 1.0) / np.sqrt(n))
        assert err < 1e-4

    def test_sharded_matches_unsharded_history(self, mesh):
        """Residual histories agree between 1-device and 8-device runs."""
        op8, b8, e8, _ = sharded_poisson3d(8, mesh, halo=True)
        mesh1 = make_mesh(1)
        op1, b1, e1, _ = sharded_poisson3d(8, mesh1, halo=True)
        r8 = cg(op8, b8, rtol=1e-10, store_history=True)
        r1 = cg(op1, b1, rtol=1e-10, store_history=True)
        assert int(r8.n_iter) == int(r1.n_iter)
        h8, h1 = r8.history(), r1.history()
        # The final entry sits at the 1e-10 threshold where reduction-order
        # noise dominates; compare the trajectory up to it.
        np.testing.assert_allclose(h8[:-1], h1[:-1], rtol=1e-6)


def test_shard_operator_rejects_non_container_ops(mesh):
    """Non-SparseOperator inputs get a clear TypeError, not a bare unpack
    failure (review finding)."""
    from pykrylov_tpu.ops import IdentityOperator
    with pytest.raises(TypeError, match="ELL/DIA"):
        shard_operator(IdentityOperator(16), mesh)


def test_initialize_multihost_single_process_noop():
    # single-process launch: no coordinator env, no explicit args — the
    # bootstrap degrades to a documented no-op and reports the local
    # process topology so drivers can call it unconditionally
    from pykrylov_tpu.parallel import initialize_multihost
    info = initialize_multihost()
    assert info["process_count"] == 1
    assert info["process_index"] == 0
    assert info["n_devices"] >= 1


class TestHaloDiaLocalPath:
    def test_local_path_matches_dense(self, mesh):
        # the shifted-slice local stencil behind the ppermute halo
        # exchange, with offsets +-256 crossing the 512-row shards
        from pykrylov_tpu.gallery.poisson import poisson3d_coo
        n = 16  # m=4096, offsets +-256; 8 shards of 512 rows
        vals, rows, cols, shape = poisson3d_coo(n, dtype=np.float64)
        dia = F.dia_from_coo(
            F.coo_from_arrays(vals, rows, cols, shape, device=False),
            device=False)
        dia32 = F.DIA(np.asarray(dia.data, np.float32), dia.offsets,
                      dia.shape)
        op = HaloDiaOperator(dia32, mesh)
        rng = np.random.default_rng(3)
        x = rng.standard_normal(n ** 3).astype(np.float32)
        xs = shard_vector(jnp.asarray(x), mesh)
        y = np.asarray(op @ xs)
        A = np.asarray(F.to_dense(dia))
        np.testing.assert_allclose(y, A @ x.astype(np.float64),
                                   rtol=1e-4, atol=1e-4)
        # block products ship (w, K) halo slices through the same path
        X2 = jnp.stack([xs, 2.0 * xs], axis=1)
        Y2 = np.asarray(op.apply_with(op._mm, X2))
        np.testing.assert_allclose(Y2[:, 0], y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(Y2[:, 1], 2.0 * y, rtol=1e-6,
                                   atol=1e-6)

    def test_halo_path_in_cg(self, mesh):
        from pykrylov_tpu.gallery.poisson import poisson3d_dia
        from pykrylov_tpu.solvers import cg
        n = 16
        op = HaloDiaOperator(poisson3d_dia(n, np.float32), mesh)
        e = shard_vector(jnp.ones(n ** 3, jnp.float32), mesh)
        b = op @ e
        res = cg(op, b, rtol=1e-6, maxiter=4 * n ** 3)
        assert bool(res.converged)
        assert len(res.x.sharding.device_set) == 8
        assert float(jnp.abs(res.x - e).max()) < 1e-3

    def test_bandwidth_exceeding_shard_raises(self, mesh):
        # the halo must come from the two neighbours only
        m = 8 * 100
        data = np.zeros((3, m), np.float32)
        dia = F.DIA(data, (-101, 0, 101), (m, m))
        with pytest.raises(ValueError, match="bandwidth"):
            HaloDiaOperator(dia, mesh)

    def test_ff_resolver_halo_compensated(self, mesh):
        # round 5: HaloDiaOperator registers a
        # COMPENSATED sharded matvec — (hi, lo) halo slices ride
        # stacked ppermutes, the local product is TwoProd/TwoSum.
        # Must also NOT fall into the dense sniff (its (ndiag, m)
        # params array; round-4 review finding).
        from pykrylov_tpu.solvers.ffmv import (resolve_ff_matvec,
                                               resolve_ff_matmat)
        from pykrylov_tpu.gallery.poisson import poisson1d_coo
        from pykrylov_tpu.parallel import shard_vector
        vals, rows, cols, shape = poisson1d_coo(64)
        dia = F.dia_from_coo(F.coo_from_arrays(vals, rows, cols, shape))
        op = HaloDiaOperator(dia, mesh)
        ff = resolve_ff_matvec(op)
        assert ff is not None and resolve_ff_matmat(op) is not None
        # exactness: (yh + yl) reproduces the f64 oracle product of the
        # f32-stored matrix far below the plain f32 matvec floor
        rng = np.random.default_rng(3)
        d32 = np.asarray(dia.data).astype(np.float32)
        x32 = rng.standard_normal(64).astype(np.float32)
        xh = shard_vector(jnp.asarray(x32, jnp.float32), mesh)
        yh, yl = ff(op._params, xh, jnp.zeros_like(xh))
        dense = np.zeros((64, 64))
        for k, off in enumerate(dia.offsets):
            idx = np.arange(max(0, -off), min(64, 64 - off))
            dense[idx, idx + off] = d32[k, idx]
        oracle = dense @ x32.astype(np.float64)
        got = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
        err = np.abs(got - oracle).max() / np.abs(oracle).max()
        assert err < 1e-12, err
        # the verified block front door rides it end to end
        from pykrylov_tpu import solve
        e = shard_vector(jnp.ones(64), mesh)
        B2 = jnp.stack([op @ e, 2.0 * (op @ e)], axis=1)
        res = solve(op, B2, verified=True, rtol=1e-8,
                    replace_every=10, maxiter=3000)
        assert bool(res.converged.all())


class TestHaloStencilMatrixFree:
    def test_matches_dia_halo_and_gallery(self, mesh):
        from pykrylov_tpu.parallel import (HaloStencilPoisson3DOperator,
                                           sharded_poisson3d)
        from pykrylov_tpu.gallery.poisson import poisson3d_matvec
        n = 16
        op = HaloStencilPoisson3DOperator(n, mesh)
        rng = np.random.default_rng(13)
        v = rng.standard_normal(n ** 3).astype(np.float32)
        xs = shard_vector(jnp.asarray(v), mesh)
        y = np.asarray(op @ xs)
        oracle = np.asarray(poisson3d_matvec(jnp.asarray(v, jnp.float64)))
        np.testing.assert_allclose(y, oracle, rtol=1e-4, atol=1e-4)
        # the sharded_poisson3d front door
        opf, b, e, pad = sharded_poisson3d(n, mesh, matrix_free=True,
                                           dtype=np.float32)
        assert pad == 0
        np.testing.assert_allclose(np.asarray(opf @ xs), y, rtol=1e-6)
        # block products broadcast over K
        X2 = jnp.stack([xs, 2.0 * xs], axis=1)
        Y2 = np.asarray(opf.apply_with(opf._mm, X2))
        np.testing.assert_allclose(Y2[:, 1], 2.0 * y, rtol=1e-5,
                                   atol=1e-5)

    def test_cg_and_batched(self, mesh):
        from pykrylov_tpu.parallel import sharded_poisson3d
        from pykrylov_tpu.solvers import cg, cg_batched
        n = 16
        op, b, e, pad = sharded_poisson3d(n, mesh, matrix_free=True,
                                          dtype=np.float32)
        res = cg(op, b, rtol=1e-6, maxiter=4 * n ** 3)
        assert bool(res.converged)
        assert len(res.x.sharding.device_set) == 8
        assert float(jnp.abs(res.x - e).max()) < 1e-3
        B2 = jnp.stack([b, 0.5 * b], axis=1)
        rb = cg_batched(op, B2, rtol=1e-6, maxiter=4 * n ** 3)
        assert bool(rb.converged.all())
        assert float(jnp.abs(rb.x[:, 1] - 0.5 * e).max()) < 1e-3

    def test_indivisible_mesh_raises(self, mesh):
        from pykrylov_tpu.parallel import HaloStencilPoisson3DOperator
        with pytest.raises(ValueError, match="divide"):
            HaloStencilPoisson3DOperator(12, mesh)  # 8 does not divide 12
