"""MatrixMarket I/O tests: writer/reader roundtrips across fields and
symmetries, gzip handling, symmetric expansion, bundled datasets.
"""

import gzip

import numpy as np
import pytest

from pykrylov_tpu.io.matrix_market import (read_matrix_market,
                                           write_matrix_market, mm_to_coo)
from pykrylov_tpu.io.datasets import load_bundled, BUNDLED


def dense_of(vals, rows, cols, shape):
    d = np.zeros(shape, dtype=np.asarray(vals).dtype)
    np.add.at(d, (rows, cols), vals)
    return d


class TestRoundtrip:
    def test_general_real(self, tmp_path, rng):
        m, n, nnz = 20, 15, 60
        rows = rng.integers(0, m, nnz)
        cols = rng.integers(0, n, nnz)
        vals = rng.standard_normal(nnz)
        p = tmp_path / "g.mtx"
        write_matrix_market(p, vals, rows, cols, (m, n),
                            comment="roundtrip\ntest")
        v, r, c, shape, info = read_matrix_market(p)
        assert shape == (m, n) and info.symmetry == "general"
        np.testing.assert_allclose(dense_of(v, r, c, shape),
                                   dense_of(vals, rows, cols, (m, n)))

    def test_symmetric_expansion(self, tmp_path):
        # lower triangle of [[2,-1],[-1,2]]
        p = tmp_path / "s.mtx"
        write_matrix_market(p, [2.0, -1.0, 2.0], [0, 1, 1], [0, 0, 1],
                            (2, 2), symmetry="symmetric")
        v, r, c, shape, info = read_matrix_market(p)
        np.testing.assert_allclose(dense_of(v, r, c, shape),
                                   [[2, -1], [-1, 2]])
        v2, *_ = read_matrix_market(p, expand_symmetric=False)
        assert len(v2) == 3

    def test_skew_symmetric(self, tmp_path):
        p = tmp_path / "k.mtx"
        write_matrix_market(p, [3.0], [1], [0], (2, 2),
                            symmetry="skew-symmetric")
        v, r, c, shape, info = read_matrix_market(p)
        np.testing.assert_allclose(dense_of(v, r, c, shape),
                                   [[0, -3], [3, 0]])

    def test_complex_hermitian(self, tmp_path):
        p = tmp_path / "h.mtx"
        write_matrix_market(p, np.array([2 + 0j, 1 + 2j, 3 + 0j]),
                            [0, 1, 1], [0, 0, 1], (2, 2),
                            symmetry="hermitian")
        v, r, c, shape, info = read_matrix_market(p)
        d = dense_of(v, r, c, shape)
        np.testing.assert_allclose(d, np.array([[2, 1 - 2j], [1 + 2j, 3]]))

    def test_gzip(self, tmp_path, rng):
        p = tmp_path / "g.mtx"
        write_matrix_market(p, [1.5, -2.5], [0, 2], [1, 2], (3, 3))
        gz = tmp_path / "g.mtx.gz"
        gz.write_bytes(gzip.compress(p.read_bytes()))
        v, r, c, shape, info = read_matrix_market(gz)
        np.testing.assert_allclose(sorted(v), [-2.5, 1.5])

    def test_dtype_override(self, tmp_path):
        p = tmp_path / "d.mtx"
        write_matrix_market(p, [1.0], [0], [0], (1, 1))
        v, *_ = read_matrix_market(p, dtype=np.float32)
        assert v.dtype == np.float32


class TestReferenceFiles:
    @pytest.mark.parametrize("name,mtx", [
        ("1138bus", "/root/reference/examples/1138bus.mtx"),
        ("jpwh_991", "/root/reference/examples/jpwh_991.mtx"),
    ])
    def test_bundled_matches_mtx(self, name, mtx):
        import os
        if not os.path.exists(mtx):
            pytest.skip("reference matrices not present")
        vb, rb, cb, sb = load_bundled(name)
        vm, rm, cm, sm = mm_to_coo(mtx)
        assert sb == sm
        np.testing.assert_allclose(dense_of(vb, rb, cb, sb),
                                   dense_of(vm, rm, cm, sm))

    def test_bundled_metadata(self):
        for name, (shape, sym, _) in BUNDLED.items():
            vals, rows, cols, s = load_bundled(name)
            assert s == shape
            d = dense_of(vals, rows, cols, s)
            if sym:
                np.testing.assert_allclose(d, d.T)


class TestPartitionedIngestion:
    """SURVEY §2.5 host-sharded ingestion: the
    streaming row-block partitioned MatrixMarket loader."""

    @staticmethod
    def _write_symmetric_mtx(path, n=600, seed=5):
        from pykrylov_tpu.io.matrix_market import write_matrix_market
        rng = np.random.default_rng(seed)
        # lower triangle incl. a dominant diagonal
        rr = rng.integers(0, n, 5 * n)
        cc = rng.integers(0, n, 5 * n)
        lo = np.minimum(rr, cc); hi = np.maximum(rr, cc)
        rr, cc = hi, lo
        key = rr * n + cc
        _, first = np.unique(key, return_index=True)
        rr, cc = rr[first], cc[first]
        vv = 0.1 * rng.standard_normal(len(rr))
        rr = np.concatenate([rr, np.arange(n)])
        cc = np.concatenate([cc, np.arange(n)])
        vv = np.concatenate([vv, np.full(n, 4.0)])
        key = rr * n + cc
        _, first = np.unique(key, return_index=True)
        rr, cc, vv = rr[first], cc[first], vv[first]
        write_matrix_market(path, vv, rr, cc, (n, n),
                            symmetry="symmetric")
        return n

    def test_parts_match_monolithic(self, tmp_path):
        from pykrylov_tpu.io.matrix_market import (
            read_matrix_market, read_matrix_market_partitioned)
        p = tmp_path / "sym.mtx"
        n = self._write_symmetric_mtx(str(p))
        vals, rows, cols, shape, info = read_matrix_market(str(p))
        # tiny chunks so the streaming path really iterates
        parts, shape2, info2 = read_matrix_market_partitioned(
            str(p), 8, chunk_entries=97)
        assert shape2 == shape and info2.symmetry == "symmetric"
        pv = np.concatenate([q[0] for q in parts])
        pr = np.concatenate([q[1] for q in parts])
        pc = np.concatenate([q[2] for q in parts])
        assert len(pv) == len(vals)
        o1 = np.lexsort((cols, rows))
        o2 = np.lexsort((pc, pr))
        np.testing.assert_array_equal(rows[o1], pr[o2])
        np.testing.assert_array_equal(cols[o1], pc[o2])
        np.testing.assert_array_equal(vals[o1], pv[o2])
        # parts follow the sharded row partition exactly
        from pykrylov_tpu.parallel.sharded import pad_to_multiple
        L = pad_to_multiple(n, 8) // 8
        for k, (qv, qr, qc) in enumerate(parts):
            assert ((qr // L) == k).all()

    def test_keep_streams_single_slab(self, tmp_path):
        # keep=k: only that slab is retained — the multi-host mode
        # where per-process peak COO memory is ~nnz/N + one chunk
        from pykrylov_tpu.io.matrix_market import (
            read_matrix_market_partitioned)
        from pykrylov_tpu.parallel.sharded import pad_to_multiple
        p = tmp_path / "sym.mtx"
        n = self._write_symmetric_mtx(str(p))
        allp, shape, _ = read_matrix_market_partitioned(
            str(p), 8, chunk_entries=101)
        total = sum(len(q[0]) for q in allp)
        L = pad_to_multiple(n, 8) // 8
        for k in (0, 3, 7):
            (one,), _, _ = read_matrix_market_partitioned(
                str(p), 8, keep=k, chunk_entries=101)
            assert ((one[1] // L) == k).all()
            np.testing.assert_array_equal(one[0], allp[k][0])
            # a slab is a ~1/N share, not the whole matrix
            assert len(one[0]) < 0.45 * total

    def test_partitioned_operator_bit_identical_solve(self, tmp_path):
        import jax.numpy as jnp
        from pykrylov_tpu.io.matrix_market import read_matrix_market
        from pykrylov_tpu.parallel import (GatherEllOperator,
                                           shard_vector)
        from pykrylov_tpu.parallel.gather import gather_ell_from_mtx
        from pykrylov_tpu.parallel.mesh import make_mesh
        from pykrylov_tpu.sparse import formats as F
        from pykrylov_tpu.solvers import cg
        p = tmp_path / "sym.mtx"
        n = self._write_symmetric_mtx(str(p))
        mesh = make_mesh(8)
        op_p = gather_ell_from_mtx(str(p), mesh, symmetric=True,
                                   chunk_entries=89)
        vals, rows, cols, shape, _ = read_matrix_market(str(p))
        op_m = GatherEllOperator(
            F.coo_from_arrays(vals, rows, cols, shape, device=False),
            mesh, symmetric=True)
        ep = np.zeros(op_m.nargin)
        ep[:n] = 1.0
        es = shard_vector(jnp.asarray(ep), mesh)
        b_p = op_p @ es
        b_m = op_m @ es
        np.testing.assert_array_equal(np.asarray(b_p), np.asarray(b_m))
        r_p = cg(op_p, b_p, rtol=1e-10, maxiter=4 * n)
        r_m = cg(op_m, b_m, rtol=1e-10, maxiter=4 * n)
        assert bool(r_p.converged) and bool(r_m.converged)
        np.testing.assert_array_equal(np.asarray(r_p.x),
                                      np.asarray(r_m.x))
        assert int(r_p.n_iter) == int(r_m.n_iter)
