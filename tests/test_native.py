"""Native C++ data-pipeline tests (ctypes bindings over native.cpp).

Oracle: the pure-NumPy MatrixMarket parser and the vectorized NumPy
format-packing fallbacks (both exercised directly here for parity).
"""

import numpy as np
import pytest

from pykrylov_tpu import native
from pykrylov_tpu.io.datasets import data_dir
from pykrylov_tpu.io.matrix_market import read_matrix_market, \
    write_matrix_market

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain")


def test_mm_parse_matches_numpy(tmp_path, rng):
    # Write a general real matrix and parse it both ways.
    m, n, nnz = 37, 23, 140
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz)
    path = tmp_path / "t.mtx"
    write_matrix_market(path, vals, rows, cols, (m, n))

    out = native.mm_parse_native(str(path))
    assert out is not None
    v2, r2, c2, shape, field, symmetry = out
    assert shape == (m, n) and field == "real" and symmetry == "general"
    # Entry order preserved from the file.
    v1, r1, c1, shape1, info = read_matrix_market(str(path),
                                                  expand_symmetric=False)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_allclose(v1, v2)


def test_mm_parse_symmetric_flag(tmp_path):
    path = tmp_path / "s.mtx"
    write_matrix_market(path, [2.0, -1.0], [0, 1], [0, 0], (2, 2),
                        symmetry="symmetric")
    out = native.mm_parse_native(str(path))
    assert out[5] == "symmetric"
    assert len(out[0]) == 2  # unexpanded, like the NumPy parser pre-finish


def test_mm_parse_bundled_1138bus_end_to_end():
    import os
    mtx = "/root/reference/examples/1138bus.mtx"
    if not os.path.exists(mtx):
        pytest.skip("reference matrix not present")
    vals, rows, cols, shape, info = read_matrix_market(mtx)
    assert shape == (1138, 1138)
    # expanded symmetric: 2596 stored = 1138 diag + 1458 off-diag pairs
    assert len(vals) == 2 * 2596 - 1138


def test_ell_fill_matches_fallback(rng):
    m, nnz = 50, 300
    rows = np.sort(rng.integers(0, m, nnz).astype(np.int32))
    cols = rng.integers(0, m, nnz).astype(np.int32)
    # unique (row, col) to avoid duplicate-slot ambiguity
    keys = np.unique(rows.astype(np.int64) * m + cols)
    rows = (keys // m).astype(np.int32)
    cols = (keys % m).astype(np.int32)
    vals = rng.standard_normal(len(keys))
    K = int(np.bincount(rows, minlength=m).max())
    ed, ec = native.ell_fill_native(rows, cols, vals, m, K)
    dense_native = np.zeros((m, m))
    np.add.at(dense_native, (np.repeat(np.arange(m), K), ec.ravel()),
              ed.ravel())
    dense_ref = np.zeros((m, m))
    dense_ref[rows, cols] = vals
    np.testing.assert_allclose(dense_native, dense_ref)


def test_dia_fill_matches_fallback(rng):
    m = 64
    offs = np.array([-5, -1, 0, 3], dtype=np.int64)
    rows_l, cols_l, vals_l = [], [], []
    for off in offs:
        i = np.arange(max(0, -off), min(m, m - off))
        rows_l.append(i)
        cols_l.append(i + off)
        vals_l.append(rng.standard_normal(len(i)))
    rows = np.concatenate(rows_l).astype(np.int32)
    cols = np.concatenate(cols_l).astype(np.int32)
    vals = np.concatenate(vals_l)
    data = native.dia_fill_native(rows, cols, vals, m, offs)
    k = np.searchsorted(offs, cols.astype(np.int64) - rows)
    ref = np.zeros((len(offs), m))
    ref[k, rows] = vals
    np.testing.assert_allclose(data, ref)


def test_row_counts(rng):
    rows = rng.integers(0, 20, 500).astype(np.int32)
    np.testing.assert_array_equal(native.row_counts_native(rows, 20),
                                  np.bincount(rows, minlength=20))

