"""General sparsity on one device: every container format the front door
offers, on the sparsity classes a general-purpose SpMV must carry, for
all four products a Krylov solver applies (A x, A' x, A X, A' X), against
the SciPy f64 product.

The classes: scattered and banded squares, both rectangular aspects,
duplicate coordinates (which must sum), an empty matrix, the bundled
jpwh_991, heavy-tailed (power-law) row degrees, a stencil with a
clustered long-range scatter tail, and a randomly permuted block
diagonal.
"""

import functools
import zlib

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.sparse import operator_from_coo


def _random(m, n, nnz, bw, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, m, nnz)
    if bw is None:
        cols = rng.integers(0, n, nnz)
    else:
        cols = np.clip(rows * n // m + rng.integers(-bw, bw + 1, nnz),
                       0, n - 1)
    return rng.standard_normal(nnz), rows, cols, (m, n)


def _duplicates():
    v, r, c, s = _random(200, 200, 900, 20, 8)
    k = np.arange(0, 900, 3)          # every third entry appears twice
    return (np.concatenate([v, 0.5 * v[k]]), np.concatenate([r, r[k]]),
            np.concatenate([c, c[k]]), s)


def _empty():
    z = np.zeros(0, np.int64)
    return np.zeros(0), z, z, (50, 40)


def _power_law(n=2048, seed=0):
    rng = np.random.default_rng(seed)
    deg = np.clip((rng.pareto(2.0, n) + 1).astype(int) * 3, 3, 200)
    rows = np.repeat(np.arange(n), deg)
    base = rows + rng.integers(-60, 61, rows.shape)
    far = rng.random(rows.shape) < 0.05
    cols = np.where(far, rng.integers(0, n, rows.shape), base) % n
    return rng.standard_normal(rows.size), rows, cols, (n, n)


def _stencil_scatter(n=4096, seed=1):
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in (-256, -16, -1, 0, 1, 16, 256):
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(r.size, 6.0 if off == 0 else -1.0))
    ns = n // 4
    blocks = rng.integers(0, n // 128, 16)
    rows.append(rng.integers(0, n, ns))
    cols.append(blocks[rng.integers(0, 16, ns)] * 128
                + rng.integers(0, 128, ns))
    vals.append(0.1 * rng.standard_normal(ns))
    return (np.concatenate(vals), np.concatenate(rows),
            np.concatenate(cols), (n, n))


def _permuted_blockdiag(n=1536, blk=192, seed=2):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    rows, cols = [], []
    for b0 in range(0, n, blk):
        rows.append(perm[rng.integers(b0, b0 + blk, 4 * blk)])
        cols.append(perm[rng.integers(b0, b0 + blk, 4 * blk)])
    rows = np.concatenate(rows)
    return (rng.standard_normal(rows.size), rows, np.concatenate(cols),
            (n, n))


MATRICES = {
    "scattered_96": lambda: _random(96, 96, 400, None, 0),
    "banded_1000": lambda: _random(1000, 1000, 8000, 90, 1),
    "rect_700x300": lambda: _random(700, 300, 2500, None, 3),
    "rect_300x700": lambda: _random(300, 700, 2500, None, 4),
    "duplicates": _duplicates,
    "empty": _empty,
    "jpwh_991": lambda: load_bundled("jpwh_991"),
    "power_law": _power_law,
    "stencil_scatter": _stencil_scatter,
    "permuted_blockdiag": _permuted_blockdiag,
}
FORMATS = ("auto", "ell", "csr", "coo")
PRODUCTS = ("Ax", "ATx", "AX", "ATX")


@functools.lru_cache(maxsize=None)
def _case(name):
    vals, rows, cols, shape = MATRICES[name]()
    ref = sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)),
                        shape=shape)
    return (vals, rows, cols, shape), ref


@functools.lru_cache(maxsize=None)
def _operator(name, fmt):
    (vals, rows, cols, shape), _ = _case(name)
    return operator_from_coo(vals, rows, cols, shape, fmt=fmt,
                             dtype=np.float64)


@pytest.mark.parametrize("product", PRODUCTS)
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_products_match_scipy_f64(name, fmt, product):
    (_, _, _, (m, n)), ref = _case(name)
    op = _operator(name, fmt)
    if name == "empty":
        assert op.shape == (m, n)
    rng = np.random.default_rng(zlib.crc32(" ".join((name, fmt, product))
                                           .encode()))
    transposed = product.startswith("AT")
    k_in = m if transposed else n
    v = (rng.standard_normal(k_in) if product in ("Ax", "ATx")
         else rng.standard_normal((k_in, 3)))
    lin = op.T if transposed else op
    got = np.asarray(lin @ jnp.asarray(v))
    want = (ref.T if transposed else ref) @ v
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("name,expect", [("banded_1000", "ELL"),
                                         ("stencil_scatter", "ELL"),
                                         ("rect_700x300", "ELL")])
def test_auto_picks_ell_for_general_sparsity(name, expect):
    op = _operator(name, "auto")
    assert type(op.container).__name__ == expect


def test_auto_picks_dia_for_a_stencil():
    from pykrylov_tpu.gallery.poisson import poisson3d_coo
    vals, rows, cols, shape = poisson3d_coo(6)
    op = operator_from_coo(vals, rows, cols, shape, symmetric=True)
    assert type(op.container).__name__ == "DIA"


def test_unknown_format_raises():
    vals, rows, cols, shape = _random(8, 8, 10, None, 0)
    for fmt in ("bell", "pallas-dia", "nope"):
        with pytest.raises(ValueError, match="unknown format"):
            operator_from_coo(vals, rows, cols, shape, fmt=fmt)
