"""Complex systems via the real-equivalent formulation
(`ops/complex_eq.py`): packing isometry, block layout correctness, and
end-to-end complex solves through real solvers."""

import numpy as np
import jax.numpy as jnp
import pytest

from pykrylov_tpu.ops import (pack_complex, unpack_complex,
                              real_equivalent_dense, real_equivalent_coo,
                              real_equivalent_operator, complex_solve)
from pykrylov_tpu.solvers import (cg, cg_batched, minres, bicgstab,
                                  lsqr, lsmr)


def _hermitian_pd(n=60, seed=0, cond=100.0):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n))
                     + 1j * rng.standard_normal((n, n)))[0]
    lam = np.logspace(0, np.log10(cond), n)
    a = (Q * lam) @ Q.conj().T
    return (a + a.conj().T) / 2


def _general_complex(n=50, seed=1):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return a + 3 * n**0.5 * np.eye(n)   # diagonally dominant-ish


def test_pack_unpack_roundtrip_and_isometry():
    rng = np.random.default_rng(2)
    z = rng.standard_normal(33) + 1j * rng.standard_normal(33)
    x = pack_complex(z)
    assert x.shape == (66,)
    np.testing.assert_allclose(np.linalg.norm(x), np.linalg.norm(z),
                               rtol=1e-14)
    np.testing.assert_allclose(unpack_complex(x), z, rtol=1e-14)
    # blocks
    Z = rng.standard_normal((10, 4)) + 1j * rng.standard_normal((10, 4))
    X = pack_complex(Z)
    assert X.shape == (20, 4)
    np.testing.assert_allclose(unpack_complex(X), Z, rtol=1e-14)
    # Re(u^H v) = pack(u) . pack(v)
    u = rng.standard_normal(33) + 1j * rng.standard_normal(33)
    np.testing.assert_allclose(pack_complex(u) @ x, np.vdot(u, z).real,
                               rtol=1e-12)
    with pytest.raises(ValueError):
        unpack_complex(np.zeros(7))


def test_unpack_complex_dtype_pairing():
    # sub-double floats (f32, and the bf16/f16 blocks low-precision
    # solves produce) pair with complex64; only f64 widens to c128
    import jax.numpy as jnp
    assert unpack_complex(np.zeros(8, np.float64)).dtype == np.complex128
    assert unpack_complex(np.zeros(8, np.float32)).dtype == np.complex64
    assert unpack_complex(np.zeros(8, np.float16)).dtype == np.complex64
    bf = np.asarray(jnp.zeros(8, jnp.bfloat16))
    assert unpack_complex(bf).dtype == np.complex64


def test_real_equivalent_dense_matches_complex_matvec():
    a = _general_complex(17)
    ar = real_equivalent_dense(a)
    assert ar.shape == (34, 34) and ar.dtype == np.float64
    rng = np.random.default_rng(3)
    z = rng.standard_normal(17) + 1j * rng.standard_normal(17)
    np.testing.assert_allclose(ar @ pack_complex(z), pack_complex(a @ z),
                               rtol=1e-13)
    # Hermitian => symmetric real equivalent
    h = _hermitian_pd(12)
    hr = real_equivalent_dense(h)
    np.testing.assert_allclose(hr, hr.T, atol=1e-14)


def test_real_equivalent_coo_drops_zero_blocks():
    # a real-valued matrix must pack to exactly 2x nnz, not 4x
    rows = np.array([0, 1, 2]); cols = np.array([1, 2, 0])
    vals = np.array([1.0 + 0j, 2.0, 3.0])
    v2, r2, c2, shp = real_equivalent_coo(vals, rows, cols, (3, 3))
    assert shp == (6, 6) and len(v2) == 6
    assert v2.dtype == np.float64
    # mixed: one purely imaginary entry adds its two Im-block copies
    vals = np.array([1.0, 2.0j, 3.0 + 4.0j])
    v2, r2, c2, _ = real_equivalent_coo(vals, rows, cols, (3, 3))
    assert len(v2) == 2 * 2 + 2 * 2  # two Re parts x2 + two Im parts x2
    # dense equivalence
    a = np.zeros((3, 3), complex)
    a[rows, cols] = vals
    d = np.zeros((6, 6))
    np.add.at(d, (r2, c2), v2)
    np.testing.assert_allclose(d, real_equivalent_dense(a), atol=1e-14)


def test_hermitian_cg_matches_complex_arithmetic():
    a = _hermitian_pd(60)
    n = a.shape[0]
    rng = np.random.default_rng(4)
    zstar = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = a @ zstar
    op = real_equivalent_operator(a, hermitian=True)
    assert op.symmetric and op.shape == (120, 120)
    assert (op.m_complex, op.n_complex) == (n, n)
    res = complex_solve(cg, op, b, rtol=1e-10)
    assert bool(res.converged)
    assert res.x.dtype == np.complex128
    np.testing.assert_allclose(res.x, zstar, rtol=1e-6)
    # resid_norm is the exact complex residual norm (isometry)
    np.testing.assert_allclose(float(res.resid_norm),
                               np.linalg.norm(b - a @ res.x),
                               rtol=1e-6, atol=1e-12)
    # doubled-multiplicity spectrum: CG iteration counts match the
    # complex-arithmetic recurrence on the CPU backend within a couple
    from pykrylov_tpu.ops import linop_from_ndarray
    cop = linop_from_ndarray(jnp.asarray(a), hermitian=True,
                             symmetric=False)
    cres = cg(cop, jnp.asarray(b), rtol=1e-10)
    assert abs(int(res.n_iter) - int(cres.n_iter)) <= 3


def test_hermitian_indefinite_minres():
    a = _hermitian_pd(40, seed=5)
    a -= 3.0 * np.eye(40)          # shift some eigenvalues negative
    rng = np.random.default_rng(6)
    zstar = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    b = a @ zstar
    op = real_equivalent_operator(a, hermitian=True)
    res = complex_solve(minres, op, b, rtol=1e-12, etol=0.0)
    assert bool(res.converged)
    assert np.linalg.norm(b - a @ res.x) <= 1e-8 * np.linalg.norm(b)


def test_general_complex_bicgstab_and_x0():
    a = _general_complex(50)
    rng = np.random.default_rng(7)
    zstar = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    b = a @ zstar
    x0 = zstar + 0.1 * (rng.standard_normal(50)
                        + 1j * rng.standard_normal(50))
    res = complex_solve(bicgstab, a, b, x0=x0, rtol=1e-10)
    assert bool(res.converged)
    np.testing.assert_allclose(res.x, zstar, rtol=1e-5)


def test_complex_least_squares_lsqr_lsmr():
    rng = np.random.default_rng(8)
    m, n = 80, 30
    a = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    zstar = np.linalg.lstsq(a, b, rcond=None)[0]
    op = real_equivalent_operator(a)
    assert op.shape == (160, 60)
    for solver in (lsqr, lsmr):
        res = complex_solve(solver, op, b, atol=1e-12, btol=1e-12)
        np.testing.assert_allclose(res.x, zstar, rtol=1e-6, atol=1e-9)


def test_complex_batched_block():
    a = _hermitian_pd(40, seed=9)
    rng = np.random.default_rng(10)
    Z = rng.standard_normal((40, 3)) + 1j * rng.standard_normal((40, 3))
    B = a @ Z
    op = real_equivalent_operator(a, hermitian=True)
    res = complex_solve(cg_batched, op, B, rtol=1e-10)
    assert res.x.shape == (40, 3) and res.x.dtype == np.complex128
    assert bool(res.converged.all())
    np.testing.assert_allclose(res.x, Z, rtol=1e-5)
