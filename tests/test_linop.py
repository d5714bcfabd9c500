"""Operator-layer unit tests.

Mirrors the reference test strategy (``linop/tests/test_linop.py``, SURVEY
§4): construction and transpose/adjoint inference (incl. complex),
algebra semantics with error raising, a dtype-promotion matrix, and each
special operator checked against an explicit dense matrix.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import pykrylov_tpu as pk
from pykrylov_tpu.ops import (
    LinearOperator, IdentityOperator, DiagonalOperator, ZeroOperator,
    MatrixOperator, CoordLinearOperator, ReducedLinearOperator,
    SymmetricallyReducedLinearOperator, ShapeError, linop_from_ndarray, sqrt,
)


def ndarray_to_coord(A, symmetric=False):
    m, n = A.shape
    vals, rows, cols = [], [], []
    for i in range(m):
        for j in range(n):
            if symmetric and j > i:
                continue
            if A[i, j] != 0:
                vals.append(A[i, j]); rows.append(i); cols.append(j)
    return (np.array(vals, dtype=A.dtype), np.array(rows), np.array(cols))


def get_matvecs(A):
    return dict(shape=A.shape,
                matvec=lambda x: np.dot(A, x),
                matvec_transp=lambda x: np.dot(A.T, x),
                matvec_adj=lambda x: np.dot(A.conj().T, x))


class TestConstruction:
    def setup_method(self):
        self.A = np.array([[1., 2., 3.], [4., 5., 6.]])
        self.B = self.A + 1j * self.A

    def test_basic(self):
        mv = get_matvecs(self.A)
        op = LinearOperator(3, 2, matvec=mv["matvec"],
                            matvec_transp=mv["matvec_transp"], dtype=np.float64)
        assert op.shape == (2, 3)
        assert op.nargin == 3 and op.nargout == 2
        x = np.array([1., 1., 1.])
        np.testing.assert_allclose(op * x, self.A @ x)
        np.testing.assert_allclose(op.T * np.array([1., 2.]), self.A.T @ [1., 2.])

    def test_transpose_of_transpose(self):
        mv = get_matvecs(self.A)
        op = LinearOperator(3, 2, matvec=mv["matvec"],
                            matvec_transp=mv["matvec_transp"], dtype=np.float64)
        assert op.T.T is op
        assert op.T.shape == (3, 2)

    def test_adjoint_inference_complex(self):
        mv = get_matvecs(self.B)
        op = LinearOperator(3, 2, matvec=mv["matvec"],
                            matvec_transp=mv["matvec_transp"],
                            dtype=np.complex128)
        x = np.array([1 + 1j, 2., 3.])
        y = np.array([1., 1j])
        np.testing.assert_allclose(op * x, self.B @ x)
        # H inferred from T by conjugation
        np.testing.assert_allclose(op.H * y, self.B.conj().T @ y)
        assert op.H.H is op

    def test_real_H_equals_T(self):
        mv = get_matvecs(self.A)
        op = LinearOperator(3, 2, matvec=mv["matvec"],
                            matvec_transp=mv["matvec_transp"], dtype=np.float64)
        assert op.H is op.T

    def test_symmetric_no_transp_needed(self):
        C = self.A @ self.A.T
        op = LinearOperator(2, 2, matvec=lambda x: C @ x, symmetric=True,
                            dtype=np.float64)
        assert op.T is op
        x = np.array([1., -1.])
        np.testing.assert_allclose(op.T * x, C @ x)

    def test_conjugate(self):
        mv = get_matvecs(self.B)
        op = LinearOperator(3, 2, matvec=mv["matvec"],
                            matvec_transp=mv["matvec_transp"],
                            dtype=np.complex128)
        x = np.array([1 + 2j, 0., 1j])
        np.testing.assert_allclose(op.bar * x, self.B.conj() @ x)

    def test_shape_errors(self):
        mv = get_matvecs(self.A)
        op = LinearOperator(3, 2, matvec=mv["matvec"], dtype=np.float64)
        with pytest.raises(ShapeError):
            op * np.ones(5)

    def test_to_array(self):
        mv = get_matvecs(self.A)
        op = LinearOperator(3, 2, matvec=mv["matvec"], dtype=np.float64)
        np.testing.assert_allclose(op.to_array(), self.A)


class TestAlgebra:
    def setup_method(self):
        self.A = np.arange(6, dtype=np.float64).reshape(2, 3) + 1
        self.B = np.arange(6, dtype=np.float64).reshape(3, 2) * 2 + 1
        self.opA = MatrixOperator(self.A)
        self.opB = MatrixOperator(self.B)

    def test_scalar_mul(self):
        x = np.ones(3)
        np.testing.assert_allclose((2.5 * self.opA) * x, 2.5 * (self.A @ x))
        np.testing.assert_allclose((self.opA * 2.5) * x, 2.5 * (self.A @ x))
        np.testing.assert_allclose((-self.opA) * x, -(self.A @ x))
        np.testing.assert_allclose((self.opA / 2) * x, (self.A @ x) / 2)

    def test_zero_scalar_gives_zero_operator(self):
        z = self.opA * 0
        assert isinstance(z, ZeroOperator)
        np.testing.assert_allclose(z * np.ones(3), np.zeros(2))

    def test_division_by_zero(self):
        with pytest.raises(ZeroDivisionError):
            self.opA / 0

    def test_composition(self):
        op = self.opA * self.opB          # (2x3)(3x2) = 2x2
        x = np.array([1., -2.])
        np.testing.assert_allclose(op * x, self.A @ (self.B @ x))
        # transpose reverses order
        np.testing.assert_allclose(op.T * x, self.B.T @ (self.A.T @ x))

    def test_composition_shape_error(self):
        with pytest.raises(ShapeError):
            self.opA * self.opA

    def test_add_sub(self):
        C = np.ones((2, 3))
        opC = MatrixOperator(C)
        x = np.array([1., 2., 3.])
        np.testing.assert_allclose((self.opA + opC) * x, (self.A + C) @ x)
        np.testing.assert_allclose((self.opA - opC) * x, (self.A - C) @ x)
        with pytest.raises(ShapeError):
            self.opA + self.opB
        with pytest.raises(ValueError):
            self.opA + 3

    def test_pow(self):
        S = self.A @ self.A.T
        op = MatrixOperator(S, symmetric=True)
        x = np.array([1., 2.])
        np.testing.assert_allclose((op ** 3) * x, S @ S @ S @ x)
        np.testing.assert_allclose((op ** 1) * x, S @ x)
        np.testing.assert_allclose((op ** 0) * x, x)
        with pytest.raises(ShapeError):
            self.opA ** 2
        with pytest.raises(ValueError):
            op ** (-1)

    def test_rmatvec(self):
        y = np.array([1., 2.])
        np.testing.assert_allclose(self.opA.rmatvec(y), self.A.T @ y)

    def test_matmat(self):
        X = np.ones((3, 4))
        np.testing.assert_allclose(self.opA * X, self.A @ X)


DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


class TestDtypePromotion:
    @pytest.mark.parametrize("dt1", DTYPES)
    @pytest.mark.parametrize("dt2", DTYPES)
    def test_promotion_matrix(self, dt1, dt2):
        A = np.ones((3, 3), dtype=dt1)
        B = np.ones((3, 3), dtype=dt2)
        opA, opB = MatrixOperator(A), MatrixOperator(B)
        expected = jnp.result_type(dt1, dt2)
        assert (opA + opB).dtype == expected
        assert (opA * opB).dtype == expected
        assert (opA - opB).dtype == expected

    @pytest.mark.parametrize("dt", DTYPES)
    def test_scalar_promotion(self, dt):
        op = MatrixOperator(np.ones((2, 2), dtype=dt))
        assert (op * 2.0).dtype == jnp.result_type(dt, np.float64)
        assert (2.0 * op).dtype == jnp.result_type(dt, np.float64)


class TestSpecialOperators:
    def test_identity(self):
        op = IdentityOperator(4)
        x = np.arange(4.)
        np.testing.assert_allclose(op * x, x)
        assert op.symmetric and op.hermitian
        assert sqrt(op) is op

    def test_diagonal(self):
        d = np.array([1., 4., 9.])
        op = DiagonalOperator(d)
        x = np.array([1., 2., 3.])
        np.testing.assert_allclose(op * x, d * x)
        np.testing.assert_allclose(op.T * x, d * x)
        np.testing.assert_allclose(abs(op) * x, np.abs(d) * x)
        np.testing.assert_allclose(sqrt(op) * x, np.sqrt(d) * x)
        np.testing.assert_allclose(np.asarray(op.diag), d)
        assert op.symmetric and op.hermitian

    def test_diagonal_complex(self):
        d = np.array([1. + 1j, 2. - 1j])
        op = DiagonalOperator(d)
        assert op.symmetric and not op.hermitian
        x = np.array([1., 1j])
        np.testing.assert_allclose(op.H * x, d.conj() * x)

    def test_diagonal_sqrt_negative_raises(self):
        with pytest.raises(ValueError):
            sqrt(DiagonalOperator(np.array([1., -1.])))

    def test_zero(self):
        op = ZeroOperator(3, 2, dtype=np.float64)
        np.testing.assert_allclose(op * np.ones(3), np.zeros(2))
        np.testing.assert_allclose(op.T * np.ones(2), np.zeros(3))
        with pytest.raises(ShapeError):
            op * np.ones(4)

    def test_reduced_vs_dense(self, rng):
        A = rng.standard_normal((6, 6))
        op = MatrixOperator(A)
        rows, cols = [0, 2, 4], [1, 3, 5]
        red = ReducedLinearOperator(op, rows, cols)
        x = rng.standard_normal(3)
        np.testing.assert_allclose(red * x, A[np.ix_(rows, cols)] @ x)
        np.testing.assert_allclose(red.T * x, A[np.ix_(rows, cols)].T @ x)

    def test_sym_reduced_vs_dense(self, rng):
        A = rng.standard_normal((6, 6))
        A = A + A.T
        op = MatrixOperator(A, symmetric=True)
        idx = [1, 2, 5]
        red = SymmetricallyReducedLinearOperator(op, idx)
        x = rng.standard_normal(3)
        np.testing.assert_allclose(red * x, A[np.ix_(idx, idx)] @ x)
        assert red.symmetric

    def test_coord_vs_dense(self, rng):
        A = rng.standard_normal((5, 4))
        A[np.abs(A) < 0.5] = 0.0
        vals, rows, cols = ndarray_to_coord(A)
        op = CoordLinearOperator(vals, rows, cols, 4, 5)
        x = rng.standard_normal(4)
        y = rng.standard_normal(5)
        np.testing.assert_allclose(op * x, A @ x, atol=1e-14)
        np.testing.assert_allclose(op.T * y, A.T @ y, atol=1e-14)

    def test_coord_symmetric_triangle(self, rng):
        A = rng.standard_normal((5, 5))
        A = A + A.T
        vals, rows, cols = ndarray_to_coord(A, symmetric=True)
        op = CoordLinearOperator(vals, rows, cols, 5, 5, symmetric=True)
        x = rng.standard_normal(5)
        np.testing.assert_allclose(op * x, A @ x, atol=1e-14)
        np.testing.assert_allclose(op.T * x, A @ x, atol=1e-14)

    def test_linop_from_ndarray(self, rng):
        A = rng.standard_normal((3, 4))
        op = linop_from_ndarray(A)
        x = rng.standard_normal(4)
        np.testing.assert_allclose(op * x, A @ x)


class TestJitCompat:
    """Operators are pytrees usable as jit arguments — the core design."""

    def test_jit_through_operator_arg(self, rng):
        A = rng.standard_normal((4, 4))
        op = MatrixOperator(A)

        @jax.jit
        def apply(o, x):
            return o.matvec(x)

        x = jnp.asarray(rng.standard_normal(4))
        np.testing.assert_allclose(apply(op, x), A @ x)
        # New params, same structure: no retrace needed, new values used.
        op2 = MatrixOperator(A * 2)
        np.testing.assert_allclose(apply(op2, x), 2 * (A @ x), rtol=1e-14)

    def test_jit_composed(self, rng):
        A = rng.standard_normal((3, 3))
        d = rng.standard_normal(3) ** 2 + 1
        op = DiagonalOperator(d) * MatrixOperator(A) + IdentityOperator(3, dtype=np.float64)

        @jax.jit
        def apply(o, x):
            return o.matvec(x)

        x = jnp.asarray(rng.standard_normal(3))
        np.testing.assert_allclose(apply(op, x), d * (A @ x) + x, rtol=1e-12)

    def test_grad_through_operator(self, rng):
        A = rng.standard_normal((3, 3))
        op = MatrixOperator(A)

        def loss(o, x):
            return jnp.sum(o.matvec(x) ** 2)

        x = jnp.asarray(rng.standard_normal(3))
        g = jax.grad(loss, argnums=1)(op, x)
        np.testing.assert_allclose(g, 2 * A.T @ (A @ x), rtol=1e-12)


class TestCounters:
    def test_nmatvec(self, rng):
        op = MatrixOperator(rng.standard_normal((3, 3)))
        assert op.nMatvec == 0
        op * np.ones(3)
        op * np.ones(3)
        assert op.nMatvec == 2
        op.reset_counters()
        assert op.nMatvec == 0


def test_pysparse_adapter_inside_jit():
    """PysparseLinearOperator must be a registered pytree so it can be a
    jitted-solver argument (review finding)."""
    import scipy.sparse as sp
    from pykrylov_tpu.ops import PysparseLinearOperator
    from pykrylov_tpu.solvers import cg
    n = 30
    A = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()
    op = PysparseLinearOperator(A)
    op._BaseLinearOperator__symmetric = True  # scipy csr has no issym
    b = jnp.asarray(A @ np.ones(n))
    res = cg(op, b, rtol=1e-10)
    assert bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), 1.0, atol=1e-8)


def test_shared_jit_cache_across_equal_coord_operators():
    """Two CoordLinearOperators with identical config share pytree aux
    (closure factories are memoized), so solvers don't recompile."""
    from pykrylov_tpu.ops import CoordLinearOperator
    a1 = CoordLinearOperator([2.0, 2.0], [0, 1], [0, 1], 2, 2,
                             symmetric=True)
    a2 = CoordLinearOperator([3.0, 3.0], [0, 1], [0, 1], 2, 2,
                             symmetric=True)
    t1 = jax.tree_util.tree_structure(a1)
    t2 = jax.tree_util.tree_structure(a2)
    assert t1 == t2


def test_multi_rhs_application(rng):
    """Operators apply columnwise to matrices (reference linop semantics:
    op * X for 2-D X), including sparse-backed operators."""
    from pykrylov_tpu.sparse import sparse_operator
    A = rng.standard_normal((20, 20))
    rr, cc = np.nonzero(np.abs(A) > 0.8)
    op = sparse_operator((A[rr, cc], rr, cc, (20, 20)))
    dense = np.zeros((20, 20))
    dense[rr, cc] = A[rr, cc]
    X = rng.standard_normal((20, 5))
    Y = np.asarray(op * jnp.asarray(X))
    np.testing.assert_allclose(Y, dense @ X, atol=1e-12)
    # dense operator too
    from pykrylov_tpu.ops import MatrixOperator
    B = MatrixOperator(jnp.asarray(A))
    np.testing.assert_allclose(np.asarray(B * jnp.asarray(X)), A @ X,
                               atol=1e-12)
