"""JAX-native linear-operator layer.

Functional re-design of the reference operator layer
(``/root/reference/pykrylov/linop/linop.py``).  The reference models an
operator as a mutable Python object holding matvec closures; every algebraic
combination (`+`, `-`, `*`, transpose, adjoint, powers) builds new closures
that recurse through Python at *run* time.  Under jit that recursion must
happen at *trace* time instead, so here an operator is a **pytree**:

  * children  — ``params``: arbitrary pytree of jnp arrays (diagonals, CSR
    buffers, nested operators, ...) that may be traced / donated / sharded;
  * aux data  — pure functions ``mv/rmv/hmv : (params, x) -> y`` plus static
    metadata (shape, dtype, symmetry flags).

Because operators are pytrees, they can be passed straight into ``jax.jit``
(solvers take the operator as an argument), composed inside ``lax.while_loop``
carries, vmapped, and sharded with ``NamedSharding`` on their leaves.  All
algebra is function composition performed once at trace time; XLA then fuses
the whole expression.

Semantics preserved from the reference:
  * shape/dtype/symmetric/hermitian metadata and dtype promotion through all
    algebra (``linop/linop.py:307-452``);
  * ``op.T`` / ``op.H`` are linked twins: ``op.T.T is op`` (``linop.py:148-204``);
  * missing transpose/adjoint rules inferred via conjugation for complex
    dtypes (``linop.py:211-254``);
  * scalar*op, op*op (transpose reverses order), op+op, op-op, op/scalar,
    op**k, -op, 0*op -> ZeroOperator;
  * shape-checked application with ``ShapeError`` (``linop.py:271-298``);
  * matvec counters (`nMatvec`, `reset_counters`) — kept as *host-side*
    counters for API familiarity; inside ``jit`` they count trace-time calls
    only (solvers report exact on-device counts in their results instead).
"""

from __future__ import annotations

import functools as _functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node

__all__ = [
    "ShapeError",
    "BaseLinearOperator",
    "LinearOperator",
    "IdentityOperator",
    "DiagonalOperator",
    "ZeroOperator",
    "MatrixOperator",
    "CoordLinearOperator",
    "PysparseLinearOperator",
    "ReducedLinearOperator",
    "SymmetricallyReducedLinearOperator",
    "linop_from_ndarray",
    "aslinearoperator",
    "sqrt",
]


class ShapeError(ValueError):
    """Raised when operator/vector dimensions do not agree.

    Parity: ``linop/linop.py:626-635``.
    """


def _as_jnp(x):
    return x if isinstance(x, jnp.ndarray) else jnp.asarray(x)


# ---------------------------------------------------------------------------
# Base metadata class
# ---------------------------------------------------------------------------


class BaseLinearOperator:
    """Shape/dtype/symmetry metadata plus host-side matvec counters.

    Parity: ``linop/linop.py:14-104``.
    """

    def __init__(self, nargin, nargout, symmetric=False, hermitian=False, dtype=None, name=None):
        self.__nargin = int(nargin)
        self.__nargout = int(nargout)
        self.__symmetric = bool(symmetric)
        self.__hermitian = bool(hermitian)
        self.__dtype = np.dtype(dtype if dtype is not None else jnp.zeros(0).dtype)
        self._nMatvec = 0
        self.name = name

    # -- metadata ----------------------------------------------------------
    @property
    def nargin(self):
        """Dimension of the operator's domain (length of x in A*x)."""
        return self.__nargin

    @property
    def nargout(self):
        """Dimension of the operator's range (length of A*x)."""
        return self.__nargout

    @property
    def shape(self):
        return (self.__nargout, self.__nargin)

    @property
    def symmetric(self):
        return self.__symmetric

    @property
    def hermitian(self):
        return self.__hermitian

    @property
    def dtype(self):
        return self.__dtype

    # -- counters ----------------------------------------------------------
    @property
    def nMatvec(self):
        """Host-side count of operator applications (trace-time under jit)."""
        return self._nMatvec

    def reset_counters(self):
        self._nMatvec = 0

    # -- callables ---------------------------------------------------------
    def __call__(self, *args, **kwargs):
        return self.__mul__(*args, **kwargs)

    def __mul__(self, x):
        raise NotImplementedError("subclass must implement __mul__")

    def __repr__(self):
        sym = "symmetric" if self.symmetric else "unsymmetric"
        return "<%s %s %dx%d %s>" % (
            self.__class__.__name__, sym, self.nargout, self.nargin, self.dtype,
        )


# ---------------------------------------------------------------------------
# Module-level combinators (kept at module scope so pytree aux-data stays
# hashable and jit caches are shared across operator instances).
# ---------------------------------------------------------------------------


def _apply_fn(fn, params, x):
    if fn is None:
        raise NotImplementedError("operator does not define this product")
    return fn(params, x)


def _conj_mv(inner):
    def mv(params, x):
        return jnp.conj(_apply_fn(inner, params, jnp.conj(x)))
    return mv


def _scale_mv(inner):
    def mv(params, x):
        op, alpha = params
        return alpha * op.apply_with(inner, x)
    return mv


def _compose_mv(left_fn, right_fn):
    def mv(params, x):
        a, b = params
        return a.apply_with(left_fn, b.apply_with(right_fn, x))
    return mv


def _add_mv(left_fn, right_fn):
    def mv(params, x):
        a, b = params
        return a.apply_with(left_fn, x) + b.apply_with(right_fn, x)
    return mv


def _block_apply(op, fn, X):
    """Apply one of an operator's 1-D rules to an (n, K) block: native
    block rule when the operator has one, trace-time vmap otherwise."""
    mm = op._mm_for(fn)
    if mm is not None:
        return _apply_fn(mm, op._params, X)
    return jax.vmap(lambda c: _apply_fn(fn, op._params, c),
                    in_axes=1, out_axes=1)(X)


def _scale_mm(inner):
    def mm(params, X):
        op, alpha = params
        return alpha * _block_apply(op, inner, X)
    return mm


def _compose_mm(left_fn, right_fn, swap=False):
    def mm(params, X):
        a, b = (params[1], params[0]) if swap else params
        return _block_apply(a, left_fn, _block_apply(b, right_fn, X))
    return mm


def _add_mm(left_fn, right_fn):
    def mm(params, X):
        a, b = params
        return _block_apply(a, left_fn, X) + _block_apply(b, right_fn, X)
    return mm


def _pow_mm(which, k):
    def mm(params, X):
        (op,) = params
        fn = getattr(op, which)
        for _ in range(k):
            X = _block_apply(op, fn, X)
        return X
    return mm


def _pow_mv(k):
    def mv(params, x):
        (op,) = params
        for _ in range(k):
            x = op.apply_with(op._mv, x)
        return x
    return mv


def _pow_rmv(k):
    def mv(params, x):
        (op,) = params
        for _ in range(k):
            x = op.apply_with(op._rmv, x)
        return x
    return mv


def _pow_hmv(k):
    def mv(params, x):
        (op,) = params
        for _ in range(k):
            x = op.apply_with(op._hmv, x)
        return x
    return mv


# ---------------------------------------------------------------------------
# LinearOperator
# ---------------------------------------------------------------------------


class LinearOperator(BaseLinearOperator):
    """A linear operator y = A @ x as a pytree of params + pure apply fns.

    Constructor mirrors the reference signature
    (``linop/linop.py:114``): ``LinearOperator(nargin, nargout, matvec,
    matvec_transp=None, matvec_adj=None, symmetric=..., hermitian=...)``
    where the apply functions here take ``(params, x)``.  For the common
    case of plain closures over captured arrays, pass functions of ``x``
    alone with ``params=None`` — they are wrapped automatically.
    """

    def __init__(self, nargin, nargout, matvec, matvec_transp=None,
                 matvec_adj=None, params=None, symmetric=False, hermitian=False,
                 dtype=None, name=None, _takes_params=None,
                 matmat=None, matmat_transp=None):
        super().__init__(nargin, nargout, symmetric=symmetric,
                         hermitian=hermitian, dtype=dtype, name=name)
        if _takes_params is None:
            _takes_params = params is not None
        if not _takes_params:
            # Wrap plain x->y closures into (params, x)->y form.
            mv0, rmv0, hmv0 = matvec, matvec_transp, matvec_adj
            matvec = (lambda p, x: mv0(x))
            matvec_transp = (lambda p, x: rmv0(x)) if rmv0 is not None else None
            matvec_adj = (lambda p, x: hmv0(x)) if hmv0 is not None else None
            if matmat is not None:
                mm0 = matmat
                matmat = (lambda p, X: mm0(X))
            if matmat_transp is not None:
                rmm0 = matmat_transp
                matmat_transp = (lambda p, X: rmm0(X))
        self._params = params
        mv, rmv, hmv = matvec, matvec_transp, matvec_adj
        # Optional native block products A @ X / A.T @ X on (n, K)
        # column blocks (the "SpMM" path: one pass streams A per block
        # instead of once per column — solvers/batched.py and the
        # 2-D matvec dispatch use them when present, vmap otherwise).
        if self.symmetric and matmat_transp is None:
            matmat_transp = matmat
        self._mm = matmat
        self._rmm = matmat_transp

        is_complex = np.issubdtype(self.dtype, np.complexfloating)
        # Fill in transpose/adjoint rules from symmetry and conjugation,
        # mirroring linop/linop.py:148-254.
        if self.symmetric and rmv is None:
            rmv = mv
        if self.hermitian and hmv is None:
            hmv = mv
        if not is_complex:
            # Real: transpose and adjoint coincide.
            if rmv is None and hmv is not None:
                rmv = hmv
            if hmv is None and rmv is not None:
                hmv = rmv
        else:
            if hmv is None and rmv is not None:
                hmv = _conj_mv(rmv)
            if rmv is None and hmv is not None:
                rmv = _conj_mv(hmv)

        self._mv = mv
        self._rmv = rmv
        self._hmv = hmv
        # Linked twins (built lazily; back-pointers give op.T.T is op).
        self._transpose_of = None
        self._adjoint_of = None
        self._conjugate_of = None

    # -- pytree ------------------------------------------------------------
    @property
    def params(self):
        return self._params

    def _aux(self):
        return (type(self), self.nargin, self.nargout, self._mv, self._rmv,
                self._hmv, self.symmetric, self.hermitian, str(self.dtype),
                self.name, self._mm, self._rmm)

    # -- core application --------------------------------------------------
    def apply_with(self, fn, x):
        """Apply one of this operator's rules without shape checking."""
        return _apply_fn(fn, self._params, x)

    def _check_shape(self, x, expected):
        shp = jnp.shape(x)
        if len(shp) not in (1, 2) or shp[0] != expected:
            raise ShapeError(
                "operator %s cannot be applied to array of shape %s"
                % (repr(self), (shp,)))

    def _mm_for(self, fn):
        """The native block-product rule matching a 1-D apply rule (or
        None).  The adjoint reuses the transpose block rule when they
        coincide (real dtypes)."""
        if fn is self._mv:
            return self._mm
        if fn is self._rmv or (fn is self._hmv and self._hmv is self._rmv):
            return self._rmm
        return None

    def _apply(self, fn, x, in_dim, out_dim):
        x = _as_jnp(x)
        self._check_shape(x, in_dim)
        self._nMatvec += 1
        if x.ndim == 1:
            y = _apply_fn(fn, self._params, x)
        else:  # matrix: native block product if present, else vmap
            mm = self._mm_for(fn)
            if mm is not None:
                y = _apply_fn(mm, self._params, x)
            else:
                y = jax.vmap(lambda col: _apply_fn(fn, self._params, col),
                             in_axes=1, out_axes=1)(x)
        if jnp.shape(y)[0] != out_dim:
            raise ShapeError(
                "operator %s produced array of leading dim %d, expected %d"
                % (repr(self), jnp.shape(y)[0], out_dim))
        return y

    def matvec(self, x):
        """y = A @ x with shape checks (scipy-style alias: ``dot``)."""
        return self._apply(self._mv, x, self.nargin, self.nargout)

    def rmatvec(self, x):
        """y = A.H @ x — scipy.sparse.linalg compat (``linop.py:300``)."""
        return self._apply(self._hmv, x, self.nargout, self.nargin)

    dot = matvec

    def to_array(self):
        """Densify by applying to the identity (``linop.py:256-269``).

        Uses a host-level column loop so operators whose matvec closures
        are plain NumPy code densify too (vmap would reject them).
        """
        eye = np.eye(self.nargin, dtype=self.dtype)
        cols = [jnp.asarray(self.apply_with(self._mv, jnp.asarray(eye[:, j])))
                for j in range(self.nargin)]
        return jnp.stack(cols, axis=1)

    full = to_array

    # -- transpose / adjoint / conjugate ------------------------------------
    @property
    def T(self):
        if self._transpose_of is not None:
            return self._transpose_of
        if self.symmetric and self.nargin == self.nargout:
            return self
        t = LinearOperator(
            self.nargout, self.nargin,
            matvec=self._rmv, matvec_transp=self._mv,
            matvec_adj=_conj_mv(self._mv) if self._rmv is not None else None,
            matmat=self._rmm, matmat_transp=self._mm,
            params=self._params, _takes_params=True,
            symmetric=self.symmetric, hermitian=self.hermitian,
            dtype=self.dtype,
            name=None if self.name is None else self.name + ".T")
        t._transpose_of = self
        self._transpose_of = t
        return t

    @property
    def H(self):
        if self._adjoint_of is not None:
            return self._adjoint_of
        if self.hermitian and self.nargin == self.nargout:
            return self
        if not np.issubdtype(self.dtype, np.complexfloating):
            return self.T
        h = LinearOperator(
            self.nargout, self.nargin,
            matvec=self._hmv, matvec_adj=self._mv,
            matvec_transp=_conj_mv(self._mv) if self._hmv is not None else None,
            params=self._params, _takes_params=True,
            symmetric=self.symmetric, hermitian=self.hermitian,
            dtype=self.dtype,
            name=None if self.name is None else self.name + ".H")
        h._adjoint_of = self
        self._adjoint_of = h
        return h

    @property
    def bar(self):
        """Complex-conjugate operator (``linop.py:206-254``)."""
        return self.conjugate()

    def conjugate(self):
        if self._conjugate_of is not None:
            return self._conjugate_of
        if not np.issubdtype(self.dtype, np.complexfloating):
            return self
        c = LinearOperator(
            self.nargin, self.nargout,
            matvec=_conj_mv(self._mv),
            matvec_transp=_conj_mv(self._rmv) if self._rmv is not None else None,
            matvec_adj=_conj_mv(self._hmv) if self._hmv is not None else None,
            params=self._params, _takes_params=True,
            symmetric=self.symmetric, hermitian=self.hermitian,
            dtype=self.dtype,
            name=None if self.name is None else self.name + ".bar")
        c._conjugate_of = self
        self._conjugate_of = c
        return c

    # -- algebra -------------------------------------------------------------
    def _mul_scalar(self, alpha):
        # 0 * op -> ZeroOperator (linop.py:307-314)
        if np.isscalar(alpha) and not isinstance(alpha, jnp.ndarray) and alpha == 0:
            return ZeroOperator(self.nargin, self.nargout,
                                dtype=jnp.result_type(self.dtype, type(alpha)))
        rdt = jnp.result_type(self.dtype, jnp.asarray(alpha).dtype)
        a = jnp.asarray(alpha, dtype=rdt)
        return LinearOperator(
            self.nargin, self.nargout,
            matvec=_scale_mv(self._mv),
            matvec_transp=_scale_mv(self._rmv) if self._rmv is not None else None,
            matvec_adj=(lambda p, x: jnp.conj(p[1]) * p[0].apply_with(p[0]._hmv, x))
                       if self._hmv is not None else None,
            matmat=_scale_mm(self._mv),
            matmat_transp=_scale_mm(self._rmv)
                          if self._rmv is not None else None,
            params=(self, a), _takes_params=True,
            symmetric=self.symmetric,
            hermitian=self.hermitian and not np.issubdtype(rdt, np.complexfloating),
            dtype=rdt)

    def _mul_linop(self, other):
        if self.nargin != other.nargout:
            raise ShapeError("cannot multiply %s with %s" % (repr(self), repr(other)))
        rdt = jnp.result_type(self.dtype, other.dtype)
        return LinearOperator(
            other.nargin, self.nargout,
            matvec=_compose_mv(self._mv, other._mv),
            # (AB)^T = B^T A^T : params order is (A, B) so swap the roles.
            matvec_transp=(lambda p, x: p[1].apply_with(p[1]._rmv, p[0].apply_with(p[0]._rmv, x)))
                          if (self._rmv is not None and other._rmv is not None) else None,
            matvec_adj=(lambda p, x: p[1].apply_with(p[1]._hmv, p[0].apply_with(p[0]._hmv, x)))
                       if (self._hmv is not None and other._hmv is not None) else None,
            matmat=_compose_mm(self._mv, other._mv),
            matmat_transp=_compose_mm(other._rmv, self._rmv, swap=True)
                          if (self._rmv is not None and other._rmv is not None) else None,
            params=(self, other), _takes_params=True,
            symmetric=False, hermitian=False, dtype=rdt)

    def _mul_vector(self, x):
        return self._apply(self._mv, x, self.nargin, self.nargout)

    def __mul__(self, x):
        if isinstance(x, BaseLinearOperator):
            return self._mul_linop(x)
        if np.isscalar(x) and not isinstance(x, (jnp.ndarray, np.ndarray)):
            return self._mul_scalar(x)
        if isinstance(x, (jnp.ndarray, np.ndarray)) and jnp.ndim(x) == 0:
            return self._mul_scalar(x)
        if isinstance(x, (jnp.ndarray, np.ndarray, list, tuple)):
            return self._mul_vector(x)
        return NotImplemented

    def __rmul__(self, x):
        if np.isscalar(x) or (isinstance(x, (jnp.ndarray, np.ndarray)) and jnp.ndim(x) == 0):
            return self._mul_scalar(x)
        raise ValueError("cannot pre-multiply an operator by %s" % type(x))

    def __matmul__(self, x):
        return self.__mul__(x)

    def __add__(self, other):
        if not isinstance(other, BaseLinearOperator):
            raise ValueError("cannot add %s to an operator" % type(other))
        if self.shape != other.shape:
            raise ShapeError("cannot add %s and %s" % (repr(self), repr(other)))
        rdt = jnp.result_type(self.dtype, other.dtype)
        return LinearOperator(
            self.nargin, self.nargout,
            matvec=_add_mv(self._mv, other._mv),
            matvec_transp=_add_mv(self._rmv, other._rmv)
                          if (self._rmv is not None and other._rmv is not None) else None,
            matvec_adj=_add_mv(self._hmv, other._hmv)
                       if (self._hmv is not None and other._hmv is not None) else None,
            matmat=_add_mm(self._mv, other._mv),
            matmat_transp=_add_mm(self._rmv, other._rmv)
                          if (self._rmv is not None and other._rmv is not None) else None,
            params=(self, other), _takes_params=True,
            symmetric=self.symmetric and other.symmetric,
            hermitian=self.hermitian and other.hermitian,
            dtype=rdt)

    def __neg__(self):
        return self._mul_scalar(-1)

    def __sub__(self, other):
        if not isinstance(other, BaseLinearOperator):
            raise ValueError("cannot subtract %s from an operator" % type(other))
        return self.__add__(-other)

    def __truediv__(self, other):
        if np.isscalar(other) or (isinstance(other, (jnp.ndarray, np.ndarray)) and jnp.ndim(other) == 0):
            if isinstance(other, (int, float, complex)) and other == 0:
                raise ZeroDivisionError("cannot divide operator by zero")
            return self._mul_scalar(1.0 / other)
        raise ValueError("cannot divide operator by %s" % type(other))

    __div__ = __truediv__

    def __pow__(self, k):
        if not isinstance(k, int):
            raise ValueError("power must be a nonnegative integer")
        if k < 0:
            raise ValueError("power must be a nonnegative integer")
        if self.nargin != self.nargout:
            raise ShapeError("can only raise square operators to a power")
        if k == 0:
            return IdentityOperator(self.nargin, dtype=self.dtype)
        if k == 1:
            return self
        return LinearOperator(
            self.nargin, self.nargout,
            matvec=_pow_mv(k),
            matvec_transp=_pow_rmv(k) if self._rmv is not None else None,
            matvec_adj=_pow_hmv(k) if self._hmv is not None else None,
            matmat=_pow_mm("_mv", k),
            matmat_transp=_pow_mm("_rmv", k)
                          if self._rmv is not None else None,
            params=(self,), _takes_params=True,
            symmetric=self.symmetric, hermitian=self.hermitian,
            dtype=self.dtype)

    def _sqrt(self):
        raise NotImplementedError("no operator square root for %s" % repr(self))


def _lo_flatten(op):
    aux = op._aux()
    return (op._params,), aux


def _lo_unflatten(aux, children):
    (cls, nargin, nargout, mv, rmv, hmv, symmetric, hermitian, dtype, name,
     mm, rmm) = aux
    obj = LinearOperator.__new__(LinearOperator)
    BaseLinearOperator.__init__(obj, nargin, nargout, symmetric=symmetric,
                                hermitian=hermitian, dtype=dtype, name=name)
    obj._params = children[0]
    obj._mv, obj._rmv, obj._hmv = mv, rmv, hmv
    obj._mm, obj._rmm = mm, rmm
    obj._transpose_of = obj._adjoint_of = obj._conjugate_of = None
    return obj


register_pytree_node(LinearOperator, _lo_flatten, _lo_unflatten)


# ---------------------------------------------------------------------------
# Simple concrete operators
# ---------------------------------------------------------------------------


def _subclass_flatten(op):
    return (op._params,), op._aux()


def _register_as_linop(cls):
    """Subclasses flatten to a plain LinearOperator (algebra-equivalent)."""
    register_pytree_node(cls, _subclass_flatten, _lo_unflatten)
    return cls


def _identity_mv(params, x):
    return x


@_register_as_linop
class IdentityOperator(LinearOperator):
    """I_n (``linop.py:455-470``)."""

    def __init__(self, nargin, dtype=None, **kwargs):
        super().__init__(nargin, nargin, matvec=_identity_mv,
                         params=(), _takes_params=True,
                         symmetric=True, hermitian=True, dtype=dtype, **kwargs)

    def _sqrt(self):
        return self

    def __abs__(self):
        return self


def _diag_mv(params, x):
    return params * x


def _diag_hmv(params, x):
    return jnp.conj(params) * x


@_register_as_linop
class DiagonalOperator(LinearOperator):
    """diag(d) from a 1-D array (``linop.py:473-516``).

    Complex diagonals are symmetric but not hermitian; the adjoint applies
    the conjugate diagonal.
    """

    def __init__(self, diag, **kwargs):
        diag = _as_jnp(diag).ravel()
        n = diag.shape[0]
        is_complex = np.issubdtype(diag.dtype, np.complexfloating)
        super().__init__(n, n, matvec=_diag_mv,
                         matvec_adj=_diag_hmv if is_complex else None,
                         params=diag, _takes_params=True,
                         symmetric=True, hermitian=not is_complex,
                         dtype=diag.dtype, **kwargs)

    @property
    def diag(self):
        return self._params

    def __abs__(self):
        return DiagonalOperator(jnp.abs(self._params))

    def _sqrt(self):
        if (not np.issubdtype(self.dtype, np.complexfloating)):
            # Match reference: refuse square root of an indefinite diagonal.
            if bool(jnp.any(self._params < 0)):
                raise ValueError("math domain error: negative diagonal entries")
        return DiagonalOperator(jnp.sqrt(self._params))


@_functools.lru_cache(maxsize=None)
def _zero_mv_factory(nargout):
    def mv(params, x):
        dt = jnp.result_type(params, x.dtype)
        return jnp.zeros(nargout, dtype=dt)
    return mv


@_register_as_linop
class ZeroOperator(LinearOperator):
    """0 of shape nargout x nargin (``linop.py:519-557``)."""

    def __init__(self, nargin, nargout, dtype=None, **kwargs):
        dtype = np.dtype(dtype if dtype is not None else jnp.zeros(0).dtype)
        # params carries a zero-size array of the dtype so promotion works.
        super().__init__(nargin, nargout,
                         matvec=_zero_mv_factory(nargout),
                         matvec_transp=_zero_mv_factory(nargin),
                         params=jnp.zeros((0,), dtype=dtype), _takes_params=True,
                         symmetric=(nargin == nargout),
                         hermitian=(nargin == nargout),
                         dtype=dtype, **kwargs)

    def __abs__(self):
        return self

    def _sqrt(self):
        return self


def _dense_mv(params, x):
    return jnp.dot(params, x, precision=jax.lax.Precision.HIGHEST)


def _dense_rmv(params, x):
    return jnp.dot(params.T, x, precision=jax.lax.Precision.HIGHEST)


def _dense_hmv(params, x):
    return jnp.dot(jnp.conj(params).T, x, precision=jax.lax.Precision.HIGHEST)


@_register_as_linop
class MatrixOperator(LinearOperator):
    """Dense-matrix operator; matvecs are ``jnp.dot`` at HIGHEST precision.

    Device equivalent of ``linop_from_ndarray`` (``linop.py:723-745``).
    """

    def __init__(self, A, symmetric=False, hermitian=False, **kwargs):
        A = _as_jnp(A)
        if A.ndim != 2:
            raise ShapeError("MatrixOperator expects a 2-D array")
        m, n = A.shape
        super().__init__(n, m, matvec=_dense_mv, matvec_transp=_dense_rmv,
                         matvec_adj=_dense_hmv, params=A, _takes_params=True,
                         symmetric=symmetric, hermitian=hermitian,
                         dtype=A.dtype, **kwargs)

    @property
    def matrix(self):
        return self._params

    def to_array(self):
        return self._params


def linop_from_ndarray(A, symmetric=False, hermitian=False, **kwargs):
    """Operator from a dense array (parity alias; ``linop.py:723-745``)."""
    return MatrixOperator(A, symmetric=symmetric, hermitian=hermitian, **kwargs)


# ---------------------------------------------------------------------------
# COO operator
# ---------------------------------------------------------------------------


@_functools.lru_cache(maxsize=None)
def _coo_mv_factory(nargout, symmetric):
    def mv(params, x):
        vals, rows, cols = params
        y = jax.ops.segment_sum(vals * x[cols], rows, num_segments=nargout)
        if symmetric:
            off = jnp.where(rows != cols, vals, jnp.zeros_like(vals))
            y = y + jax.ops.segment_sum(off * x[rows], cols, num_segments=nargout)
        return y
    return mv


@_functools.lru_cache(maxsize=None)
def _coo_rmv_factory(nargin, symmetric):
    def mv(params, x):
        vals, rows, cols = params
        y = jax.ops.segment_sum(vals * x[rows], cols, num_segments=nargin)
        if symmetric:
            off = jnp.where(rows != cols, vals, jnp.zeros_like(vals))
            y = y + jax.ops.segment_sum(off * x[cols], rows, num_segments=nargin)
        return y
    return mv


@_register_as_linop
class CoordLinearOperator(LinearOperator):
    """Operator from COO triples (vals, rows, cols).

    The reference loops over nonzeros in Python (``linop.py:638-685``); here
    the matvec is a vectorized gather + ``segment_sum`` (an XLA scatter-add),
    which is the vectorized expression of the same contraction.  When
    ``symmetric=True`` only one triangle is stored and the mirrored
    contribution is added on the fly, as in the reference.
    """

    def __init__(self, vals, rows, cols, nargin=0, nargout=0,
                 symmetric=False, **kwargs):
        vals = _as_jnp(vals).ravel()
        rows = _as_jnp(rows).ravel().astype(jnp.int32)
        cols = _as_jnp(cols).ravel().astype(jnp.int32)
        if not (vals.shape == rows.shape == cols.shape):
            raise ShapeError("vals, rows, cols must have matching lengths")
        if nargin == 0:
            nargin = int(cols.max()) + 1 if cols.size else 0
        if nargout == 0:
            nargout = int(rows.max()) + 1 if rows.size else 0
        super().__init__(nargin, nargout,
                         matvec=_coo_mv_factory(nargout, symmetric),
                         matvec_transp=_coo_rmv_factory(nargin, symmetric),
                         params=(vals, rows, cols), _takes_params=True,
                         symmetric=symmetric,
                         hermitian=symmetric and not np.issubdtype(vals.dtype, np.complexfloating),
                         dtype=vals.dtype, **kwargs)

    @property
    def vals(self):
        return self._params[0]

    @property
    def rows(self):
        return self._params[1]

    @property
    def cols(self):
        return self._params[2]


@_register_as_linop
class PysparseLinearOperator(LinearOperator):
    """Adapter for external sparse-matrix objects (``linop.py:688-720``).

    The reference wraps pysparse matrices; pysparse is long dead, so this
    adapter accepts any host object exposing ``shape`` and either
    ``matvec(x, y)``/``matvec_transp(x, y)`` (pysparse protocol) or ``A @ x``
    (scipy.sparse protocol).  Application goes through
    ``jax.pure_callback`` so the operator remains jit-compatible; for
    performance-critical paths convert to a native container in
    :mod:`pykrylov_tpu.sparse` instead.

    Note: each application is a device-to-host round trip; keep it off
    hot loops.
    """

    def __init__(self, A, **kwargs):
        m, n = A.shape
        dtype = np.dtype(getattr(A, "dtype", np.float64))
        issym = bool(getattr(A, "issym", False))

        def _host_mv(x):
            x = np.asarray(x)
            if hasattr(A, "matvec") and not hasattr(A, "dot"):
                y = np.empty(m, dtype=dtype)
                A.matvec(x, y)
                return y
            return np.asarray(A @ x, dtype=dtype).ravel()

        def _host_rmv(x):
            x = np.asarray(x)
            if issym:
                return _host_mv(x)
            if hasattr(A, "matvec_transp"):
                y = np.empty(n, dtype=dtype)
                A.matvec_transp(x, y)
                return y
            return np.asarray(A.T @ x, dtype=dtype).ravel()

        def mv(params, x):
            return jax.pure_callback(
                _host_mv, jax.ShapeDtypeStruct((m,), dtype), x, vmap_method="sequential")

        def rmv(params, x):
            return jax.pure_callback(
                _host_rmv, jax.ShapeDtypeStruct((n,), dtype), x, vmap_method="sequential")

        super().__init__(n, m, matvec=mv, matvec_transp=rmv,
                         params=(), _takes_params=True,
                         symmetric=issym, dtype=dtype, **kwargs)


# ---------------------------------------------------------------------------
# Reduced operators
# ---------------------------------------------------------------------------


def _reduced_mv(params, x):
    o, ri, ci = params
    z = jnp.zeros(o.nargin, dtype=jnp.result_type(o.dtype, x.dtype))
    z = z.at[ci].set(x)
    return o.apply_with(o._mv, z)[ri]


def _reduced_rmv(params, x):
    o, ri, ci = params
    z = jnp.zeros(o.nargout, dtype=jnp.result_type(o.dtype, x.dtype))
    z = z.at[ri].set(x)
    return o.apply_with(o._rmv, z)[ci]


def _symreduced_mv(params, x):
    o, ix = params
    z = jnp.zeros(o.nargin, dtype=jnp.result_type(o.dtype, x.dtype))
    z = z.at[ix].set(x)
    return o.apply_with(o._mv, z)[ix]


def _symreduced_rmv(params, x):
    o, ix = params
    z = jnp.zeros(o.nargout, dtype=jnp.result_type(o.dtype, x.dtype))
    z = z.at[ix].set(x)
    return o.apply_with(o._rmv, z)[ix]


def ReducedLinearOperator(op, row_indices, col_indices):
    """Restriction of ``op`` to row/column index subsets (``linop.py:560-591``).

    Implemented as scatter -> full matvec -> gather, exactly the reference
    semantics but expressed with XLA scatter/gather so it stays traceable.
    Not flagged symmetric even if ``op`` is (different index sets).
    """
    row_idx = jnp.asarray(row_indices, dtype=jnp.int32).ravel()
    col_idx = jnp.asarray(col_indices, dtype=jnp.int32).ravel()
    m, n = int(row_idx.shape[0]), int(col_idx.shape[0])
    return LinearOperator(n, m, matvec=_reduced_mv,
                          matvec_transp=_reduced_rmv,
                          params=(op, row_idx, col_idx), _takes_params=True,
                          symmetric=False, dtype=op.dtype)


def SymmetricallyReducedLinearOperator(op, indices):
    """Symmetric restriction to one index set (``linop.py:594-623``)."""
    idx = jnp.asarray(indices, dtype=jnp.int32).ravel()
    k = int(idx.shape[0])
    return LinearOperator(k, k, matvec=_symreduced_mv,
                          matvec_transp=_symreduced_rmv,
                          params=(op, idx), _takes_params=True,
                          symmetric=op.symmetric, hermitian=op.hermitian,
                          dtype=op.dtype)


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def sqrt(op):
    """Operator square root, dispatching to ``op._sqrt`` (``linop.py:748-754``)."""
    return op._sqrt()


def aslinearoperator(A, symmetric=False, hermitian=False):
    """Coerce A (operator / dense array / callable) into a LinearOperator."""
    if isinstance(A, BaseLinearOperator):
        return A
    if isinstance(A, (jnp.ndarray, np.ndarray)):
        return MatrixOperator(A, symmetric=symmetric, hermitian=hermitian)
    if callable(A):
        raise ValueError(
            "cannot infer shape from a bare callable; construct "
            "LinearOperator(nargin, nargout, matvec=...) explicitly")
    raise TypeError("cannot convert %s to a LinearOperator" % type(A))
