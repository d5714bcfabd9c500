"""Cholesky-based inverse operators.

JAX-native equivalents of the reference's CHOLMOD wrapper
(``/root/reference/pykrylov/linop/cholesky.py:15-43``), which exposes the
*inverse* of an SPD matrix as an operator via a sparse Cholesky
factorization.  CHOLMOD-class supernodal sparse factorization has no
XLA primitive; per SURVEY §2.5 the build provides:

  * :class:`CholeskyOperator` — on-device **dense** Cholesky
    (``jax.scipy.linalg.cho_factor``); right choice for the
    moderate-n systems where the reference used CHOLMOD.
  * :class:`HostFactorizationOperator` — escape hatch that runs any
    host-side factorization (scipy ``splu``/``cho_factor``, CHOLMOD, ...)
    through ``jax.pure_callback`` so it can still serve as ``precon`` inside
    a jitted solver.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .base import LinearOperator, MatrixOperator, _register_as_linop

__all__ = ["CholeskyOperator", "HostFactorizationOperator"]


def _chol_mv(params, x):
    c = params  # lower-triangular factor
    y = jax.scipy.linalg.solve_triangular(c, x, lower=True)
    return jax.scipy.linalg.solve_triangular(c.T.conj(), y, lower=False)


class CholeskyOperator(LinearOperator):
    """Operator representing A^{-1} for SPD A via on-device dense Cholesky.

    ``A`` may be a dense array, a :class:`MatrixOperator`, or any operator
    (densified via ``to_array``).  The factorization happens once at
    construction; each matvec is two triangular solves.
    """

    def __init__(self, A, **kwargs):
        if isinstance(A, LinearOperator):
            A = A.to_array()
        A = jnp.asarray(A)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError("CholeskyOperator requires a square matrix")
        n = A.shape[0]
        c = jnp.linalg.cholesky(A)
        super().__init__(n, n, matvec=_chol_mv, params=c, _takes_params=True,
                         symmetric=True,
                         hermitian=True,
                         dtype=A.dtype, **kwargs)

    cholesky_matvec = LinearOperator.matvec

    @property
    def factor(self):
        return self._params


_register_as_linop(CholeskyOperator)


class HostFactorizationOperator(LinearOperator):
    """Wrap a host-side ``solve(rhs) -> x`` callable as a jit-safe operator.

    Use for factorizations with no device analogue (sparse Cholesky/LU): the
    factorization lives on the host; each application crosses to the host
    via ``jax.pure_callback``.  Intended for preconditioning where the
    per-iteration solve is cheap relative to device work, mirroring the
    role of the reference ``CholeskyOperator``.

    Parameters
    ----------
    n : problem dimension.
    host_solve : callable taking / returning 1-D numpy arrays of length n.
    symmetric / hermitian : structure flags of the implied inverse.
    """

    def __init__(self, n, host_solve, symmetric=True, hermitian=True,
                 dtype=np.float64, **kwargs):
        dtype = np.dtype(dtype)

        def _host(x):
            return np.asarray(host_solve(np.asarray(x)), dtype=dtype).ravel()

        def mv(params, x):
            return jax.pure_callback(
                _host, jax.ShapeDtypeStruct((n,), dtype), x,
                vmap_method="sequential")

        super().__init__(n, n, matvec=mv, params=(), _takes_params=True,
                         symmetric=symmetric, hermitian=hermitian,
                         dtype=dtype, **kwargs)

    @classmethod
    def from_scipy_spd(cls, A_scipy):
        """Factorize a scipy.sparse SPD matrix on the host (LU fallback)."""
        from scipy.sparse.linalg import factorized
        solve = factorized(A_scipy.tocsc())
        return cls(A_scipy.shape[0], solve, dtype=A_scipy.dtype)


_register_as_linop(HostFactorizationOperator)
