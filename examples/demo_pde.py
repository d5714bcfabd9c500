"""PDE demo: assembled 2-D Poisson system with raw-closure operators.

Parity analogue of the reference's FEniCS example
(``/root/reference/examples/fenics.py:47-68``), which assembles a 2-D
Poisson FEM system and passes the assembled matrix and a diagonal
preconditioner to CG as *raw closures*.  dolfin is not available here, so
this demo assembles the standard 5-point finite-difference Poisson system
on the unit square with a manufactured solution, wraps the stencil as a
matrix-free :class:`LinearOperator` closure, and solves with diagonal
preconditioning — same shape of usage, no external PDE stack.
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import jax as _jax
_jax.config.update("jax_enable_x64", True)

import numpy as np
import jax.numpy as jnp

from pykrylov_tpu.ops import LinearOperator, DiagonalOperator
from pykrylov_tpu.solvers import cg
from pykrylov_tpu.gallery import poisson2d_matvec

if __name__ == "__main__":
    n = 64                      # interior grid points per side
    h = 1.0 / (n + 1)
    N = n * n

    # Matrix-free assembled operator: (1/h^2) * 5-point stencil.
    A = LinearOperator(
        N, N, matvec=lambda p, x: poisson2d_matvec(x) / h**2,
        params=(), _takes_params=True, symmetric=True, hermitian=True,
        dtype=np.float64)

    # Manufactured solution u = x(1-x) y(1-y): -lap u = 2[x(1-x)+y(1-y)].
    # (Not an eigenfunction of the discrete Laplacian, so the solve does
    # real Krylov work.)
    xs = (np.arange(1, n + 1) * h)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u_exact = X * (1 - X) * Y * (1 - Y)
    f = 2.0 * (X * (1 - X) + Y * (1 - Y))

    M = DiagonalOperator(jnp.full(N, h**2 / 4.0))  # diag(A)^{-1}

    res = cg(A, jnp.asarray(f.ravel()), M=M, rtol=1e-10)
    u = np.asarray(res.x).reshape(n, n)
    # Discretization error is O(h^2); solver error is far below it.
    err = np.max(np.abs(u - u_exact))
    print("CG converged=%s iters=%d resid=%.2e" % (
        bool(res.converged), int(res.n_iter), float(res.resid_norm)))
    print("max |u - u_exact| = %.3e (O(h^2) = %.3e)" % (err, h**2))
    assert bool(res.converged) and err < 10 * h**2
