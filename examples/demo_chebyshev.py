"""Chebyshev polynomial preconditioning demo: 3-D Poisson on one chip.

The reference's only factorization preconditioner is the CHOLMOD
``CholeskyOperator`` (``/root/reference/pykrylov/linop/cholesky.py``),
whose sparse triangular solves are sequential.  The JAX-native
alternative is matvec-only: estimate spectral bounds with a fused
Lanczos sweep, build ``p(A) ~ A^{-1}`` as a fixed-degree Chebyshev
polynomial, and hand it to CG as ``M=`` — each outer iteration then
does the work of ``degree`` plain ones while paying the dot-product
(and, on meshes, psum-latency) barriers once.

Run from anywhere: ``python examples/demo_chebyshev.py [grid_n]``.
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # repo root

import numpy as np
import jax
import jax.numpy as jnp

from pykrylov_tpu.gallery.poisson import poisson3d_coo
from pykrylov_tpu.sparse.linop import operator_from_coo
from pykrylov_tpu.ops import chebyshev_preconditioner, lanczos_bounds
from pykrylov_tpu.solvers import cg


def main(grid_n=None):
    n = grid_n or 64
    vals, rows, cols, shape = poisson3d_coo(n, dtype=np.float32)
    A = operator_from_coo(vals, rows, cols, shape, symmetric=True)
    m = shape[0]
    print("3-D Poisson grid %d^3 -> %d unknowns (%s)"
          % (n, m, jax.devices()[0]))
    b = jnp.ones(m, jnp.float32)

    lmin, lmax = lanczos_bounds(A, k=16)
    print("Lanczos bounds: [%.4f, %.4f]" % (float(lmin), float(lmax)))

    plain = cg(A, b, rtol=1e-6)
    print("plain CG      : %4d iterations, converged=%s"
          % (int(plain.n_iter), bool(plain.converged)))
    for degree in (4, 8, 16):
        M = chebyshev_preconditioner(A, degree=degree,
                                     bounds=(lmin, lmax))
        pre = cg(A, b, M=M, rtol=1e-6)
        matvecs = int(pre.n_iter) * degree
        print("Chebyshev(%2d) : %4d iterations (~%4d matvec-equivalents),"
              " converged=%s"
              % (degree, int(pre.n_iter), matvecs, bool(pre.converged)))
        r = float(jnp.linalg.norm(b - A * pre.x)
                  / jnp.linalg.norm(b))
        print("                true relative residual %.2e" % r)


if __name__ == "__main__":
    main(int(_sys.argv[1]) if len(_sys.argv) > 1 else None)
