"""Multi-RHS block-batched demo: the reference bmark trio, K systems at
once.

The reference benchmark (``/root/reference/examples/bmark.py:45-51``)
solves ONE system with CGS, TFQMR and Bi-CGSTAB in sequence.  The
JAX-native framework turns the same protocol sideways: ONE fused
while-loop per method solves an (n, K) block of right-hand sides, and
the operator's block product serves all K systems in one pass per
iteration.

Run from anywhere: ``python examples/demo_batched.py [K]``.
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # repo root

import numpy as np
import jax
import jax.numpy as jnp

from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.sparse import sparse_operator, jacobi_preconditioner
from pykrylov_tpu.solvers import (bicgstab_batched, cgs_batched,
                                  tfqmr_batched)


def main(K=4):
    n = load_bundled("jpwh_991")[3][0]
    A = sparse_operator("jpwh_991", dtype=np.float32)
    M = jacobi_preconditioner("jpwh_991")

    # K right-hand sides: the bmark rhs (A @ ones) plus random solutions
    rng = np.random.default_rng(0)
    Xtrue = np.concatenate(
        [np.ones((n, 1)), rng.standard_normal((n, K - 1))],
        axis=1).astype(np.float32)
    B = A @ jnp.asarray(Xtrue)
    x0 = jnp.asarray(np.tile((1.0 + np.arange(n))[:, None], (1, K)),
                     jnp.float32)

    # rtol 1e-5: the attainable f32 range for this system (the reference
    # runs its 1e-8 protocol in f64; see solvers/batched.py on the f32
    # trajectory floor, and refined_solve for verified f64-class tols)
    print("jpwh_991, K=%d right-hand sides, rtol 1e-5, Jacobi precon, "
          "backend=%s" % (K, jax.default_backend()))
    print("%10s %22s %14s %12s" % ("Name", "Matvecs/col", "max |resid|",
                                   "max err"))
    print("-" * 64)
    for name, solver in (("CGS", cgs_batched),
                         ("TFQMR", tfqmr_batched),
                         ("Bi-CGSTAB", bicgstab_batched)):
        res = solver(A, B, x0=x0, M=M, rtol=1e-5, matvec_max=2 * n)
        err = float(jnp.abs(res.x - jnp.asarray(Xtrue)).max())
        nmv = np.asarray(res.info["n_matvec_columns"]).tolist()
        print("%10s %22s %14.3e %12.3e" %
              (name, nmv, float(jnp.max(res.resid_norm)), err))


if __name__ == "__main__":
    main(int(_sys.argv[1]) if len(_sys.argv) > 1 else 4)
