"""Benchmark script (parity: ``/root/reference/examples/bmark.py``).

Runs CGS, TFQMR and Bi-CGSTAB on a matrix (bundled name or .mtx path;
default jpwh_991, the matrix the reference's published table uses) with
rhs = A·e, guess = 1 + arange(n), reltol 1e-8, matvec_max 2n, and prints
the reference's table.  ``--precon`` enables the diagonal preconditioner
M = diag(1/max(|a_ii|, 1)) (reference ``DiagonalPrec``, bmark.py:14-23).

Reference numbers (doc/source/bmark.rst): unpreconditioned CGS 82 /
TFQMR 84 / BiCGSTAB 84 matvecs; preconditioned 70 / 70 / 64.
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import jax as _jax
# The benchmark's metric is matvec counts (convergence quality, the
# reference's published table), reproduced in f64 on the default device
# (set JAX_PLATFORMS=cpu to run on the CPU).  Wall-clock SpMV rates are
# bench.py's.
_jax.config.update("jax_enable_x64", True)


import argparse
from math import sqrt

import numpy as np
import jax.numpy as jnp

FLOAT = jnp.zeros(0).dtype  # f64 when x64 enabled, else f32

from pykrylov_tpu.compat import CGS, TFQMR, BiCGSTAB
from pykrylov_tpu.sparse import jacobi_preconditioner
from demo_common import HDR, FMT, load_operator


def main():
    p = argparse.ArgumentParser()
    p.add_argument("matrix", nargs="?", default="jpwh_991",
                   help="bundled matrix name or .mtx path")
    p.add_argument("--precon", action="store_true",
                   help="use the diagonal preconditioner")
    args = p.parse_args()

    print(HDR)
    print("-" * len(HDR))

    op = load_operator(args.matrix)
    dp = jacobi_preconditioner(args.matrix, floor=1.0) if args.precon \
        else None

    n = op.nargin
    e = jnp.ones(n, dtype=FLOAT)
    rhs = op * e

    for KSolver in (CGS, TFQMR, BiCGSTAB):
        ks = KSolver(op, precon=dp, reltol=1.0e-8)
        ks.solve(rhs, guess=1.0 + jnp.arange(n, dtype=FLOAT),
                 matvec_max=2 * n)
        err = float(np.linalg.norm(np.asarray(ks.bestSolution) - 1.0)) \
            / sqrt(n)
        print(FMT % (ks.acronym, ks.nMatvec, ks.residNorm0, ks.residNorm,
                     err))


if __name__ == "__main__":
    main()
