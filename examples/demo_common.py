"""Shared demo driver (parity: ``/root/reference/examples/demo_common.py``).

``demo(KSolver, source, **kwargs)`` builds the operator from a bundled
matrix name, a MatrixMarket file path, or anything
:func:`pykrylov_tpu.sparse.sparse_operator` accepts; solves with
rhs = A·e, guess = 1 + arange(n), reltol 1e-8, matvec_max 2n, and prints
the reference's result table.
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import jax as _jax
# The demo protocol reproduces the reference's float64 numbers (1138bus is
# too ill-conditioned for f32); f64 is native on the GPU.  The default
# device is used; set JAX_PLATFORMS=cpu to run on the CPU.
_jax.config.update("jax_enable_x64", True)


import os
from math import sqrt

import numpy as np
import jax.numpy as jnp

FLOAT = jnp.zeros(0).dtype  # f64 when x64 enabled, else f32

from pykrylov_tpu.sparse import sparse_operator

HDR_FMT = "%10s  %6s  %8s  %8s  %8s"
HDR = HDR_FMT % ("Name", "Matvec", "Resid0", "Resid", "Error")
FMT = "%10s  %6d  %8.2e  %8.2e  %8.2e"


def load_operator(source, symmetric=None):
    """Operator from a bundled name ('1138bus') or a .mtx file path."""
    if isinstance(source, str) and os.path.exists(source):
        from pykrylov_tpu.io.matrix_market import read_matrix_market
        vals, rows, cols, shape, info = read_matrix_market(source)
        if symmetric is None:
            symmetric = info.symmetry == "symmetric"
        return sparse_operator((vals, rows, cols, shape),
                               symmetric=symmetric)
    if symmetric is None:
        from pykrylov_tpu.io.datasets import BUNDLED
        symmetric = BUNDLED.get(source, ((0, 0), False, ""))[1]
    return sparse_operator(source, symmetric=symmetric)


def demo(KSolver, source, symmetric=None, **kwargs):
    op = load_operator(source, symmetric=symmetric)
    n = op.nargin
    e = jnp.ones(n, dtype=FLOAT)
    rhs = op * e

    ks = KSolver(op, reltol=1.0e-8, **{
        k: kwargs.pop(k) for k in ("logger", "precon") if k in kwargs})
    ks.solve(rhs, guess=1.0 + jnp.arange(n, dtype=FLOAT),
             matvec_max=2 * n, **kwargs)

    err = float(np.linalg.norm(np.asarray(ks.bestSolution) - 1.0)) / sqrt(n)
    print()
    print(HDR)
    print("-" * len(HDR))
    print(FMT % (ks.acronym, ks.nMatvec, ks.residNorm0, ks.residNorm, err))
    return ks
