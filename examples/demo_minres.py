"""MINRES demo (parity: ``/root/reference/examples/demo_minres.py``).

Solves A x = A·e on a symmetric matrix (default the bundled 1138bus).
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import jax as _jax
# The demo protocol reproduces the reference's float64 numbers (1138bus is
# too ill-conditioned for f32); f64 is native on the GPU.  The default
# device is used; set JAX_PLATFORMS=cpu to run on the CPU.
_jax.config.update("jax_enable_x64", True)

import logging
import sys
from math import sqrt

import numpy as np
import jax.numpy as jnp

FLOAT = jnp.zeros(0).dtype  # f64 when x64 enabled, else f32

from pykrylov_tpu.compat import Minres
from demo_common import HDR, FMT, load_operator

if __name__ == "__main__":
    log = logging.getLogger("MINRES")
    log.setLevel(logging.INFO)
    fmt = logging.Formatter("%(name)-2s %(levelname)-8s %(message)s")
    hndlr = logging.StreamHandler(sys.stdout)
    hndlr.setFormatter(fmt)
    log.addHandler(hndlr)

    mtx = sys.argv[1] if len(sys.argv) > 1 else "1138bus"
    op = load_operator(mtx, symmetric=True)
    n = op.nargin
    rhs = op * jnp.ones(n, dtype=FLOAT)

    K = Minres(op, logger=log)
    K.solve(rhs, rtol=1.0e-10)

    err = float(np.linalg.norm(np.asarray(K.bestSolution) - 1.0)) / sqrt(n)
    print()
    print(HDR)
    print("-" * len(HDR))
    print(FMT % (K.acronym, K.nMatvec, K.residNorm0, K.residNorm, err))
