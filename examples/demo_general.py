"""General-sparsity + verified-f32 demo (round-2 JAX-native surface).

Shows the two features with no reference counterpart:

1. the automatic format choice for a large general matrix (XLA ELL, the
   reference's pysparse C SpMV role, ``linop/linop.py:697-706``),
   driving BiCGSTAB with a verified final residual;
2. verified residual-replacement CG certifying rtol 1e-6 in f32 on the
   ill-conditioned 1138bus system — the plain f32 recurrence claims
   convergence its true residual does not support.

Runs on the default device (set JAX_PLATFORMS=cpu for the CPU).
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import numpy as np
import jax
import jax.numpy as jnp

from pykrylov_tpu.gallery.general import tiled_general_coo
from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.sparse import sparse_operator
from pykrylov_tpu.solvers.bicgstab import bicgstab
from pykrylov_tpu.solvers.cg import cg


def general_spmv_demo():
    # nonsymmetric banded general matrix, diagonally dominant (f32-
    # friendly: BiCGSTAB's recurrence stagnates on jpwh-class matrices
    # in f32 — use rtol within the attainable range and VERIFY)
    rng = np.random.default_rng(0)
    n = 63424
    k = 8
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-1500, 1501, size=n * k), 0, n - 1)
    vals = rng.standard_normal(n * k).astype(np.float32) * 0.1
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 2.0, np.float32)])

    op = sparse_operator((vals, rows, cols, (n, n)), fmt="auto")
    print("general %dx%d, %d nnz -> auto format: %s"
          % (n, n, len(vals), type(op.container).__name__))

    b = op * jnp.ones(n, jnp.float32)
    res = bicgstab(op, b, rtol=1e-4, verify_final=True)
    print("BiCGSTAB: converged=%s matvecs=%d claimed resid=%.2e "
          "VERIFIED true resid=%.2e"
          % (bool(res.converged), int(res.n_matvec),
             float(res.resid_norm), float(res.info["true_resid_norm"])))


def verified_cg_demo():
    vals, rows, cols, shape = load_bundled("1138bus")
    op = sparse_operator((vals.astype(np.float32), rows, cols, shape),
                         symmetric=True, fmt="ell")
    b = op * jnp.ones(shape[0], jnp.float32)

    plain = cg(op, b, rtol=1e-6, atol=0.0, maxiter=20000)
    ver = cg(op, b, rtol=1e-6, atol=0.0, maxiter=20000, replace_every=1000)

    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    bb = np.asarray(b, np.float64)

    def true_rel(x):
        return (np.linalg.norm(a @ np.asarray(x, np.float64) - bb)
                / np.linalg.norm(bb))

    print("1138bus f32 @ rtol 1e-6 (claimed vs TRUE relative residual):")
    print("  plain recurrence: claimed %.1e  TRUE %.1e  (%d matvecs)"
          % (float(plain.resid_norm / plain.resid_norm0),
             true_rel(plain.x), int(plain.n_matvec)))
    print("  verified+compensated: claimed %.1e  TRUE %.1e  (%d matvecs,"
          " %d replacements)"
          % (float(ver.resid_norm / ver.resid_norm0), true_rel(ver.x),
             int(ver.n_matvec), int(ver.info["n_replacements"])))


if __name__ == "__main__":
    general_spmv_demo()
    verified_cg_demo()
