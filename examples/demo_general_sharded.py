"""Sharded GENERAL-sparsity demo: partition-time gather schedule with
XLA ELL local compute (`parallel.GatherEllOperator`).

The reference's multi-matrix story was single-process pysparse C SpMV
(`examples/bmark.py:34`); the JAX-native equivalent shards the rows over
a device mesh, exchanges only the x entries each device actually
references (one ppermute round per mesh shift), and runs the ELL product
on each local block.  Prints the solve summary and the measured
communication volume vs the all-gather fallback.

Runs on the default devices; for a virtual mesh on a CPU host set
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``.

Usage: python demo_general_sharded.py
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from pykrylov_tpu.parallel import (make_mesh, shard_vector,
                                   GatherEllOperator)
from pykrylov_tpu.sparse import formats as F
from pykrylov_tpu.solvers import cg


def main():
    rng = np.random.default_rng(0)
    n, per_row, bw = 4096, 6, 220
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=len(rows)),
                   0, n - 1)
    vals = rng.standard_normal(len(rows)) * 0.05
    # symmetrize + diagonal dominance -> SPD for CG
    rows_s = np.concatenate([rows, cols, np.arange(n)])
    cols_s = np.concatenate([cols, rows, np.arange(n)])
    vals_s = np.concatenate([vals, vals,
                             np.full(n, 4.0)]).astype(np.float32)
    coo = F.coo_from_arrays(vals_s, rows_s, cols_s, (n, n), device=False)

    mesh = make_mesh(len(jax.devices()))
    op = GatherEllOperator(coo, mesh, symmetric=True)
    print("mesh: %d devices | scheduled comm %d entries/mv "
          "(true %d) vs all-gather %d  [%.1fx less]"
          % (mesh.size, op.comm_entries_per_matvec, op.comm_entries_true,
             op.allgather_entries_per_matvec,
             op.allgather_entries_per_matvec
             / max(1, op.comm_entries_per_matvec)))

    e = np.ones(op.shape[1], dtype=vals_s.dtype)
    b = op @ shard_vector(jnp.asarray(e), mesh)
    res = cg(op, b, rtol=1e-10, maxiter=4 * n)
    x = np.asarray(res.x)
    print("CG: istop=%d iters=%d relres=%.2e err=%.2e"
          % (int(res.istop), int(res.n_iter),
             float(res.resid_norm / res.resid_norm0),
             np.abs(x[:n] - 1.0).max()))


if __name__ == "__main__":
    main()
