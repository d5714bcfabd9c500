"""Weak-scaling harness: preconditioned CG on sharded 3-D Poisson.

The multi-chip north-star workload (BASELINE "Configs": preconditioned CG
on generated 3-D Poisson sharded across devices).  Runs the same
per-device problem size on 1, 2, 4, ... devices and reports wall time and
weak-scaling efficiency, on the default devices.  To simulate a mesh on a
CPU host, set ``JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8``.

Usage: python demo_multichip.py [grid_n_per_device_scale]
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from pykrylov_tpu.parallel import make_mesh, sharded_poisson3d, replicate
from pykrylov_tpu.ops import DiagonalOperator
from pykrylov_tpu.solvers import cg


def run(n_devices, n_grid, repeats=3):
    mesh = make_mesh(n_devices)
    op, b, e, pad = sharded_poisson3d(n_grid, mesh, halo=True,
                                      dtype=np.float32)
    m = n_grid**3 + pad
    M = DiagonalOperator(replicate(jnp.full(m, 1.0 / 6.0,
                                            dtype=jnp.float32), mesh))
    res = cg(op, b, M=M, rtol=1e-6, maxiter=2 * m)  # compile + converge
    jax.block_until_ready(res.x)
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(cg(op, b, M=M, rtol=1e-6, maxiter=2 * m).x)
        best = min(best, time.perf_counter() - t0)
    return best, int(res.n_iter), bool(res.converged)


def main():
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    n_avail = len(jax.devices())
    print("devices:", jax.devices())
    print("%8s %8s %10s %8s %8s %10s" % (
        "devices", "grid n", "unknowns", "iters", "time(s)", "weak-eff"))
    t1 = None
    d = 1
    while d <= n_avail:
        # Weak scaling: unknowns per device held ~constant.
        n_grid = int(round(scale * d ** (1.0 / 3.0)))
        t, iters, conv = run(d, n_grid)
        t_per_iter = t / max(iters, 1)
        if t1 is None:
            t1 = t_per_iter
        eff = t1 / t_per_iter
        print("%8d %8d %10d %8d %8.3f %9.0f%%" % (
            d, n_grid, n_grid**3, iters, t, 100 * eff))
        d *= 2


if __name__ == "__main__":
    main()
