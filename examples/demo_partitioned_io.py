"""Partitioned MatrixMarket ingestion + verified sharded solve (round 5).

Demonstrates the multi-host ingestion story end to end on a virtual
mesh: a coordinate .mtx file is stream-parsed in bounded chunks and
routed to the sharded operators' own row-block partition
(``read_matrix_market_partitioned``; process k of a real multi-host
run would pass ``keep=k`` and hold only its slab), the sharded
operator is built through :func:`gather_ell_from_mtx`, and the solve
runs with COMPENSATED residual replacement — the certificate is
checked against the f64 host oracle, which a plain f32 recurrence
cannot honestly reach.

Reference analogue: ``/root/reference/examples/bmark.py:34`` delegates
all .mtx reading to single-process pysparse C code; SURVEY §2.5 maps it
to "own partitioned MatrixMarket loader … host-sharded ingestion".
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # repo root

import tempfile

import numpy as np


def main(n_devices=8):
    # runs on the default devices (one slab per device); for a virtual
    # mesh on a CPU host set JAX_PLATFORMS=cpu
    # XLA_FLAGS=--xla_force_host_platform_device_count=8
    import jax
    n_devices = min(n_devices, len(jax.devices()))
    import jax.numpy as jnp
    from pykrylov_tpu.io.matrix_market import (
        write_matrix_market, read_matrix_market_partitioned)
    from pykrylov_tpu.parallel import shard_vector
    from pykrylov_tpu.parallel.gather import gather_ell_from_mtx
    from pykrylov_tpu.parallel.mesh import make_mesh
    from pykrylov_tpu.solvers import cg

    # --- write a symmetric SPD test matrix (lower triangle stored) ----
    rng = np.random.default_rng(0)
    n = 1200
    rr = rng.integers(0, n, 6 * n)
    cc = rng.integers(0, n, 6 * n)
    rr, cc = np.maximum(rr, cc), np.minimum(rr, cc)
    key = rr * n + cc
    _, first = np.unique(key, return_index=True)
    rr, cc = rr[first], cc[first]
    vv = 0.08 * rng.standard_normal(len(rr))
    rr = np.concatenate([rr, np.arange(n)])
    cc = np.concatenate([cc, np.arange(n)])
    vv = np.concatenate([vv, np.full(n, 4.0)])
    key = rr * n + cc
    _, first = np.unique(key, return_index=True)
    path = _os.path.join(tempfile.mkdtemp(), "spd.mtx")
    write_matrix_market(path, vv[first], rr[first], cc[first], (n, n),
                        symmetry="symmetric")
    print("wrote %s (%d stored entries, symmetric)" % (path, len(first)))

    # --- stream-partitioned load: show the per-slab sizes -------------
    parts, shape, info = read_matrix_market_partitioned(
        path, n_devices, chunk_entries=512)
    print("streamed in 512-entry chunks -> %d row slabs:" % len(parts))
    for k, (pv, pr, pc) in enumerate(parts):
        lo = int(pr.min()) if len(pr) else -1
        hi = int(pr.max()) if len(pr) else -1
        print("  slab %d: %6d entries (rows %d..%d)"
              % (k, len(pv), lo, hi))
    print("(a multi-host process k would pass keep=k and hold ONE slab)")

    # --- sharded operator + verified solve ----------------------------
    mesh = make_mesh(n_devices)
    dt = np.float64 if jax.config.jax_enable_x64 else np.float32
    A = gather_ell_from_mtx(path, mesh, symmetric=True, dtype=dt,
                            chunk_entries=512)
    ep = np.zeros(A.nargin, dt)
    ep[:n] = 1.0
    b = A @ shard_vector(jnp.asarray(ep), mesh)
    res = cg(A, b, rtol=1e-8, atol=0.0, replace_every=10,
             maxiter=4 * n)
    # f64 host-oracle certificate
    a64 = np.zeros((n, n))
    np.add.at(a64, (rr[first], cc[first]), vv[first])
    off = rr[first] != cc[first]
    np.add.at(a64, (cc[first][off], rr[first][off]), vv[first][off])
    a64 = a64.astype(dt).astype(np.float64)
    x = np.asarray(res.x, np.float64)[:n]
    rel = (np.linalg.norm(np.asarray(b, np.float64)[:n] - a64 @ x)
           / np.linalg.norm(np.asarray(b)))
    print("verified sharded CG: converged=%s iters=%d  f64-oracle "
          "rel resid=%.2e" % (bool(res.converged), int(res.n_iter), rel))


if __name__ == "__main__":
    main()
