"""Pipelined (communication-hiding) CG tests: convergence parity with
classic CG, residual-replacement stabilization, sharded execution.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pykrylov_tpu.solvers import cg, cg_pipelined
from pykrylov_tpu.gallery import poisson1d_operator
from pykrylov_tpu.ops import DiagonalOperator


def test_matches_cg_iteration_count():
    op = poisson1d_operator(200, dtype=jnp.float64)
    e = jnp.ones(200, dtype=jnp.float64)
    b = op * e
    r_cg = cg(op, b, rtol=1e-10)
    r_p = cg_pipelined(op, b, rtol=1e-10)
    assert bool(r_p.converged)
    assert abs(int(r_p.n_iter) - int(r_cg.n_iter)) <= 3
    np.testing.assert_allclose(np.asarray(r_p.x), 1.0, atol=1e-8)


def test_preconditioned(rng):
    n = 100
    d = jnp.asarray(np.linspace(1.0, 1e4, n))
    A = DiagonalOperator(d)
    M = DiagonalOperator(1.0 / d)
    b = jnp.ones(n, dtype=jnp.float64)
    res = cg_pipelined(A, b, M=M, rtol=1e-12)
    assert bool(res.converged) and int(res.n_iter) <= 3
    np.testing.assert_allclose(np.asarray(res.x), 1.0 / np.asarray(d),
                               rtol=1e-10)


def test_residual_replacement_improves_accuracy():
    from pykrylov_tpu.sparse import sparse_operator, jacobi_preconditioner
    op = sparse_operator("1138bus", symmetric=True)
    M = jacobi_preconditioner("1138bus")
    n = 1138
    b = op * jnp.ones(n, dtype=jnp.float64)
    plain = cg_pipelined(op, b, M=M, rtol=1e-8, maxiter=5000)
    repl = cg_pipelined(op, b, M=M, rtol=1e-8, maxiter=5000,
                        replace_every=50)
    assert bool(plain.converged) and bool(repl.converged)
    e_plain = float(jnp.linalg.norm(plain.x - 1.0))
    e_repl = float(jnp.linalg.norm(repl.x - 1.0))
    assert e_repl <= e_plain * 1.5  # replacement never much worse
    # replacement costs extra matvecs
    assert int(repl.n_matvec) > int(repl.n_iter)


def test_sharded_mesh():
    from pykrylov_tpu.parallel import make_mesh, sharded_poisson3d
    mesh = make_mesh(8)
    op, b, e, _ = sharded_poisson3d(8, mesh, halo=True)
    res = cg_pipelined(op, b, rtol=1e-10)
    assert bool(res.converged)
    assert float(jnp.linalg.norm(res.x - e)) < 1e-6
    assert len(res.x.sharding.device_set) == 8


def test_warm_start_and_history():
    op = poisson1d_operator(120, dtype=jnp.float64)
    e = jnp.ones(120, dtype=jnp.float64)
    b = op * e
    res = cg_pipelined(op, b, x0=0.9 * e, rtol=1e-10, store_history=True)
    assert bool(res.converged)
    h = res.history()
    assert len(h) == int(res.n_iter) + 1
    assert h[-1] <= 1e-10 * h[0] + 1e-8


def test_pipelined_single_fused_reduction_in_hlo():
    """The solver's reason to exist (communication hiding): classic CG
    compiles TWO all-reduces per iteration (r'u and p'Ap barriers),
    pipelined CG's shared-operand dots fuse into ONE.
    Counted in the SPMD-partitioned HLO on an 8-device mesh: one more
    all-reduce outside the loop (resid0) in both."""
    import re
    import jax
    from pykrylov_tpu.parallel import sharded_poisson3d
    from pykrylov_tpu.parallel.mesh import make_mesh
    from pykrylov_tpu.solvers import cg as cg_fn
    from pykrylov_tpu.solvers.pipelined import cg_pipelined

    mesh = make_mesh(8)
    op, b, e, pad = sharded_poisson3d(16, mesh, dtype=np.float32,
                                      halo=True)

    def n_allreduce(fn):
        lowered = jax.jit(lambda bb: fn(op, bb, rtol=1e-5, maxiter=30).x)
        txt = lowered.lower(b).compile().as_text()
        return txt.count("all-reduce(") + txt.count("all-reduce-start(")

    n_cg = n_allreduce(cg_fn)
    n_pl = n_allreduce(cg_pipelined)
    # 1 outside the loop (resid0) + per-iteration reductions
    assert n_cg == 3, n_cg
    assert n_pl == 2, n_pl
