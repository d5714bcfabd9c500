"""Card-only flagship checks (marker ``gpu``; they skip on the CPU).

Run on the card with ``PYKRYLOV_TEST_ON_CARD=1 python -m pytest tests/ -m
gpu``.  The flagship asserts BASELINE config 1: the 1138bus system
certifies rtol 1e-6 in f32 through the verified residual-replacement CG
path (reference protocol ``doc/source/cg.rst:56-66``, run there in f64);
the f64 host check allows 5e-6 for the f32 rounding of ``b = A e``.
"""

import numpy as np
import pytest

import jax

pytestmark = pytest.mark.gpu


def test_flagship_1138bus_rtol_1e6_f32(gpu):
    import __graft_entry__ as g
    fn, args = g.entry()
    x, rnorm, nit = jax.jit(fn)(*args)
    assert x.dtype == np.float32
    x = np.asarray(x, np.float64)
    from pykrylov_tpu.io.datasets import load_bundled
    vals, rows, cols, shape = load_bundled("1138bus")
    a = np.zeros(shape)
    np.add.at(a, (rows, cols), vals)
    b = a @ np.ones(shape[0])
    rn = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
    assert rn < 5e-6, rn
    assert int(nit) < 20000


def test_verified_minres_kappa1e7_indefinite_on_card(gpu):
    # verified <= 1e-6 relative TRUE residual on a kappa~1e7 symmetric
    # INDEFINITE system (saddle-point-like: 1138bus plus a small
    # negative-definite block) via ff-MINRES refinement legs in f32
    import jax.numpy as jnp
    from pykrylov_tpu.io.datasets import load_bundled
    from pykrylov_tpu.ops import DiagonalOperator
    from pykrylov_tpu.sparse import sparse_operator
    from pykrylov_tpu.solvers import minres, refined_solve

    vals, rows, cols, shape = load_bundled("1138bus")
    n0 = shape[0]
    k = 20
    n = n0 + k
    dneg = -np.logspace(3, 4, k)
    v2 = np.concatenate([vals, dneg]).astype(np.float32)
    r2 = np.concatenate([rows, n0 + np.arange(k)])
    c2 = np.concatenate([cols, n0 + np.arange(k)])
    op = sparse_operator((v2, r2, c2, (n, n)), symmetric=True)
    a64 = np.zeros((n, n))
    np.add.at(a64, (r2, c2), v2.astype(np.float64))
    d = np.abs(np.diag(a64))
    M = DiagonalOperator(jnp.asarray(1.0 / d, jnp.float32))
    b64 = a64 @ np.ones(n)
    b = jnp.asarray(b64, jnp.float32)
    res = refined_solve(minres, op, b, rtol=1e-6, M=M, leg_rtol=1e-2,
                        max_legs=12, leg_maxiter=1200)
    x = (np.asarray(res.x, np.float64)
         + np.asarray(res.info["x_lo"], np.float64))
    rel = np.linalg.norm(a64 @ x - b64) / np.linalg.norm(b64)
    assert bool(res.converged), (int(res.istop), rel)
    # the b32 quantization alone contributes ~1e-7-class error to the
    # f64 external check, same as the CG flagship
    assert rel < 2.5e-6, rel
