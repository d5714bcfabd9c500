"""Double-f32 compensated arithmetic (utils/ff.py) and the verified
residual-replacement CG built on it (SURVEY §7 "compensated algorithms
to match residual histories in f32")."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pykrylov_tpu.utils.ff import two_sum, two_prod, ff_add_ff
from pykrylov_tpu.sparse import formats as F
from pykrylov_tpu.sparse import sparse_operator
from pykrylov_tpu.io.datasets import load_bundled
from pykrylov_tpu.solvers.cg import cg


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000) * 1e-4, jnp.float32)
    s, e = two_sum(a, b)
    exact = (np.asarray(a, np.float64) + np.asarray(b, np.float64))
    got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    b = jnp.asarray(rng.standard_normal(1000), jnp.float32)
    p, e = two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
    # Dekker product is exact for f32 inputs (no overflow/underflow here)
    np.testing.assert_array_equal(got, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("fn", ["two_sum", "two_prod"])
def test_error_free_on_card(gpu, fn):
    # compiled for the card: an FMA contraction or reassociation by the
    # GPU code generator would break the error-free transforms
    rng = np.random.default_rng(2)
    n = 1 << 20
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n)
         ).astype(np.float32)
    f = {"two_sum": two_sum, "two_prod": two_prod}[fn]
    hi, lo = jax.jit(f)(jnp.asarray(a), jnp.asarray(b))
    assert hi.devices().pop().platform == "gpu"
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    exact = a64 + b64 if fn == "two_sum" else a64 * b64
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    np.testing.assert_array_equal(got, exact)


def test_ff_add_ff_accumulation():
    # summing 1 + n*eps_lo terms keeps ~2x-f32 accuracy
    h = jnp.asarray(np.float32(1.0))
    l = jnp.asarray(np.float32(0.0))
    t = np.float32(1e-9)
    for _ in range(1000):
        h, l = ff_add_ff(h, l, jnp.asarray(t), jnp.asarray(np.float32(0)))
    got = float(np.asarray(h, np.float64) + np.asarray(l, np.float64))
    assert abs(got - (1.0 + 1000 * float(t))) < 1e-12


def test_ell_matvec_ff_beats_plain_f32():
    vals, rows, cols, shape = load_bundled("1138bus")
    # oracle over the f32-rounded matrix: the container stores f32
    # entries, so that rounding is irreducible and not the ff path's job
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), vals.astype(np.float32).astype(np.float64))
    coo = F.coo_from_arrays(vals.astype(np.float32), rows, cols, shape,
                            device=False)
    ell = F.ell_from_coo(coo)
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape[1]).astype(np.float32)
    ref = a64 @ x.astype(np.float64)
    plain = np.asarray(F.ell_matvec(ell, jnp.asarray(x)), np.float64)
    yh, yl = F.ell_matvec_ff(ell, jnp.asarray(x),
                             jnp.zeros_like(jnp.asarray(x)))
    comp = np.asarray(yh, np.float64) + np.asarray(yl, np.float64)
    err_plain = np.linalg.norm(plain - ref)
    err_comp = np.linalg.norm(comp - ref)
    assert err_comp < 1e-3 * err_plain


def test_verified_cg_f32_reaches_1e6():
    # The flagship parity case: unpreconditioned f32 CG on 1138bus at
    # rtol 1e-6 (reference doc/source/cg.rst:56-66 runs f64).  Without
    # verification the recurrence claims 1e-6 while the TRUE residual
    # stalls ~7e-5; with double-f32 x and compensated replacement the
    # claim is honest.
    vals, rows, cols, shape = load_bundled("1138bus")
    a64 = np.zeros(shape)
    np.add.at(a64, (rows, cols), vals)
    b64 = a64 @ np.ones(shape[0])
    op = sparse_operator((vals.astype(np.float32), rows, cols, shape),
                         symmetric=True, fmt="ell")
    res = cg(op, jnp.asarray(b64, jnp.float32), rtol=1e-6, atol=0.0,
             maxiter=60000, replace_every=1000)
    assert bool(res.converged)
    x = (np.asarray(res.x, np.float64)
         + np.asarray(res.info["x_lo"], np.float64))
    rn = np.linalg.norm(a64 @ x - b64) / np.linalg.norm(b64)
    assert rn < 2.5e-6, rn
    assert int(res.info["n_replacements"]) >= 1
    # matvec accounting includes the replacements
    assert int(res.n_matvec) == int(res.n_iter) + int(
        res.info["n_replacements"])


def test_replacement_keeps_exact_arithmetic_results():
    # in f64 (test-suite x64 default) replacement must not change the
    # converged answer materially
    rng = np.random.default_rng(3)
    n = 200
    q = rng.standard_normal((n, n)) * 0.1
    a = q @ q.T + np.eye(n) * 2
    b = rng.standard_normal(n)
    r0 = cg(a, jnp.asarray(b), rtol=1e-12, atol=0.0, maxiter=2000)
    r1 = cg(a, jnp.asarray(b), rtol=1e-12, atol=0.0, maxiter=2000,
            replace_every=25)
    assert bool(r0.converged) and bool(r1.converged)
    np.testing.assert_allclose(np.asarray(r1.x), np.asarray(r0.x),
                               rtol=1e-9, atol=1e-11)
