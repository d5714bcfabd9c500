"""Front-door ``solve`` dispatch and fallback hardening.

Covers the VERDICT round-1 findings on ``solve.py``: the CG→MINRES fallback
must preserve ``x0``/``atol``/caps, and calling ``solve`` inside a traced
region must not crash on the tracer stop code (no-fallback contract).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pykrylov_tpu import solve
from pykrylov_tpu.ops import MatrixOperator


def _indefinite_system(n=24, seed=3):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # Strongly indefinite spectrum so CG's curvature check trips early.
    eigs = np.linspace(-5.0, 5.0, n)
    eigs[np.abs(eigs) < 0.4] = 0.5
    A = (Q * eigs) @ Q.T
    A = 0.5 * (A + A.T)
    x_true = rng.standard_normal(n)
    return A, x_true, A @ x_true


class TestMinresFallback:
    def test_fallback_triggers_and_solves(self):
        A, x_true, b = _indefinite_system()
        op = MatrixOperator(jnp.asarray(A), symmetric=True)
        res = solve(op, jnp.asarray(b), rtol=1e-10)
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6)

    def test_fallback_honors_x0(self):
        A, x_true, b = _indefinite_system()
        op = MatrixOperator(jnp.asarray(A), symmetric=True)
        # Warm start very close to the solution: the fallback must keep it
        # (round 1 silently dropped x0, restarting from zero).  With atol
        # already met at x0, the fallback stops almost immediately; a
        # dropped x0 would restart from zero and need dozens of iterations.
        x0 = x_true + 1e-9 * np.ones_like(x_true)
        res = solve(op, jnp.asarray(b), x0=jnp.asarray(x0),
                    rtol=1e-14, atol=1e-6)
        assert int(res.n_iter) <= 2
        np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6)

    def test_fallback_honors_atol(self):
        A, x_true, b = _indefinite_system()
        op = MatrixOperator(jnp.asarray(A), symmetric=True)
        # Loose atol alone should stop MINRES early (mapped onto its rtol).
        res_loose = solve(op, jnp.asarray(b), rtol=1e-14,
                          atol=1e-2 * float(np.linalg.norm(b)))
        res_tight = solve(op, jnp.asarray(b), rtol=1e-14, atol=0.0)
        assert int(res_loose.n_iter) < int(res_tight.n_iter)

    def test_fallback_respects_matvec_cap(self):
        A, _, b = _indefinite_system()
        op = MatrixOperator(jnp.asarray(A), symmetric=True)
        res = solve(op, jnp.asarray(b), matvec_max=5, rtol=1e-14, atol=0.0)
        assert int(res.n_iter) <= 5


class TestTraceability:
    def test_solve_inside_jit_fused_minres_fallback(self):
        # VERDICT r3 #7: a jit'd solve() on an indefinite operator must
        # return a CONVERGED MINRES-path result (lax.cond-fused fallback),
        # not CG's silently degraded abort.
        A, x_true, b = _indefinite_system()
        op = MatrixOperator(jnp.asarray(A), symmetric=True)

        @jax.jit
        def run(b):
            return solve(op, b, rtol=1e-10)

        res = run(jnp.asarray(b))
        assert bool(res.info["fallback_used"])
        assert bool(res.converged)
        np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6)

    def test_solve_inside_jit_fused_fallback_x0_atol(self):
        # the traced fallback must keep x0 and fold atol, like the
        # concrete one.  (a) x0 near the solution: CG converges at once,
        # no fallback — x0 must survive the traced selection;
        A, x_true, b = _indefinite_system()
        op = MatrixOperator(jnp.asarray(A), symmetric=True)
        x0_good = x_true + 1e-9 * np.ones_like(x_true)

        @jax.jit
        def run(b, x0):
            return solve(op, b, x0=x0, rtol=1e-14, atol=1e-6)

        res = run(jnp.asarray(b), jnp.asarray(x0_good))
        assert not bool(res.info["fallback_used"])
        assert int(res.n_iter) <= 2
        np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6)
        # (b) a far x0: CG trips on indefiniteness, the fused MINRES leg
        # must solve the RESIDUAL system and add x0 back
        x0_far = np.ones_like(x_true) * 3.0
        res2 = run(jnp.asarray(b), jnp.asarray(x0_far))
        assert bool(res2.info["fallback_used"])
        assert bool(res2.converged)
        np.testing.assert_allclose(np.asarray(res2.x), x_true,
                                   rtol=1e-5, atol=1e-7)

    def test_solve_inside_jit_spd_keeps_cg(self):
        rng = np.random.default_rng(5)
        B = rng.standard_normal((16, 16))
        A = B @ B.T + 16 * np.eye(16)
        b = rng.standard_normal(16)
        op = MatrixOperator(jnp.asarray(A), symmetric=True)

        @jax.jit
        def run(b):
            return solve(op, b, rtol=1e-10)

        res = run(jnp.asarray(b))
        assert not bool(res.info["fallback_used"])
        assert bool(res.converged)

    def test_solve_inside_jit_rejects_history_opts(self):
        A, _, b = _indefinite_system()
        op = MatrixOperator(jnp.asarray(A), symmetric=True)

        @jax.jit
        def run(b):
            return solve(op, b, store_history=True)

        with pytest.raises(ValueError, match="lax.cond"):
            run(jnp.asarray(b))

    def test_solve_inside_jit_general_breakdown_fallback(self):
        # nonsymmetric traced path: BiCGSTAB breakdown reroutes to TFQMR
        # inside the same program
        n = 12
        theta = np.pi / 2
        R = np.eye(n)
        R[:2, :2] = [[np.cos(theta), -np.sin(theta)],
                     [np.sin(theta), np.cos(theta)]]
        op = MatrixOperator(jnp.asarray(R))
        b = np.zeros(n)
        b[1] = 1.0

        @jax.jit
        def run(b):
            return solve(op, b, rtol=1e-10)

        res = run(jnp.asarray(b))
        # whichever branch fired, the result must satisfy the system
        np.testing.assert_allclose(np.asarray(R @ res.x), b, atol=1e-6)

    def test_solve_inside_jit_spd_path(self):
        rng = np.random.default_rng(0)
        B = rng.standard_normal((16, 16))
        A = B @ B.T + 16 * np.eye(16)
        b = rng.standard_normal(16)
        op = MatrixOperator(jnp.asarray(A), symmetric=True)

        @jax.jit
        def run(b):
            return solve(op, b, rtol=1e-10)

        res = run(jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(op.to_array() @ res.x), b,
                                   rtol=1e-8)


class TestBreakdownFallback:
    def test_bicgstab_breakdown_forwards_all_opts(self):
        # rhs orthogonal-ish setup that breaks BiCGSTAB: r0 = b with a
        # skew-symmetric-dominant operator makes rho vanish.  Simpler: use
        # a rotation-like matrix where BiCGSTAB's shadow dot collapses.
        n = 12
        A = np.eye(n, k=1) + np.eye(n, k=-1) * -1.0 + np.eye(n) * 1e-12
        b = np.zeros(n)
        b[0] = 1.0
        op = MatrixOperator(jnp.asarray(A))
        res = solve(op, jnp.asarray(b), rtol=1e-8, matvec_max=4 * n)
        # Whichever path won, the result must be a finite SolveResult.
        assert np.all(np.isfinite(np.asarray(res.x)))


class TestVerified:
    def _f32_spd(self):
        from pykrylov_tpu.io.datasets import load_bundled
        from pykrylov_tpu.sparse import sparse_operator
        vals, rows, cols, shape = load_bundled("1138bus")
        a64 = np.zeros(shape)
        np.add.at(a64, (rows, cols),
                  vals.astype(np.float32).astype(np.float64))
        op = sparse_operator((vals.astype(np.float32), rows, cols, shape),
                             symmetric=True, fmt="ell")
        b64 = a64 @ np.ones(shape[0])
        return op, a64, b64

    def test_verified_spd_reaches_true_1e6(self):
        op, a64, b64 = self._f32_spd()
        res = solve(op, jnp.asarray(b64, jnp.float32), verified=True,
                    rtol=1e-6)
        assert bool(res.converged)
        x = (np.asarray(res.x, np.float64)
             + np.asarray(res.info["x_lo"], np.float64))
        rel = np.linalg.norm(a64 @ x - b64) / np.linalg.norm(b64)
        assert rel < 2.5e-6, rel

    def test_verified_explicit_method(self):
        op, a64, b64 = self._f32_spd()
        res = solve(op, jnp.asarray(b64, jnp.float32), method="cg",
                    verified=True, rtol=1e-6)
        assert bool(res.converged)

    def test_verified_lsqr_method_routes_to_refined_lls(self):
        # explicit method="lsqr" + verified=True now runs the verified
        # least-squares refinement (was: rejected)
        rng = np.random.default_rng(9)
        a = rng.standard_normal((60, 23))
        b = rng.standard_normal(60)
        res = solve(MatrixOperator(jnp.asarray(a)), jnp.asarray(b),
                    method="lsqr", verified=True)
        assert "true_normar" in res.info and "normar_history" in res.info

    def test_verified_rejects_sqd_methods(self):
        op, a64, b64 = self._f32_spd()
        with pytest.raises(ValueError):
            solve(op, jnp.asarray(b64, jnp.float32), method="craig",
                  verified=True)

    def test_verified_rectangular_attaches_certificate(self):
        rng = np.random.default_rng(9)
        a = rng.standard_normal((40, 17))
        b = rng.standard_normal(40)
        res = solve(MatrixOperator(jnp.asarray(a)), jnp.asarray(b),
                    verified=True)
        assert "true_normar" in res.info
        assert bool(res.converged), int(res.istop)
        # converged means the advertised contract held: the verified
        # optimality residual is under atol * ||A|| * ||rt||
        assert (float(res.info["true_normar"])
                <= 1e-5 * float(res.info["anorm"]) * float(res.resid_norm))


def test_solve_block_dispatch():
    # (n, K) rhs routes to the fused batched family (round 3)
    import numpy as np
    import jax.numpy as jnp
    from pykrylov_tpu import solve
    from pykrylov_tpu.ops.base import linop_from_ndarray

    rng = np.random.default_rng(21)
    n, K = 48, 3
    q = rng.standard_normal((n, n))
    spd = (q @ q.T + n * np.eye(n)).astype(np.float64)
    Xs = rng.standard_normal((n, K))
    A = linop_from_ndarray(jnp.asarray(spd), symmetric=True)
    res = solve(A, jnp.asarray(spd @ Xs), rtol=1e-10)
    assert res.x.shape == (n, K) and bool(res.converged.all())
    assert np.abs(np.asarray(res.x) - Xs).max() < 1e-6

    gen = (rng.standard_normal((n, n)) + n * np.eye(n))
    Ag = linop_from_ndarray(jnp.asarray(gen))
    res = solve(Ag, jnp.asarray(gen @ Xs), rtol=1e-10)
    assert res.x.shape == (n, K) and bool(res.converged.all())

    # explicit methods with batched twins...
    res = solve(Ag, jnp.asarray(gen @ Xs), method="tfqmr", rtol=1e-8)
    assert res.x.shape == (n, K)
    res = solve(A, jnp.asarray(spd @ Xs), method="minres", rtol=1e-8)
    assert res.x.shape == (n, K)
    # cg_pipelined gained its fused block twin in round 5: the front
    # door dispatches to it (per-column telemetry, no solve_columns
    # fallback)
    res = solve(A, jnp.asarray(spd @ Xs), method="cg_pipelined",
                rtol=1e-8)
    assert res.x.shape == (n, K) and bool(res.converged.all())
    assert res.info["n_iter_columns"].shape == (K,)
    np.testing.assert_allclose(np.asarray(res.x), Xs, rtol=1e-5,
                               atol=1e-7)

    # rectangular block -> lsqr_batched
    m2 = 60
    rect = rng.standard_normal((m2, n))
    Ar = linop_from_ndarray(jnp.asarray(rect))
    res = solve(Ar, jnp.asarray(rect @ Xs), atol=1e-10, btol=1e-10)
    assert res.x.shape == (n, K)

    # verified blocks route to cg_batched's residual-replacement mode
    # for symmetric square systems...
    res = solve(A, jnp.asarray(spd @ Xs), verified=True, rtol=1e-8)
    assert res.x.shape == (n, K) and bool(res.converged.all())
    assert "n_replacements" in res.info
    # ...and GENERAL square verified blocks ride the block refinement
    # driver (round 4)
    res = solve(Ag, jnp.asarray(gen @ Xs), verified=True, rtol=1e-8,
                max_legs=15)
    assert res.x.shape == (n, K) and bool(res.converged.all())
    assert "x_lo" in res.info and res.info["n_legs"] >= 1


def test_fused_fallback_promotes_mixed_dtype_rhs():
    # f32 rhs on an f64 operator inside jit: both lax.cond branches
    # must carry the promoted dtype (round-4 review finding: the fused
    # MINRES leg bypassed the public wrapper's promote_rhs)
    A, x_true, b = _indefinite_system()
    op = MatrixOperator(jnp.asarray(A), symmetric=True)

    @jax.jit
    def run(b32):
        return solve(op, b32, rtol=1e-10)

    res = run(jnp.asarray(b, jnp.float32))
    assert res.x.dtype == jnp.float64
    assert bool(res.info["fallback_used"]) and bool(res.converged)
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-5,
                               atol=1e-7)

