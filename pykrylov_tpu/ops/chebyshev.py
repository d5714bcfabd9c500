"""Chebyshev polynomial preconditioning + Lanczos spectral bounds.

JAX-native alternative to factorization preconditioners (SURVEY §2.5
maps the reference's CHOLMOD ``CholeskyOperator``,
``/root/reference/pykrylov/linop/cholesky.py:15-43``, to "on-device
dense/block-Jacobi alternatives" — this module adds the strongest
matvec-only member of that family).  A sparse triangular solve is a
sequential recurrence that maps badly onto wide vector hardware; a fixed
Chebyshev polynomial ``p(A) ~ A^{-1}`` on an interval ``[lmin, lmax]``
enclosing the spectrum costs ``degree-1`` extra matvecs per
application — exactly the operation the sparse matvec paths are built
to stream — with zero host synchronization, no setup factorization, and
trivially sharded application (the matvec's own sharding).

For SPD ``A`` a FIXED-degree Chebyshev polynomial ``p`` with
``p(lambda) > 0`` on ``[lmin, lmax]`` is itself SPD, so
``ChebyshevOperator`` is a valid CG/MINRES preconditioner; the
preconditioned spectrum ``p(A) A`` clusters at 1 with radius
``~2 rho^degree`` where ``rho = (sqrt(kappa)-1)/(sqrt(kappa)+1)`` —
CG iteration counts drop by ~the polynomial degree (each outer
iteration does the work of ``degree`` plain ones, but dots/axpys and
their latencies are paid once per OUTER iteration, which is the win
whenever reductions, collectives, or per-call overheads — not raw
matvec bandwidth — bound the solve; on multi-chip meshes it divides
the number of psum latency barriers by ``degree``).

Spectral bounds come from :func:`lanczos_bounds`: a k-step Lanczos
sweep fused into one ``lax.scan`` (one compiled program, no host
round-trips), eigenvalues of the small tridiagonal on device, with
safety factors for the Ritz-value underestimate of the true extremes.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .base import LinearOperator, _register_as_linop

__all__ = ["lanczos_bounds", "ChebyshevOperator",
           "chebyshev_preconditioner"]


@functools.partial(jax.jit, static_argnames=("k",))
def _lanczos_tridiag(A, v0, k):
    """k-step Lanczos: returns (alphas, betas) of the tridiagonal
    projection T_k (no reorthogonalization — extremal Ritz values are
    what's needed and they converge first)."""
    v = v0 / jnp.linalg.norm(v0)
    z = jnp.zeros_like(v)

    def step(carry, _):
        v, v_prev, beta_prev = carry
        w = A.apply_with(A._mv, v) - beta_prev * v_prev
        alpha = jnp.vdot(v, w).real.astype(v.dtype)
        w = w - alpha * v
        beta = jnp.linalg.norm(w)
        v_next = jnp.where(beta > 0, w / jnp.where(beta == 0, 1, beta), w)
        return (v_next, v, beta), (alpha, beta)

    (_, _, _), (alphas, betas) = jax.lax.scan(
        step, (v, z, jnp.zeros((), v.dtype)), None, length=k)
    return alphas, betas


def lanczos_bounds(A, *, k=16, seed=0, safety=0.05, v0=None):
    """Estimate spectral bounds ``(lmin, lmax)`` of a symmetric operator
    by k-step Lanczos.

    One fused ``lax.scan`` of k matvecs; the k x k tridiagonal
    eigenproblem runs on device (``jnp.linalg.eigvalsh``).  Ritz values
    approach the spectrum from INSIDE, so the returned interval is
    widened by ``safety`` on both ends (``lmax * (1 + safety)``,
    ``lmin * (1 - safety)`` — for SPD operators lmin stays positive).
    Convergence caveat (Kaniel–Paige): an extreme converges at a rate
    set by its gap RELATIVE TO THE WHOLE SPREAD, so ``lmax`` of a
    typical spectrum pins down in 10-20 steps while ``lmin`` of a
    wide (multi-decade) spectrum stays well above the true minimum.
    That looseness is harmless here: the semi-iteration polynomial
    keeps ``p > 0`` for every eigenvalue in ``(0, lmin + lmax)`` — an
    overestimated ``lmin`` merely damps the lowest modes less, and CG
    mops those up (measured: identical outer iteration counts with
    k=20-estimated and true bounds on a 4-decade logspace spectrum).
    Only an eigenvalue beyond ``lmin + lmax`` (far past the
    safety-widened ``lmax``) could break definiteness.

    Returns a pair of device scalars — feed directly to
    :class:`ChebyshevOperator` (no host pull needed under jit).
    """
    n = A.shape[1]
    dt = np.dtype(A.dtype)
    if np.issubdtype(dt, np.complexfloating):
        raise ValueError("lanczos_bounds: complex operators are not "
                         "supported on this path; use the "
                         "real-equivalent formulation (ops/complex_eq)")
    if v0 is None:
        v0 = jnp.asarray(np.random.default_rng(seed)
                         .standard_normal(n).astype(dt))
    k = int(min(k, n))
    alphas, betas = _lanczos_tridiag(A, v0, k)
    # Exact breakdown (beta_j == 0: the Krylov space exhausted in j < k
    # steps) zero-fills the rest of the scan; the padded zero rows would
    # inject spurious 0 Ritz values (lmin ~= 0 for an SPD operator).
    # Mask them out: a row is valid iff every earlier beta was nonzero;
    # padded diagonal entries are replaced by alphas[0] (a Rayleigh
    # quotient, so inside the true spectral interval) and the
    # off-diagonals that couple into padded rows are zeroed.
    row_ok = jnp.concatenate([
        jnp.ones((1,), bool),
        jnp.cumprod((betas[:-1] > 0).astype(jnp.int32)).astype(bool)])
    alphas = jnp.where(row_ok, alphas, alphas[0])
    off = jnp.where(row_ok[1:], betas[:-1], jnp.zeros_like(betas[:-1]))
    T = jnp.diag(alphas) + jnp.diag(off, 1) + jnp.diag(off, -1)
    ritz = jnp.linalg.eigvalsh(T)
    lmin, lmax = ritz[0], ritz[-1]
    lmin = lmin * jnp.where(lmin > 0, 1.0 - safety, 1.0 + safety)
    lmax = lmax * jnp.where(lmax > 0, 1.0 + safety, 1.0 - safety)
    return lmin, lmax


def _cheb_recurrence(apply_fn, params, x, degree):
    """y = p(A) x by the Chebyshev semi-iteration for ``A y = x`` from
    ``y_0 = 0`` (Saad, Iterative Methods, alg. 12.1): a FIXED polynomial
    of ``A`` — degree-1 applications of A per call."""
    op, lmin, lmax = params
    dt = x.dtype
    theta = (jnp.asarray(lmax, dt) + jnp.asarray(lmin, dt)) / 2
    delta = (jnp.asarray(lmax, dt) - jnp.asarray(lmin, dt)) / 2
    sigma1 = theta / delta
    rho = 1.0 / sigma1
    d = x / theta
    y = d

    def body(_, carry):
        y, d, rho = carry
        rho_new = 1.0 / (2.0 * sigma1 - rho)
        r = x - apply_fn(op, y)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * r
        return (y + d, d, rho_new)

    y, _, _ = jax.lax.fori_loop(0, degree - 1, body, (y, d, rho))
    return y


@functools.lru_cache(maxsize=None)
def _cheb_mv_factory(degree):
    # Shared per-degree function objects (CLAUDE.md conventions:
    # per-instance closures would recompile solvers per preconditioner).
    def mv(params, x):
        return _cheb_recurrence(
            lambda op, v: op.apply_with(op._mv, v), params, x, degree)
    return mv


@functools.lru_cache(maxsize=None)
def _cheb_mm_factory(degree):
    from .base import _block_apply

    def mm(params, X):
        return _cheb_recurrence(
            lambda op, V: _block_apply(op, op._mv, V), params, X, degree)
    return mm


@_register_as_linop
class ChebyshevOperator(LinearOperator):
    """``p(A) ~ A^{-1}``: fixed-degree Chebyshev polynomial of a
    symmetric operator on the interval ``[lmin, lmax]``.

    Symmetric (SPD for SPD ``A`` with ``0 < lmin``), jit-transparent
    (params are a pytree: the wrapped operator and two device scalars),
    and block-aware: applying to an (n, K) block runs the recurrence on
    the whole block, riding the wrapped operator's native SpMM rule —
    so batched solvers amortize the matrix stream across both the K
    systems AND the polynomial degree.

    ``degree`` counts the polynomial degree: one application performs
    ``degree - 1`` products with ``A`` (degree 1 is diagonal-free
    Richardson scaling ``x / theta``).
    """

    def __init__(self, A, lmin, lmax, degree=8):
        degree = int(degree)
        if degree < 1:
            raise ValueError("ChebyshevOperator: degree must be >= 1")
        if A.shape[0] != A.shape[1]:
            raise ValueError("ChebyshevOperator needs a square operator")
        if not A.symmetric:
            raise ValueError("ChebyshevOperator needs a symmetric "
                             "operator (p(A) of an unsymmetric A is "
                             "neither A^{-1}-like nor symmetric)")
        self.degree = degree
        super().__init__(
            A.shape[1], A.shape[0],
            matvec=_cheb_mv_factory(degree),
            matmat=_cheb_mm_factory(degree),
            params=(A, jnp.asarray(lmin, A.dtype),
                    jnp.asarray(lmax, A.dtype)),
            _takes_params=True,
            symmetric=True,
            hermitian=not np.issubdtype(np.dtype(A.dtype),
                                        np.complexfloating),
            dtype=A.dtype, name="chebyshev(%d)" % degree)

    def solve(self, x):
        """Preconditioner-protocol alias (``BlockPreconditioner.solve``
        convention, reference ``linop/blkop.py:259-276``)."""
        return self * x


def chebyshev_preconditioner(A, *, degree=8, bounds=None, k_lanczos=16,
                             seed=0, safety=0.05):
    """Front door: Chebyshev preconditioner for a symmetric-definite
    operator, estimating spectral bounds by Lanczos when not given.

    ``bounds=(lmin, lmax)`` skips the estimation (floats or device
    scalars).  Returns a :class:`ChebyshevOperator` usable as ``M=`` in
    cg/minres/symmlq and their batched variants.

    When the bounds are CONCRETE (host floats or non-traced device
    scalars) they are validated: ``lmin <= 0`` or ``lmin >= lmax``
    raises, because the polynomial then has roots inside the interval
    and ``p(A)`` is not SPD — CG/MINRES would fail downstream with no
    pointer to the cause.  Traced bounds (inside jit) skip the check.
    """
    if bounds is None:
        bounds = lanczos_bounds(A, k=k_lanczos, seed=seed, safety=safety)
    lmin, lmax = bounds
    try:
        # ONE device pull for both scalars
        lmin_c, lmax_c = (float(v) for v in
                          np.asarray(jnp.stack([jnp.asarray(lmin),
                                                jnp.asarray(lmax)])))
    except (jax.errors.TracerArrayConversionError,
            jax.errors.ConcretizationTypeError, TypeError):
        pass  # traced bounds: caller asserts validity
    else:
        if lmin_c <= 0 or lmin_c >= lmax_c:
            raise ValueError(
                "chebyshev_preconditioner: spectral interval [%g, %g] is "
                "not positive (the operator looks indefinite or "
                "semidefinite on the probed subspace); p(A) would not be "
                "SPD. Provide bounds= for a shifted/regularized interval "
                "or use an indefinite-capable method (MINRES)."
                % (lmin_c, lmax_c))
    return ChebyshevOperator(A, lmin, lmax, degree=degree)
