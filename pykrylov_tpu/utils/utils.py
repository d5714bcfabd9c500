"""Numerics utilities.

Functional, JAX-first equivalents of the reference helpers
(``/root/reference/pykrylov/tools/utils.py``): machine epsilon, a stable
quadratic-root solver with Newton refinement, and randomized symmetry /
positive-definiteness probes usable as test oracles.  The probes take an
explicit PRNG key (JAX style) instead of seeding a global RNG.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def machine_epsilon(dtype=None) -> float:
    """Unit roundoff of ``dtype`` (default: current default float)."""
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    return float(jnp.finfo(dtype).eps)


def roots_quadratic(q2, q1, q0, tol=1.0e-8, nitref=1):
    """Real roots of q2 x^2 + q1 x + q0, numerically stable.

    Handles the degenerate linear/constant cases, picks the root formula
    that avoids cancellation, and polishes each root with ``nitref`` Newton
    steps.  Mirrors the behavior of the reference helper
    (``tools/utils.py:12-60``) which follows the GALAHAD ROOTS approach.
    Returns a list of real roots (possibly empty).
    """
    q2, q1, q0 = float(q2), float(q1), float(q0)
    a_big = max(abs(q0), abs(q1), abs(q2))
    if a_big == 0.0:
        return [0.0]  # identically zero polynomial: report 0
    # Degeneracy decided on coefficients normalized by the largest one, so a
    # huge |q1| cannot absorb a genuinely nonzero leading coefficient.
    if abs(q2) == 0.0 or abs(q2 / a_big) <= tol * np.finfo(np.float64).eps / 1e-8:
        if abs(q1) == 0.0:
            roots = [] if abs(q0) > 0.0 else [0.0]
        else:
            roots = [-q0 / q1]
    else:
        disc = q1 * q1 - 4.0 * q2 * q0
        if disc < 0.0:
            return []
        sq = np.sqrt(disc)
        # Root with the sign choice that avoids cancellation.
        if q1 >= 0.0:
            big = -0.5 * (q1 + sq)
        else:
            big = -0.5 * (q1 - sq)
        if big != 0.0:
            roots = [big / q2, q0 / big]
        else:
            roots = [0.0, 0.0]

    # Newton polishing.
    polished = []
    for r in roots:
        for _ in range(nitref):
            val = (q2 * r + q1) * r + q0
            der = 2.0 * q2 * r + q1
            if der != 0.0:
                r = r - val / der
        polished.append(r)
    return polished


def check_symmetric(op, key=None, nprobe: int = 10, tol=None) -> bool:
    """Randomized symmetry test: compares <Ax, Ax> with <x, A(Ax)>.

    Same oracle as the reference (``tools/utils.py:63-85``) — draw random
    probes, apply the operator twice, and compare the two inner products
    against a scale-aware threshold.  ``key`` defaults to a fixed seed for
    reproducibility (the reference seeds ``np.random.seed(1)``).
    """
    if key is None:
        key = jax.random.PRNGKey(1)
    m, n = op.shape
    if m != n:
        return False
    dtype = op.dtype
    if jnp.issubdtype(dtype, jnp.complexfloating):
        rdtype = jnp.zeros(0, dtype).real.dtype
    else:
        rdtype = dtype
    eps = machine_epsilon(rdtype)
    # All probes in ONE device program + ONE host pull: the per-probe loop
    # costs 2*nprobe device round-trips.
    X = jax.random.normal(key, (nprobe, n), dtype=rdtype).astype(dtype)

    def probe(x):
        Ax = op.apply_with(op._mv, x)
        AAx = op.apply_with(op._mv, Ax)
        # Unconjugated dots, matching the reference oracle's np.dot
        # (tools/utils.py:74-75): this tests SYMMETRY; jnp.vdot would
        # conjugate and test hermitian-ness, rejecting complex symmetric
        # operators.
        hi = jax.lax.Precision.HIGHEST
        return jnp.dot(Ax, Ax, precision=hi), jnp.dot(x, AAx, precision=hi)

    s1, s2 = jax.vmap(probe)(X)
    # apply_with bypasses the host-side call counter; preserve the
    # reference's accounting (2 matvecs per probe, tools/utils.py:72-73).
    op._nMatvec += 2 * nprobe
    s1 = np.asarray(s1)
    s2 = np.asarray(s2)
    for k in range(nprobe):
        scale = abs(s1[k])
        thresh = (tol if tol is not None
                  else float((scale + eps) * eps ** (1.0 / 3.0)))
        if abs(s1[k] - s2[k]) > thresh:
            return False
    return True


def check_positive_definite(op, key=None, nprobe: int = 10, semi: bool = False) -> bool:
    """Randomized positive-(semi)definiteness test via <x, Ax> probes.

    Mirrors the reference oracle (``tools/utils.py:88-112``).
    """
    if key is None:
        key = jax.random.PRNGKey(1)
    m, n = op.shape
    if m != n:
        return False
    dtype = op.dtype
    if jnp.issubdtype(dtype, jnp.complexfloating):
        rdtype = jnp.zeros(0, dtype).real.dtype
    else:
        rdtype = dtype
    eps = machine_epsilon(rdtype)
    # Batched like check_symmetric: one device program, one host pull.
    X = jax.random.normal(key, (nprobe, n), dtype=rdtype).astype(dtype)

    def probe(x):
        return jnp.vdot(x, op.apply_with(op._mv, x)), jnp.vdot(x, x).real

    xAx, xx = jax.vmap(probe)(X)
    op._nMatvec += nprobe
    xAx = np.asarray(xAx)
    xx = np.asarray(xx)
    for k in range(nprobe):
        v = xAx[k]
        if jnp.issubdtype(dtype, jnp.complexfloating):
            if abs(v.imag) > eps ** (1.0 / 3.0) * abs(v):
                return False
            v = v.real
        bound = -eps if semi else eps * float(xx[k])
        if float(v) <= bound:
            return False
    return True
