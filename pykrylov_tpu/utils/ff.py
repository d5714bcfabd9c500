"""Double-f32 ("float-float") compensated arithmetic.

These error-free transforms give ~2x-f32 (49-bit mantissa) accuracy out
of IEEE f32 adds/muls — the compensated-algorithms piece of SURVEY §7
("match residual histories in f32"), for solves whose vectors stay in
f32.  Used by the verified-convergence CG path to carry the solution
as an (hi, lo) pair and to evaluate true residuals below the plain-f32
matvec floor (~eps·|A||x|, measured 2.3e-6 relative on 1138bus — above
the reference's f64 rtol 1e-6 target).

All functions are elementwise/vectorized jnp and jit-safe.  TwoSum is
Knuth's branchless 6-flop version; TwoProd uses Dekker splitting
(factor 2^12+1 for f32, 2^27+1 for f64 — no FMA primitive is exposed
through XLA).  Both are exact only if the compiler neither reassociates
nor contracts ``f*a - ...`` into an FMA; ``chip_smoke.py`` (phase 7) and
the card-marked cases of ``tests/test_ff.py`` check that on the GPU.
References: Dekker 1971; Ogita, Rump & Oishi 2005.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["two_sum", "two_prod", "ff_add", "ff_add_ff", "ff_renorm",
           "ff_scale", "ff_div", "ff_mul", "ff_sqrt", "ff_hypot",
           "ff_sum", "ff_vdot", "ff_sum_cols", "ff_vdot_cols"]

# Dekker split factors 2^ceil(p/2)+1: binary32 (p=24) and binary64 (p=53).
_SPLIT32 = 4097.0
_SPLIT64 = 134217729.0


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), s + e = a + b."""
    s = a + b
    ap = s - b
    bp = s - ap
    da = a - ap
    db = b - bp
    return s, da + db


def _split(a):
    f = _SPLIT32 if jnp.dtype(a.dtype).itemsize <= 4 else _SPLIT64
    c = f * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: (p, e) with p = fl(a*b), p + e = a*b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def ff_renorm(h, l):
    """Canonicalize an (hi, lo) pair so |lo| <= ulp(hi)/2."""
    return two_sum(h, l)


def ff_add(h, l, b):
    """(h, l) + b where b is a plain f32 value/vector."""
    s, e = two_sum(h, b)
    return ff_renorm(s, e + l)


def ff_add_ff(h, l, bh, bl):
    """(h, l) + (bh, bl)."""
    s, e = two_sum(h, bh)
    return ff_renorm(s, e + l + bl)


def ff_scale(a, vh, vl):
    """Scalar a times pair (vh, vl): exact product of the hi part plus
    first-order lo terms."""
    p, e = two_prod(a, vh)
    return ff_renorm(p, e + a * vl)


def ff_div(h, l, d, dl=None):
    """Pair (h, l) divided by ``d`` (plain, or a pair when ``dl`` is
    given): quotient hi part plus the first-order Newton correction
    ``(h - q*d + l - q*dl) / d`` with the ``q*d`` product taken
    error-free (``h - p`` is exact by Sterbenz since ``p = fl(q*d) ≈ h``)."""
    q = h / d
    p, pe = two_prod(q, d)
    corr = (h - p) - pe + l
    if dl is not None:
        corr = corr - q * dl
    return ff_renorm(q, corr / d)


def ff_mul(ah, al, bh, bl):
    """Pair (ah, al) times pair (bh, bl) to first order."""
    p, pe = two_prod(ah, bh)
    return ff_renorm(p, pe + ah * bl + al * bh)


def ff_sqrt(h, l):
    """Square root of a pair via one Newton correction:
    ``s + (h - s^2 + l) / (2s)`` with ``s^2`` taken error-free."""
    s = jnp.sqrt(h)
    p, pe = two_prod(s, s)
    return ff_renorm(s, ((h - p) - pe + l) / (2.0 * s))


def ff_hypot(ah, al, bh, bl):
    """sqrt(a^2 + b^2) of two pairs (no overflow guard — callers here
    square quantities far inside the f32 range)."""
    sh, sl = ff_add_ff(*ff_mul(ah, al, ah, al), *ff_mul(bh, bl, bh, bl))
    return ff_sqrt(sh, sl)


def ff_sum(p):
    """Compensated sum of a real vector as an (hi, lo) pair.

    Vectorized pairwise TwoSum tree: log2(n) vector sweeps, each level's
    rounding errors accumulated into a plain running correction (their
    own rounding is second order).  Equivalent accuracy to Ogita-Rump
    Sum2 (~2-fold working precision) at O(n) vector work with no serial
    scan — usable inside solver loops."""
    import numpy as _np
    n = int(p.shape[0])
    if n == 0:
        z = jnp.zeros((), p.dtype)
        return z, z
    m = 1 if n <= 1 else 2 ** int(_np.ceil(_np.log2(n)))
    if m != n:
        p = jnp.concatenate([p, jnp.zeros(m - n, p.dtype)])
    err = jnp.zeros((), p.dtype)
    while m > 1:
        s, e = two_sum(p[0::2], p[1::2])
        err = err + jnp.sum(e)
        p = s
        m //= 2
    return two_sum(p[0], err)


def ff_vdot(ah, al, bh, bl):
    """Compensated real dot product of two (hi, lo) vector pairs,
    returned as an (hi, lo) scalar pair.  The dominant hi*hi products
    ride an error-free TwoProd + pairwise-TwoSum tree; the product
    errors and first-order cross terms are folded through a plain sum
    (eps-level terms, so their rounding is second order)."""
    p, pe = two_prod(ah, bh)
    sh, sl = ff_sum(p)
    corr = jnp.sum(pe + ah * bl + al * bh)
    return ff_add(sh, sl, corr)


def ff_dot2(x, y):
    """Compensated dot product (Ogita-Rump-Oishi Dot2): returns the
    f32 value of x·y computed with twofold accuracy."""
    p, s = two_prod(x, y)
    # sum the products and their errors with a compensated reduction
    hi = jnp.sum(p)
    # error of the sum itself is second-order; accumulate term errors
    corr = jnp.sum(s) + _comp_sum_err(p)
    return hi + corr


def _comp_sum_err(p):
    """First-order error estimate of jnp.sum(p) via a sequential
    compensated pass is O(n); XLA's pairwise reduction already keeps the
    plain sum near eps*sqrt(log n), so we only fold in the term errors.
    Kept as a hook for stricter accumulation if a target needs it."""
    return jnp.zeros((), p.dtype)


def ff_sum_cols(p):
    """Per-column :func:`ff_sum`: compensated sums over axis 0 of an
    (n, K) block, returned as a (K,) (hi, lo) pair.  Same pairwise
    TwoSum tree, vectorized across columns."""
    import numpy as _np
    n = int(p.shape[0])
    K = p.shape[1]
    if n == 0:
        z = jnp.zeros((K,), p.dtype)
        return z, z
    m = 1 if n <= 1 else 2 ** int(_np.ceil(_np.log2(n)))
    if m != n:
        p = jnp.concatenate(
            [p, jnp.zeros((m - n, K), p.dtype)], axis=0)
    err = jnp.zeros((K,), p.dtype)
    while m > 1:
        s, e = two_sum(p[0::2, :], p[1::2, :])
        err = err + jnp.sum(e, axis=0)
        p = s
        m //= 2
    return two_sum(p[0], err)


def ff_vdot_cols(ah, al, bh, bl):
    """Per-column :func:`ff_vdot`: compensated real dots of two (n, K)
    (hi, lo) block pairs, returned as a (K,) scalar pair."""
    p, pe = two_prod(ah, bh)
    sh, sl = ff_sum_cols(p)
    corr = jnp.sum(pe + ah * bl + al * bh, axis=0)
    return ff_add(sh, sl, corr)
