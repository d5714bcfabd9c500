"""Limited-memory BFGS operators.

JAX-native re-design of the reference L-BFGS operator family
(``/root/reference/pykrylov/linop/lbfgs.py``).  The reference mutates NumPy
ring buffers in place; here the pair history is an immutable
:class:`LBFGSData` pytree (fixed-size ``(mem, n)`` buffers + insertion
counter) so updates and matvecs are pure functions usable inside ``jit`` and
``lax.while_loop``.  Masked ``lax.fori_loop`` recursions replace the
reference's Python loops, keeping shapes static for XLA.

The class wrappers keep the reference's mutable API (``store``, ``restart``,
operator algebra) for familiarity; they simply swap the underlying pytree.

Reference bugs intentionally not replicated (SURVEY §2.1):
``StructuredLBFGSOperator``'s broken ctor/`self.matvec` calls
(``lbfgs.py:277,338,349``) — here the structured update is implemented per
its documented intent.
"""

from __future__ import annotations

from typing import NamedTuple

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .base import LinearOperator

__all__ = [
    "LBFGSData",
    "lbfgs_init",
    "lbfgs_store",
    "lbfgs_restart",
    "inverse_lbfgs_matvec",
    "forward_lbfgs_matvec",
    "compact_lbfgs_matvec",
    "InverseLBFGSOperator",
    "LBFGSOperator",
    "CompactLBFGSOperator",
    "StructuredLBFGSOperator",
]

# Curvature acceptance threshold (reference: ``lbfgs.py:51`` uses 1e-20).
ACCEPT_THRESHOLD = 1.0e-20


class LBFGSData(NamedTuple):
    """Fixed-size ring buffer of (s, y) pairs as a pytree."""
    s: jnp.ndarray        # (mem, n)
    y: jnp.ndarray        # (mem, n)
    ys: jnp.ndarray       # (mem,)  cached s.y products
    valid: jnp.ndarray    # (mem,)  bool mask of filled slots
    insert: jnp.ndarray   # () int32 next slot
    gamma: jnp.ndarray    # () scaling factor (M3 scaling when enabled)


def lbfgs_init(n, mem=5, dtype=jnp.float32):
    z = jnp.zeros((mem, n), dtype=dtype)
    return LBFGSData(
        s=z, y=z,
        ys=jnp.zeros((mem,), dtype=dtype),
        valid=jnp.zeros((mem,), dtype=bool),
        insert=jnp.zeros((), dtype=jnp.int32),
        gamma=jnp.ones((), dtype=dtype))


def lbfgs_store(data: LBFGSData, s, y, scaling: bool = True) -> LBFGSData:
    """Insert a pair if its curvature ``s.y`` exceeds the threshold.

    Pure-functional equivalent of ``InverseLBFGSOperator.store``
    (``lbfgs.py:70-87``).  Rejected pairs leave the data untouched.
    """
    ys = jnp.vdot(y, s).real.astype(data.ys.dtype)

    def _accept(d):
        mem = d.s.shape[0]
        k = d.insert % mem
        gamma = jnp.where(scaling, ys / jnp.vdot(y, y).real, d.gamma)
        return LBFGSData(
            s=d.s.at[k].set(s.astype(d.s.dtype)),
            y=d.y.at[k].set(y.astype(d.y.dtype)),
            ys=d.ys.at[k].set(ys),
            valid=d.valid.at[k].set(True),
            insert=d.insert + 1,
            gamma=gamma.astype(d.gamma.dtype))

    return jax.lax.cond(ys > ACCEPT_THRESHOLD, _accept, lambda d: d, data)


def lbfgs_restart(data: LBFGSData) -> LBFGSData:
    """Forget all stored pairs (``lbfgs.py:89-95``)."""
    return lbfgs_init(data.s.shape[1], data.s.shape[0], data.s.dtype)


def _order(data: LBFGSData):
    """Slot indices from oldest to newest (static length = mem)."""
    mem = data.s.shape[0]
    # Oldest slot is ``insert % mem`` once the buffer has wrapped, else 0.
    base = jnp.where(data.insert >= mem, data.insert % mem, 0)
    return (base + jnp.arange(mem)) % mem


def inverse_lbfgs_matvec(data: LBFGSData, v, scaling: bool = True):
    """Two-loop recursion: apply the inverse-Hessian approximation H to v.

    Equivalent to ``InverseLBFGSOperator.lbfgs_matvec`` (``lbfgs.py:97-127``)
    but as a masked ``fori_loop`` over the static memory size.
    """
    mem = data.s.shape[0]
    order = _order(data)
    q = v

    def bwd(i, carry):
        q, alphas = carry
        k = order[mem - 1 - i]  # newest -> oldest
        use = data.valid[k]
        alpha = jnp.where(use, jnp.vdot(data.s[k], q) / data.ys[k], 0.0)
        q = q - jnp.where(use, alpha, 0.0) * data.y[k]
        return q, alphas.at[mem - 1 - i].set(alpha)

    q, alphas = jax.lax.fori_loop(
        0, mem, bwd, (q, jnp.zeros((mem,), dtype=v.dtype)))

    r = q * data.gamma if scaling else q

    def fwd(i, r):
        k = order[i]  # oldest -> newest
        use = data.valid[k]
        beta = jnp.where(use, jnp.vdot(data.y[k], r) / data.ys[k], 0.0)
        return r + jnp.where(use, alphas[i] - beta, 0.0) * data.s[k]

    return jax.lax.fori_loop(0, mem, fwd, r)


def forward_lbfgs_matvec(data: LBFGSData, v, scaling: bool = True):
    """Apply the *forward* Hessian approximation B to v.

    Outer-product recursion equivalent to ``LBFGSOperator.lbfgs_matvec``
    (``lbfgs.py:140-173``): start from B0 = I/gamma and apply the BFGS
    update for each stored pair, oldest first.
    """
    mem = data.s.shape[0]
    order = _order(data)
    n = v.shape[0]

    # b[k] = B_k s_k is needed at each update; recompute with a nested loop
    # — mem is small (default 5) so the O(mem^2) trace unrolls cheaply.
    def apply_B(upto, w):
        """Apply B after ``upto`` updates to vector w."""
        b0 = w / data.gamma if scaling else w

        def body(i, acc):
            k = order[i]
            use = jnp.logical_and(data.valid[k], i < upto)
            Bs = Bs_all[i]
            sBs = sBs_all[i]
            t1 = jnp.where(use, jnp.vdot(data.y[k], w) / data.ys[k], 0.0)
            t2 = jnp.where(use, jnp.vdot(Bs, w) / sBs, 0.0)
            return acc + t1 * data.y[k] - t2 * Bs
        return jax.lax.fori_loop(0, mem, body, b0)

    # Precompute B_i s_i sequentially (oldest first).
    Bs_all = jnp.zeros((mem, n), dtype=v.dtype)
    sBs_all = jnp.ones((mem,), dtype=v.dtype)
    for i in range(mem):  # static unroll over memory slots
        k = order[i]
        s_i = data.s[k]
        b0 = s_i / data.gamma if scaling else s_i

        def body(j, acc):
            kk = order[j]
            use = jnp.logical_and(data.valid[kk], j < i)
            t1 = jnp.where(use, jnp.vdot(data.y[kk], s_i) / data.ys[kk], 0.0)
            t2 = jnp.where(use, jnp.vdot(Bs_all[j], s_i) / sBs_all[j], 0.0)
            return acc + t1 * data.y[kk] - t2 * Bs_all[j]
        Bsi = jax.lax.fori_loop(0, mem, body, b0)
        Bs_all = Bs_all.at[i].set(Bsi)
        sBs = jnp.vdot(s_i, Bsi)
        sBs_all = sBs_all.at[i].set(jnp.where(data.valid[k], sBs, 1.0))

    return apply_B(mem, v)


def structured_lbfgs_matvec(params, v, scaling: bool = True):
    """Apply the structured forward L-BFGS approximation B to v.

    The reference's outer-product recursion is broken in code
    (``lbfgs.py:277,338,349``: ctor passes ``self`` twice, double-divides
    by ``aTs[l]``); this implements the documented intent ([Nocedal06]
    structured PSB/secant): with ``A_k = yd_k - B_k s_k``,

        B_{k+1} = B_k + (A_k y_k' + y_k A_k')/y_k's_k
                      - (s_k'A_k) y_k y_k' / (y_k's_k)^2,

    which satisfies the structured secant condition ``B_{k+1} s_k = yd_k``
    and keeps B symmetric.  ``B_k s_k`` is computed through the
    accumulated updates (not approximated by ``B_0 s_k``) the same way
    :func:`forward_lbfgs_matvec` recomputes its ``B_i s_i``: a static
    O(mem^2) unroll over the (small, default 5) memory.

    ``params``: dict with s/y/yd (mem, n), ys/valid (mem,), insert, gamma.
    """
    mem = params["s"].shape[0]
    base = jnp.where(params["insert"] >= mem, params["insert"] % mem, 0)
    order = (base + jnp.arange(mem)) % mem  # oldest -> newest
    gamma = params["gamma"]
    n = v.shape[0]

    def apply_B(upto, A_all, w):
        """B after ``upto`` updates applied to w (B0 = I/gamma)."""
        b0 = w / gamma if scaling else w

        def body(j, acc):
            k = order[j]
            use = params["valid"][k] & (j < upto)
            y, s, ys = params["y"][k], params["s"][k], params["ys"][k]
            A = A_all[j]
            t = jnp.where(use, 1.0 / ys, 0.0)
            yw = jnp.vdot(y, w)
            Aw = jnp.vdot(A, w)
            sA = jnp.vdot(s, A)
            return acc + (Aw * t) * y + (yw * t) * A - (sA * yw * t * t) * y
        return jax.lax.fori_loop(0, mem, body, b0)

    A_all = jnp.zeros((mem, n), dtype=v.dtype)
    for i in range(mem):  # static unroll: A_i depends on A_0..A_{i-1}
        k = order[i]
        s_i = params["s"][k]
        Bs_i = apply_B(i, A_all, s_i)
        A_all = A_all.at[i].set(params["yd"][k] - Bs_i)
    return apply_B(mem, A_all, v)


def compact_lbfgs_matvec(data: LBFGSData, v, scaling: bool = True):
    """Forward Hessian approximation via the compact representation.

    Equivalent of ``CompactLBFGSOperator.lbfgs_matvec`` (``lbfgs.py:188-254``):
      B = B0 - [B0 S  Y] W^{-1} [B0 S  Y]^T,
    with W the 2m x 2m "minimat" [[S^T B0 S, L],[L^T, -D]].  Invalid slots are
    masked by padding W with identity rows/cols so the dense solve stays
    fixed-shape.
    """
    mem = data.s.shape[0]
    order = _order(data)
    S = data.s[order]          # (mem, n) oldest->newest
    Y = data.y[order]
    valid = data.valid[order]
    ys = data.ys[order]

    theta = 1.0 / data.gamma if scaling else jnp.asarray(1.0, v.dtype)
    # HIGHEST: f32 products must not drop to TF32 on GPUs that offer it
    def mm(a, b):
        return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

    StS = mm(S, S.T)           # (mem, mem)
    StY = mm(S, Y.T)
    idx_i = jnp.arange(mem)[:, None]
    idx_j = jnp.arange(mem)[None, :]
    L = jnp.where(idx_i > idx_j, StY, 0.0)          # strictly lower part of S^T Y
    D = jnp.diag(ys)
    W = jnp.block([[theta * StS, L], [L.T, -D]])
    mask2 = jnp.concatenate([valid, valid])
    Wm = jnp.where(mask2[:, None] & mask2[None, :], W,
                   jnp.eye(2 * mem, dtype=W.dtype))
    rhs = jnp.concatenate([theta * mm(S, v), mm(Y, v)]) * mask2
    coef = jnp.linalg.solve(Wm, rhs) * mask2
    corr = theta * mm(S.T, coef[:mem]) + mm(Y.T, coef[mem:])
    return theta * v - corr


# ---------------------------------------------------------------------------
# Class wrappers (reference-style mutable API)
# ---------------------------------------------------------------------------


# Jitted entry points shared by all wrapper instances (compile once per
# shape, not per operator instance).
_inv_mv_jit = jax.jit(inverse_lbfgs_matvec, static_argnums=2)
_fwd_mv_jit = jax.jit(forward_lbfgs_matvec, static_argnums=2)
_cpt_mv_jit = jax.jit(compact_lbfgs_matvec, static_argnums=2)
_str_mv_jit = jax.jit(structured_lbfgs_matvec, static_argnums=2)
_store_jit = jax.jit(lbfgs_store, static_argnums=3)


@functools.lru_cache(maxsize=None)
def _structured_mv_factory(scaling):
    # module-level shared function objects per `scaling` flag: an
    # inline-closure matvec would make every operator instance its own
    # pytree leaf type and force per-instance solver recompiles
    def mv(params, x):
        return _str_mv_jit(params, x, scaling)
    return mv


class InverseLBFGSOperator(LinearOperator):
    """Inverse-Hessian L-BFGS approximation as an operator
    (``lbfgs.py:14-127``).

    ``store(s, y)`` / ``restart()`` mutate the wrapper by swapping its
    immutable :class:`LBFGSData`; the matvec is the pure two-loop recursion.
    """

    _matvec_fn = staticmethod(_inv_mv_jit)

    def __init__(self, n, npairs=5, scaling: bool = True, dtype=None, **kwargs):
        dtype = np.dtype(dtype if dtype is not None else jnp.zeros(0).dtype)
        self.scaling = scaling
        self._n = n
        self._npairs = npairs
        data = lbfgs_init(n, npairs, dtype)
        fn = type(self)._matvec_fn

        def mv(params, x):
            return fn(params, x, scaling)

        super().__init__(n, n, matvec=mv, params=data, _takes_params=True,
                         symmetric=True, hermitian=True, dtype=dtype, **kwargs)

    @property
    def npairs(self):
        return self._npairs

    @property
    def data(self) -> LBFGSData:
        return self._params

    @property
    def insert(self):
        return int(self._params.insert) % self._npairs

    def store(self, new_s, new_y):
        self._params = _store_jit(self._params, jnp.asarray(new_s),
                                  jnp.asarray(new_y), self.scaling)

    def restart(self):
        self._params = lbfgs_restart(self._params)

    def lbfgs_matvec(self, v):
        return self.apply_with(self._mv, jnp.asarray(v))


class LBFGSOperator(InverseLBFGSOperator):
    """Forward Hessian approximation B (``lbfgs.py:130-173``)."""

    _matvec_fn = staticmethod(_fwd_mv_jit)


class CompactLBFGSOperator(InverseLBFGSOperator):
    """Forward approximation in compact form (``lbfgs.py:176-254``)."""

    _matvec_fn = staticmethod(_cpt_mv_jit)


class StructuredLBFGSOperator(LinearOperator):
    """Structured forward L-BFGS update (``lbfgs.py:257-350``).

    The reference implementation is broken in code (ctor passes ``self``
    twice, double-divides by ``aTs[l]``, lbfgs.py:277,338); this
    implements the documented intent — see
    :func:`structured_lbfgs_matvec`.  Pairs are ``(s, y, yd)`` with
    ``yd`` the structured gradient difference; the update satisfies the
    structured secant condition ``B_{k+1} s_k = yd_k`` with ``B_k s_k``
    computed through the accumulated recursion.  A pair is accepted when
    ``y's + sqrt(y's * s'Bs) >= threshold`` (``lbfgs.py:330-342``).
    """

    def __init__(self, n, npairs=5, scaling: bool = True, dtype=None,
                 accept_threshold: float = 1.0e-8, **kwargs):
        dtype = np.dtype(dtype if dtype is not None else jnp.zeros(0).dtype)
        self.scaling = scaling
        self._npairs = npairs
        self.accept_threshold = accept_threshold
        z = jnp.zeros((npairs, n), dtype=dtype)
        data = dict(s=z, y=z, yd=z,
                    ys=jnp.zeros((npairs,), dtype=dtype),
                    valid=jnp.zeros((npairs,), dtype=bool),
                    insert=jnp.zeros((), jnp.int32),
                    gamma=jnp.ones((), dtype=dtype))

        super().__init__(n, n, matvec=_structured_mv_factory(bool(scaling)),
                         params=data, _takes_params=True,
                         symmetric=True, hermitian=True, dtype=dtype,
                         **kwargs)

    @property
    def data(self):
        return self._params

    def store(self, new_s, new_y, new_yd):
        s = jnp.asarray(new_s)
        y = jnp.asarray(new_y)
        yd = jnp.asarray(new_yd)
        d = self._params
        ys = jnp.vdot(y, s)
        # Reference acceptance (lbfgs.py:330-342): y's + sqrt(y's * s'Bs)
        # >= threshold, with B the CURRENT approximation.
        sBs = jnp.vdot(s, self.apply_with(self._mv, s))
        accept = (ys + jnp.sqrt(jnp.maximum(ys * sBs, 0.0))
                  >= self.accept_threshold)

        def _ins(d):
            mem = d["s"].shape[0]
            k = d["insert"] % mem
            gamma = jnp.where(self.scaling & (ys > 0), ys / jnp.vdot(y, y), d["gamma"])
            return dict(
                s=d["s"].at[k].set(s), y=d["y"].at[k].set(y),
                yd=d["yd"].at[k].set(yd), ys=d["ys"].at[k].set(ys),
                valid=d["valid"].at[k].set(True), insert=d["insert"] + 1,
                gamma=gamma.astype(d["gamma"].dtype))

        self._params = jax.lax.cond(accept, _ins, lambda d: d, d)

    def restart(self):
        self.__init__(self.nargin, self._npairs, self.scaling, self.dtype,
                      accept_threshold=self.accept_threshold)

    def lbfgs_matvec(self, v):
        return self.apply_with(self._mv, jnp.asarray(v))


from .base import _register_as_linop as _reg  # noqa: E402

for _cls in (InverseLBFGSOperator, LBFGSOperator, CompactLBFGSOperator,
             StructuredLBFGSOperator):
    _reg(_cls)
del _cls, _reg
