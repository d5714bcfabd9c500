"""Halo-exchange DIA matvec over a device mesh (``shard_map`` + ppermute).

The speed-of-light multi-chip SpMV for banded/stencil matrices.  The matrix
is stored in DIA format, row-block partitioned: device k owns rows
``[k·L, (k+1)·L)`` of every diagonal and the matching block of x.  A matvec
needs only ``w = max|offset|`` boundary entries of x from each neighbor, so
instead of the generic all-gather this operator exchanges two width-w halo
slices via ``jax.lax.ppermute`` — nearest-neighbor traffic between
adjacent devices — then computes the local shifted-axpy stencil entirely
on-device.  Communication volume per step: 2·w·sizeof(dtype) per device,
independent of problem size.

This is the library's analogue of ring-attention/CP neighbor exchange
(SURVEY §5 "long-context"): same mesh axis, same ppermute pattern, applied
to the solver's row dimension.  It requires the matrix bandwidth to fit in
one shard (w <= rows per device) — true for all gallery stencils; general
sparsity uses the ELL all-gather fallback in :mod:`.sharded`.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..ops.base import LinearOperator, _register_as_linop
from ..sparse import formats as F
from .mesh import ROW_AXIS
from .sharded import pad_to_multiple

__all__ = ["HaloDiaOperator"]


@functools.lru_cache(maxsize=None)
def _halo_mv_factory(offsets, axis, n_dev, mesh):
    """shard_map-wrapped matvec, memoized per (offsets, axis, mesh) so
    equal-config operators share one function object in their pytree aux
    (otherwise every HaloDiaOperator instance forces a solver retrace)."""
    local_mv = _halo_matvec_factory(offsets, axis, n_dev)
    mapped = shard_map(local_mv, mesh=mesh,
                       in_specs=(P(None, axis), P(axis)),
                       out_specs=P(axis))

    def mv(params, x):
        return mapped(params, x)

    return mv


@functools.lru_cache(maxsize=None)
def _halo_mm_factory(offsets, axis, n_dev, mesh):
    """Block-product twin: the halo exchange ships (w, K) slices and the
    shifted axpys broadcast over the K columns — one shard_map streams
    the local diagonal blocks once for all K systems (matmat protocol,
    solvers/batched._apply_block)."""
    local_mm = _halo_matmat_factory(offsets, axis, n_dev)
    mapped = shard_map(local_mm, mesh=mesh,
                       in_specs=(P(None, axis), P(axis, None)),
                       out_specs=P(axis, None))

    def mm(params, X):
        return mapped(params, X)

    return mm


@functools.lru_cache(maxsize=None)
def _halo_matmat_factory(offsets, axis, n_dev):
    """Per-shard block product: halo exchange + local shifted axpys on
    an (L, K) block."""
    w = max((abs(o) for o in offsets), default=0)
    fwd_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_mm(data_blk, X_blk):
        L = X_blk.shape[0]
        idx = jax.lax.axis_index(axis)
        if w > 0:
            left = jax.lax.ppermute(X_blk[-w:, :], axis, perm=fwd_perm)
            right = jax.lax.ppermute(X_blk[:w, :], axis, perm=bwd_perm)
            left = jnp.where(idx == 0, jnp.zeros_like(left), left)
            right = jnp.where(idx == n_dev - 1, jnp.zeros_like(right),
                              right)
            Xp = jnp.concatenate([left, X_blk, right], axis=0)
        else:
            Xp = X_blk
        Y = jnp.zeros(X_blk.shape,
                      dtype=jnp.result_type(data_blk.dtype, X_blk.dtype))
        for k, off in enumerate(offsets):
            Y = Y + data_blk[k][:, None] * jax.lax.dynamic_slice_in_dim(
                Xp, w + off, L, axis=0)
        return Y

    return local_mm


@functools.lru_cache(maxsize=None)
def _halo_matvec_factory(offsets, axis, n_dev):
    """Build the per-shard matvec: halo exchange + local shifted axpys.

    ``offsets`` are static; the generated function takes the *local* blocks
    ``(data_blk (ndiag, L), x_blk (L,))`` and returns the local y block.
    """
    w = max((abs(o) for o in offsets), default=0)
    fwd_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_mv(data_blk, x_blk):
        L = x_blk.shape[0]
        idx = jax.lax.axis_index(axis)
        if w > 0:
            # Left halo: last w entries of the left neighbor's block.
            left = jax.lax.ppermute(x_blk[-w:], axis, perm=fwd_perm)
            # Right halo: first w entries of the right neighbor's block.
            right = jax.lax.ppermute(x_blk[:w], axis, perm=bwd_perm)
            # Global boundary blocks see zeros, not wrap-around values.
            left = jnp.where(idx == 0, jnp.zeros_like(left), left)
            right = jnp.where(idx == n_dev - 1, jnp.zeros_like(right), right)
            xp = jnp.concatenate([left, x_blk, right])
        else:
            xp = x_blk
        y = jnp.zeros(L, dtype=jnp.result_type(data_blk.dtype, x_blk.dtype))
        for k, off in enumerate(offsets):  # static unroll over diagonals
            y = y + data_blk[k] * jax.lax.dynamic_slice_in_dim(
                xp, w + off, L)
        return y

    return local_mv


@functools.lru_cache(maxsize=None)
def _halo_ff_factory(offsets, axis, n_dev, mesh):
    """Compensated (double-f32) halo matvec ``(params, xh, xl) ->
    (yh, yl)`` — full-strength verified certificates on sharded
    systems: TwoProd/TwoSum shifted-slice local
    product with the (hi, lo) halo slices riding ONE stacked ppermute
    per direction.  Downstream dot products on the (hi, lo) parts are
    plain sharded reductions (GSPMD psum) — exact in the compensated
    PRODUCTS, eps-of-the-norm in the final reduction, which is what
    the certificate needs (the plain f32 matvec floors at
    ~eps·|A||x|, far above)."""
    from ..utils.ff import two_prod, two_sum

    w = max((abs(o) for o in offsets), default=0)
    fwd_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_ff(data_blk, xh_blk, xl_blk):
        L = xh_blk.shape[0]
        idx = jax.lax.axis_index(axis)
        if w > 0:
            sl = jnp.stack([xh_blk[-w:], xl_blk[-w:]])
            sr = jnp.stack([xh_blk[:w], xl_blk[:w]])
            left = jax.lax.ppermute(sl, axis, perm=fwd_perm)
            right = jax.lax.ppermute(sr, axis, perm=bwd_perm)
            left = jnp.where(idx == 0, jnp.zeros_like(left), left)
            right = jnp.where(idx == n_dev - 1, jnp.zeros_like(right),
                              right)
            xph = jnp.concatenate([left[0], xh_blk, right[0]])
            xpl = jnp.concatenate([left[1], xl_blk, right[1]])
        else:
            xph, xpl = xh_blk, xl_blk
        yh = jnp.zeros(L, dtype=xh_blk.dtype)
        yl = jnp.zeros(L, dtype=xh_blk.dtype)
        for k, off in enumerate(offsets):   # static unroll
            dk = data_blk[k].astype(xh_blk.dtype)
            gh = jax.lax.dynamic_slice_in_dim(xph, w + off, L)
            gl = jax.lax.dynamic_slice_in_dim(xpl, w + off, L)
            p, pe = two_prod(dk, gh)
            pe = pe + dk * gl
            s, e = two_sum(yh, p)
            yh, yl = two_sum(s, yl + e + pe)
        return yh, yl

    mapped = shard_map(local_ff, mesh=mesh,
                      in_specs=(P(None, axis), P(axis), P(axis)),
                      out_specs=(P(axis), P(axis)))

    def ff(params, xh, xl):
        return mapped(params, xh, xl)

    return ff


class HaloDiaOperator(LinearOperator):
    """Symmetric banded operator with ppermute halo-exchange matvec.

    Parameters
    ----------
    dia : :class:`pykrylov_tpu.sparse.formats.DIA` container (square).
    mesh : 1-D ``jax.sharding.Mesh``; rows are blocked over ``axis``.
    axis : mesh axis name (default ``"rows"``).

    The operator acts on vectors of length ``m + self.pad`` sharded with
    :func:`~pykrylov_tpu.parallel.sharded.shard_vector`; the padded tail is
    structurally zero.  Only symmetric offset sets are supported for the
    transpose (all gallery stencils are symmetric); pass the transposed
    container explicitly otherwise.
    """

    def __init__(self, dia: F.DIA, mesh, axis=ROW_AXIS, **kwargs):
        m, n = dia.shape
        if m != n:
            raise ValueError("HaloDiaOperator expects a square operator")
        n_dev = mesh.shape[axis]
        mp = pad_to_multiple(m, n_dev)
        L = mp // n_dev
        w = max((abs(o) for o in dia.offsets), default=0)
        if w > L:
            raise ValueError(
                "matrix bandwidth %d exceeds rows-per-device %d; "
                "use fewer devices or the ELL fallback" % (w, L))
        symmetric_offsets = set(dia.offsets) == {-o for o in dia.offsets}
        if not symmetric_offsets:
            raise ValueError("offsets must be symmetric about 0; got %s"
                             % (dia.offsets,))

        data = np.zeros((dia.data.shape[0], mp), dtype=dia.data.dtype)
        data[:, :m] = np.asarray(dia.data)
        offsets_t = tuple(int(o) for o in dia.offsets)
        mv = _halo_mv_factory(offsets_t, axis, n_dev, mesh)
        mm = _halo_mm_factory(offsets_t, axis, n_dev, mesh)
        # host array straight to its shards: nothing lands whole on
        # the first device
        params = jax.device_put(data, NamedSharding(mesh, P(None, axis)))
        ff = _halo_ff_factory(offsets_t, axis, n_dev, mesh)
        from ..solvers.ffmv import register_ff_matvec
        register_ff_matvec(mv, ff)

        is_complex = np.issubdtype(dia.data.dtype, np.complexfloating)
        # Structural symmetry of the *values* is the caller's contract
        # (gallery stencils are symmetric); offsets symmetry checked above.
        super().__init__(mp, mp, matvec=mv, matmat=mm, params=params,
                         _takes_params=True, symmetric=True,
                         hermitian=not is_complex,
                         dtype=dia.data.dtype, **kwargs)
        self.pad = mp - m
        self.mesh = mesh
        self.offsets = dia.offsets
        self.halo_width = w

    @property
    def container(self):
        """The sharded (ndiag, m + pad) diagonal storage."""
        return self._params


_register_as_linop(HaloDiaOperator)
