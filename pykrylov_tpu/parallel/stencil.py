"""Matrix-free halo-exchange 3-D Poisson operator (1-D z-slab split).

For CONSTANT-coefficient stencils the cheapest local compute is XLA's
fused 3-D slice stencil — it streams zero matrix data, while the
explicit-DIA path reads ``ndiag·m`` values per matvec.  This
operator is the speed-of-light option for the gallery Poisson class:
the 7-point stencil applied to the local ``(n/R, n, n)`` slab with two
``ppermute``'d z-faces, no stored matrix at all.

Use :class:`~pykrylov_tpu.parallel.halo.HaloDiaOperator` for general
banded/variable-coefficient matrices; use this when the operator IS the
constant stencil (``sharded_poisson3d(matrix_free=True)``).

Vector layout: NATURAL z-major flat (n^3,) — z-slabs are contiguous, so
:func:`~pykrylov_tpu.parallel.sharded.shard_vector` shards it directly
(no brick permutation, unlike the 2-D mesh operator).  ``n`` must be
divisible by the mesh extent.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

from ..ops.base import LinearOperator, _register_as_linop
from .mesh import ROW_AXIS

__all__ = ["HaloStencilPoisson3DOperator"]


@functools.lru_cache(maxsize=None)
def _stencil_mv_factory(n, n_dev, axis, mesh):
    """Matvec as the K=1 case of the block factory (one stencil
    implementation to maintain; the broadcasting mm reduces to it)."""
    mm = _stencil_mm_factory(n, n_dev, axis, mesh)

    def mv(params, x):
        return mm(params, x[:, None])[:, 0]

    return mv


@functools.lru_cache(maxsize=None)
def _stencil_mm_factory(n, n_dev, axis, mesh):
    """Block twin: the faces ship (n, n, K) slices and the stencil
    broadcasts over the trailing K axis."""
    nzl = n // n_dev
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def local_mm(scale_ref, V):
        K = V.shape[1]
        u = V.reshape(nzl, n, n, K)
        idx = jax.lax.axis_index(axis)
        zlo = jax.lax.ppermute(u[-1], axis, perm=fwd)
        zhi = jax.lax.ppermute(u[0], axis, perm=bwd)
        zlo = jnp.where(idx == 0, jnp.zeros_like(zlo), zlo)
        zhi = jnp.where(idx == n_dev - 1, jnp.zeros_like(zhi), zhi)
        up = jnp.pad(u, ((1, 1), (1, 1), (1, 1), (0, 0)))
        up = up.at[0, 1:-1, 1:-1].set(zlo).at[-1, 1:-1, 1:-1].set(zhi)
        c = up[1:-1, 1:-1, 1:-1]
        Y = (6.0 * c
             - up[:-2, 1:-1, 1:-1] - up[2:, 1:-1, 1:-1]
             - up[1:-1, :-2, 1:-1] - up[1:-1, 2:, 1:-1]
             - up[1:-1, 1:-1, :-2] - up[1:-1, 1:-1, 2:])
        return (scale_ref * Y).reshape(-1, K)

    mapped = shard_map(local_mm, mesh=mesh,
                       in_specs=(P(), P(axis, None)),
                       out_specs=P(axis, None))

    def mm(params, X):
        return mapped(params, X)

    return mm


class HaloStencilPoisson3DOperator(LinearOperator):
    """Matrix-free 7-point 3-D Poisson over a 1-D z-slab mesh split.

    Acts on natural z-major flat vectors of length ``n**3`` sharded
    with :func:`~pykrylov_tpu.parallel.sharded.shard_vector` (slabs are
    contiguous; no padding — ``n`` must be divisible by the mesh
    extent).  ``scale`` multiplies the [6, -1x6] stencil, matching
    ``gallery.poisson3d_matvec`` at 1.0.  Zero stored matrix: per
    matvec the only HBM traffic is the vectors themselves, ~40% less
    than the explicit-DIA halo path (from the byte counts; not measured
    on the GPU).
    """

    def __init__(self, n, mesh, scale=1.0, axis=ROW_AXIS,
                 dtype=jnp.float32, **kwargs):
        n_dev = mesh.shape[axis]
        if n % n_dev:
            raise ValueError("mesh extent %d must divide the grid n=%d"
                             % (n_dev, n))
        mv = _stencil_mv_factory(int(n), int(n_dev), axis, mesh)
        mm = _stencil_mm_factory(int(n), int(n_dev), axis, mesh)
        scale = jnp.asarray(scale, dtype=dtype)
        super().__init__(n**3, n**3, matvec=mv, matmat=mm, params=scale,
                         _takes_params=True, symmetric=True,
                         hermitian=True, dtype=np.dtype(dtype), **kwargs)
        self.mesh = mesh
        self.grid_n = n
        self.pad = 0
        self.halo_width = n * n


_register_as_linop(HaloStencilPoisson3DOperator)
