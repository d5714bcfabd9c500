"""2-D mesh domain decomposition for the 3-D Poisson operator.

Beyond ~10^9 unknowns a 1-D row-block split runs out: slabs get thinner
than the stencil halo and the per-device halo fraction grows.  The 2-D
mesh splits the grid's z axis over one mesh axis and y over the other
(x stays whole per device — it is the vectorized lane dimension), so a
``(R, C)`` mesh holds ``(n/R, n/C, n)`` subdomains and each matvec
exchanges four faces via per-axis ``lax.ppermute`` — nearest-neighbor
ICI traffic on both axes, volume ``2·(n/C + n/R)·n`` per device instead
of the 1-D split's ``2·n²``.

Vector layout: vectors are BRICK-ordered — global position
``((zi·ry + yi)·brick + (z_loc·nyl + y_loc)·n + x)`` — so the flat
vector sharded with ``PartitionSpec(("z", "y"))`` puts exactly one
z-range × y-range × all-x brick on each device (a contiguous chunk of
the NATURAL z-major ordering would be a plain z-split).
:func:`to_bricks` / :func:`from_bricks` convert; all-constant vectors
and norms/dots are permutation-invariant, so solvers run unchanged and
XLA still inserts the psum reductions over both mesh axes.

Reference scope note: the reference has no distributed operators at all
(SURVEY §5); this is JAX-native surface, the mesh analogue of its
gallery Poisson operators (``pykrylov/gallery``-equivalent).
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

from jax.sharding import AxisType, Mesh

from ..ops.base import LinearOperator, _register_as_linop

__all__ = ["make_mesh2d", "Halo2DPoissonOperator", "shard_vector_2d",
           "to_bricks", "from_bricks"]


def to_bricks(v, n, rz, ry):
    """Natural (z,y,x)-ordered grid vector -> brick-ordered (see module
    docstring).  Works on NumPy or jnp arrays."""
    nzl, nyl = n // rz, n // ry
    return (v.reshape(rz, nzl, ry, nyl, n)
            .transpose(0, 2, 1, 3, 4).reshape(-1))


def from_bricks(v, n, rz, ry):
    """Inverse of :func:`to_bricks`."""
    nzl, nyl = n // rz, n // ry
    return (v.reshape(rz, ry, nzl, nyl, n)
            .transpose(0, 2, 1, 3, 4).reshape(-1))


def make_mesh2d(rz, ry, axis_names=("z", "y")):
    """(rz x ry) device mesh with Auto axis types."""
    devs = np.asarray(jax.devices()[:rz * ry]).reshape(rz, ry)
    return Mesh(devs, axis_names,
                axis_types=(AxisType.Auto, AxisType.Auto))


def shard_vector_2d(x, mesh):
    """Shard a flat BRICK-ordered grid vector over both mesh axes.

    The operator's basis is brick order (see
    :class:`Halo2DPoissonOperator`): convert natural (z,y,x) vectors
    with :func:`to_bricks` BEFORE sharding, and :func:`from_bricks`
    after gathering results."""
    return jax.device_put(x, NamedSharding(mesh, P(tuple(mesh.axis_names))))


@functools.lru_cache(maxsize=None)
def _halo2d_mv_factory(n, rz, ry, az, ay, mesh):
    """Matvec as the K=1 case of the block factory (one stencil
    implementation to maintain; the broadcasting mm reduces to it)."""
    mm = _halo2d_mm_factory(n, rz, ry, az, ay, mesh)

    def mv(params, x):
        return mm(params, x[:, None])[:, 0]

    return mv


@functools.lru_cache(maxsize=None)
def _halo2d_mm_factory(n, rz, ry, az, ay, mesh):
    """Block-product twin (matmat protocol): the four face exchanges
    ship (..., K) slices and the stencil broadcasts over the trailing
    K axis — one shard_map serves all K systems per iteration."""
    nzl, nyl = n // rz, n // ry
    fwd_z = [(i, (i + 1) % rz) for i in range(rz)]
    bwd_z = [(i, (i - 1) % rz) for i in range(rz)]
    fwd_y = [(i, (i + 1) % ry) for i in range(ry)]
    bwd_y = [(i, (i - 1) % ry) for i in range(ry)]

    def local_mm(scale_ref, V):
        K = V.shape[1]
        u = V.reshape(nzl, nyl, n, K)
        zi = jax.lax.axis_index(az)
        yi = jax.lax.axis_index(ay)
        zlo = jax.lax.ppermute(u[-1], az, perm=fwd_z)
        zhi = jax.lax.ppermute(u[0], az, perm=bwd_z)
        zlo = jnp.where(zi == 0, jnp.zeros_like(zlo), zlo)
        zhi = jnp.where(zi == rz - 1, jnp.zeros_like(zhi), zhi)
        ylo = jax.lax.ppermute(u[:, -1], ay, perm=fwd_y)
        yhi = jax.lax.ppermute(u[:, 0], ay, perm=bwd_y)
        ylo = jnp.where(yi == 0, jnp.zeros_like(ylo), ylo)
        yhi = jnp.where(yi == ry - 1, jnp.zeros_like(yhi), yhi)

        up = jnp.pad(u, ((1, 1), (1, 1), (1, 1), (0, 0)))
        up = up.at[0, 1:-1, 1:-1].set(zlo).at[-1, 1:-1, 1:-1].set(zhi)
        up = up.at[1:-1, 0, 1:-1].set(ylo).at[1:-1, -1, 1:-1].set(yhi)

        c = up[1:-1, 1:-1, 1:-1]
        Y = (6.0 * c
             - up[:-2, 1:-1, 1:-1] - up[2:, 1:-1, 1:-1]
             - up[1:-1, :-2, 1:-1] - up[1:-1, 2:, 1:-1]
             - up[1:-1, 1:-1, :-2] - up[1:-1, 1:-1, 2:])
        return (scale_ref * Y).reshape(-1, K)

    mapped = shard_map(local_mm, mesh=mesh,
                       in_specs=(P(), P((az, ay), None)),
                       out_specs=P((az, ay), None))

    def mm(params, X):
        return mapped(params, X)

    return mm


class Halo2DPoissonOperator(LinearOperator):
    """7-point 3-D Poisson operator on an (rz x ry) device mesh.

    Acts on flat BRICK-ORDERED vectors of length n^3 sharded with
    :func:`shard_vector_2d`: each device's contiguous chunk is its
    (n/rz, n/ry, n) brick.  Convert natural (z,y,x)-ordered vectors
    with :func:`to_bricks` first (and results back with
    :func:`from_bricks`) — applying the operator to a natural-ordered
    vector silently computes the permuted-basis product P'APv, not Av.
    ``n`` must be divisible by both mesh extents.  ``scale`` multiplies
    the stencil (1.0 gives the standard [6, -1...] operator matching
    ``gallery.poisson3d_matvec``).
    """

    def __init__(self, n, mesh, scale=1.0, dtype=jnp.float32, **kwargs):
        az, ay = mesh.axis_names
        rz, ry = mesh.shape[az], mesh.shape[ay]
        if n % rz or n % ry:
            raise ValueError(
                "both mesh extents (%d, %d) must divide the grid n=%d"
                % (rz, ry, n))
        mv = _halo2d_mv_factory(int(n), int(rz), int(ry), az, ay, mesh)
        mm = _halo2d_mm_factory(int(n), int(rz), int(ry), az, ay, mesh)
        scale = jnp.asarray(scale, dtype=dtype)
        super().__init__(n**3, n**3, matvec=mv, matmat=mm, params=scale,
                         _takes_params=True, symmetric=True,
                         hermitian=True, dtype=np.dtype(dtype), **kwargs)
        self.mesh = mesh
        self.grid_n = n
        # per-device face-exchange volume per matvec, in elements
        self.comm_elems_per_matvec = 2 * (n // rz + n // ry) * n


_register_as_linop(Halo2DPoissonOperator)
