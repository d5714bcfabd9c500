"""Row-sharded RECTANGULAR operators for the least-squares family.

The square sharded operators (``sharded.py``, ``gather.py``) keep x and
y row-sharded with the same partition; a tall m×n system (m ≫ n, the
least-squares regime LSQR/LSMR/CRAIG serve — reference
``/root/reference/pykrylov/lls/lsqr.py:86``) wants the classic
tall-skinny decomposition instead:

  * rows of A are blocked over the mesh (each device holds A_i);
  * the n-side vectors (x, v) are REPLICATED — they are small;
  * ``y = A x`` is embarrassingly local (no communication);
  * ``A' u = Σ_i A_i' u_i`` is one local partial product + ``psum``
    over the mesh axis — the only collective per LSQR iteration.

Local compute is a dense row-block matmul (the natural
layout for regression-type least squares) or an ELL gather/scatter for
sparse tall systems.  Both run under ``shard_map`` so the collective
placement is explicit, not partitioner-inferred.

The m side is padded to a mesh multiple with zero rows (padded entries
of b and of every u iterate stay exactly zero); the n side needs no
padding.
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

__all__ = ["TallSkinnyOperator"]

_HIGHEST = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _dense_tall_factory(axis, mesh):
    # f32 products must not drop to TF32 on GPUs that offer it
    def local_fwd(a_blk, x):
        return jnp.matmul(a_blk, x, precision=_HIGHEST)

    def local_adj(a_blk, u_blk):
        return jax.lax.psum(jnp.matmul(a_blk.T, u_blk, precision=_HIGHEST),
                            axis)

    fwd = shard_map(local_fwd, mesh=mesh,
                    in_specs=(P(axis, None), P()), out_specs=P(axis))
    adj = shard_map(local_adj, mesh=mesh,
                    in_specs=(P(axis, None), P(axis)), out_specs=P())
    # block products: same local matmuls on (n, K)/(L, K) blocks — the
    # row-block A_i streams once for all K columns, one psum for the
    # whole adjoint block (matmat protocol)
    fwd2 = shard_map(local_fwd, mesh=mesh,
                     in_specs=(P(axis, None), P(None, None)),
                     out_specs=P(axis, None))
    adj2 = shard_map(local_adj, mesh=mesh,
                     in_specs=(P(axis, None), P(axis, None)),
                     out_specs=P(None, None))

    def mv(params, x):
        return fwd(params[0], x)

    def mv_t(params, u):
        return adj(params[0], u)

    def mm(params, X):
        return fwd2(params[0], X)

    def mm_t(params, U):
        return adj2(params[0], U)

    return mv, mv_t, mm, mm_t


@functools.lru_cache(maxsize=None)
def _ell_tall_factory(axis, mesh, n):
    def local_fwd(data_blk, cols_blk, x):
        return jnp.sum(data_blk * x[cols_blk], axis=1)

    def local_adj(data_blk, cols_blk, u_blk):
        prods = data_blk * u_blk[:, None]
        part = jnp.zeros(n, prods.dtype).at[cols_blk].add(prods)
        return jax.lax.psum(part, axis)

    def local_fwd2(data_blk, cols_blk, X):
        # (Lm, w) gather against (n, K): one fused gather per block
        return jnp.einsum("rw,rwk->rk", data_blk, X[cols_blk],
                          precision=_HIGHEST)

    def local_adj2(data_blk, cols_blk, U_blk):
        prods = data_blk[:, :, None] * U_blk[:, None, :]  # (Lm, w, K)
        part = jnp.zeros((n, U_blk.shape[1]), prods.dtype).at[
            cols_blk].add(prods)
        return jax.lax.psum(part, axis)

    fwd = shard_map(local_fwd, mesh=mesh,
                    in_specs=(P(axis, None), P(axis, None), P()),
                    out_specs=P(axis))
    adj = shard_map(local_adj, mesh=mesh,
                    in_specs=(P(axis, None), P(axis, None), P(axis)),
                    out_specs=P())
    fwd2 = shard_map(local_fwd2, mesh=mesh,
                     in_specs=(P(axis, None), P(axis, None),
                               P(None, None)),
                     out_specs=P(axis, None))
    adj2 = shard_map(local_adj2, mesh=mesh,
                     in_specs=(P(axis, None), P(axis, None),
                               P(axis, None)),
                     out_specs=P(None, None))

    def mv(params, x):
        return fwd(params[0], params[1], x)

    def mv_t(params, u):
        return adj(params[0], params[1], u)

    def mm(params, X):
        return fwd2(params[0], params[1], X)

    def mm_t(params, U):
        return adj2(params[0], params[1], U)

    return mv, mv_t, mm, mm_t


class TallSkinnyOperator(LinearOperator):
    """Row-sharded rectangular operator for sharded LSQR/LSMR/CRAIG.

    Parameters
    ----------
    source : dense (m, n) array (row-block matmul local compute),
        or a rectangular ELL/COO container (gather/scatter local
        compute).  Pass HOST-resident containers/arrays (``device=False``
        / NumPy): construction reads them on the host.
    mesh : 1-D ``jax.sharding.Mesh``; rows are blocked over ``axis``.

    The operator maps replicated length-n vectors to row-sharded
    length-``m + self.pad`` vectors; shard the rhs with
    :func:`~pykrylov_tpu.parallel.sharded.shard_vector` (padded tail
    zero) and pass n-side vectors as plain (replicated) arrays.
    ``op.T @ u`` costs one ``psum`` — the only collective per
    LSQR/LSMR iteration.
    """

    def __init__(self, source, mesh, axis=ROW_AXIS, **kwargs):
        d = mesh.shape[axis]
        if isinstance(source, F.COO):
            source = F.ell_from_coo(source, device=False)
        if isinstance(source, F.ELL):
            m, n = source.shape
            mp = pad_to_multiple(m, d)
            K = source.data.shape[1]
            data = np.zeros((mp, K), dtype=np.asarray(source.data).dtype)
            cols = np.zeros((mp, K), dtype=np.int32)
            data[:m] = np.asarray(source.data)
            cols[:m] = np.asarray(source.cols)
            sh = NamedSharding(mesh, P(axis, None))
            params = (jax.device_put(data, sh),
                      jax.device_put(cols, sh))
            mv, mv_t, mm, mm_t = _ell_tall_factory(axis, mesh, int(n))
            dtype = data.dtype
        else:
            a = np.asarray(source)
            if a.ndim != 2:
                raise ValueError("TallSkinnyOperator expects a 2-D "
                                 "array or an ELL/COO container")
            m, n = a.shape
            mp = pad_to_multiple(m, d)
            ap = np.zeros((mp, n), dtype=a.dtype)
            ap[:m] = a
            sh = NamedSharding(mesh, P(axis, None))
            params = (jax.device_put(ap, sh),)
            mv, mv_t, mm, mm_t = _dense_tall_factory(axis, mesh)
            dtype = a.dtype

        super().__init__(n, mp, matvec=mv, matvec_transp=mv_t,
                         matmat=mm, matmat_transp=mm_t,
                         params=params, _takes_params=True,
                         symmetric=False,
                         dtype=np.dtype(dtype), **kwargs)
        self.pad = mp - m
        self.mesh = mesh

    @property
    def container(self):
        return self._params


_register_as_linop(TallSkinnyOperator)
