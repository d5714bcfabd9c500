"""Partition-time gather schedule for row-sharded *general* sparsity.

The generic sharded-ELL fallback lets XLA all-gather the full x vector
before every matvec (``sharded.py``): d·(d−1)·L entries of traffic per
step regardless of the sparsity pattern.  Real general matrices touch
only a few remote columns per device, so this operator computes — at
partition time, on the host — exactly which x entries each device needs
from each other device, and exchanges only those via one
``lax.ppermute`` round per mesh shift (the device analogue of the
reference-era MPI ``Alltoallv`` neighbor exchange).  Column indices are remapped into each device's private address
space ``[local x block | round-1 buffer | round-2 buffer | ...]`` so the
local compute is a plain ELL gather/reduce.

Zero-padding slots in the ELL container (data == 0) are remapped to
local index 0: they multiply by zero, so they must not generate remote
requests.

Communication accounting is exposed as ``comm_entries_per_matvec``
(scheduled, padded to the per-round max) vs
``allgather_entries_per_matvec`` — the measured-volume evidence SURVEY
§7 ("halo exchange generality") calls for.
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

__all__ = ["GatherEllOperator", "build_gather_schedule",
           "gather_ell_from_mtx"]


def gather_ell_from_mtx(path, mesh, symmetric=False, axis=ROW_AXIS,
                        dtype=None, chunk_entries=1 << 20, **kwargs):
    """Build a :class:`GatherEllOperator` from a MatrixMarket file via
    the PARTITIONED streaming loader (SURVEY §2.5 "host-sharded
    ingestion"): the coordinate section is parsed in bounded chunks and
    routed straight to the operator's own row-block partition — the
    full COO is never built as a single parse product.  On a
    multi-host mesh each process would stream with
    ``keep=<its row blocks>`` (see
    :func:`~pykrylov_tpu.io.matrix_market.read_matrix_market_partitioned`);
    on one host the parts are assembled into the (mp, K) ELL arrays the
    schedule builder consumes (the device-upload working set, which is
    needed regardless).

    Produces bit-identical operators to the monolithic
    ``GatherEllOperator(read_matrix_market(path))`` path: the ELL
    conversion sorts entries, erasing the routing order.
    """
    from ..io.matrix_market import read_matrix_market_partitioned
    d = mesh.shape[axis]
    parts, shape, info = read_matrix_market_partitioned(
        path, d, chunk_entries=chunk_entries, dtype=dtype)
    vals = np.concatenate([p[0] for p in parts])
    rows = np.concatenate([p[1] for p in parts])
    cols = np.concatenate([p[2] for p in parts])
    coo = F.coo_from_arrays(vals, rows, cols, shape, device=False)
    if symmetric is None:
        symmetric = info.symmetry in ("symmetric", "hermitian")
    return GatherEllOperator(coo, mesh, axis=axis, symmetric=symmetric,
                             **kwargs)


def build_gather_schedule(cols, data, d, L, Lrow=None):
    """Host-side schedule: per (device, shift) request lists + remapping.

    Parameters: ``cols``/``data`` (mp, K) NumPy ELL arrays
    (mp = d·Lrow); ``L`` is the x-side block size (entries of x each
    device owns — equals ``Lrow`` for square operators, the default).
    Returns ``(cols_local, sendidx, lens)`` where

      * ``cols_local`` (mp, K) int32 — column indices remapped into each
        device's private address space;
      * ``sendidx`` — tuple over shifts k=1..d-1 of (d, Lk) int32: row j
        holds the local x indices device j sends in round k (to device
        ``(j-k) % d``), zero-padded to the round's max Lk;
      * ``lens`` — tuple of true (unpadded) per-device request counts
        per round, for traffic accounting.
    """
    cols = np.asarray(cols)
    data = np.asarray(data)
    if Lrow is None:
        Lrow = L
    mp, K = cols.shape
    assert mp == d * Lrow
    owner = cols // L
    dev = (np.arange(mp) // Lrow)[:, None]
    live = data != 0
    # shift of each slot's owner relative to its row's device
    shift = (owner - dev) % d

    cols_local = np.zeros((mp, K), dtype=np.int32)
    # local entries (and dead padding slots -> 0)
    local_mask = live & (shift == 0)
    cols_local[local_mask] = (cols[local_mask] % L).astype(np.int32)

    sendidx, lens = [], []
    offset = L  # running base of the per-round buffers
    for k in range(1, d):
        reqs = []
        for i in range(d):
            rows = slice(i * Lrow, (i + 1) * Lrow)
            mask = live[rows] & (shift[rows] == k)
            reqs.append(np.unique(cols[rows][mask]) % L)
        Lk = max((len(r) for r in reqs), default=0)
        lens.append(tuple(len(r) for r in reqs))
        if Lk == 0:
            sendidx.append(np.zeros((d, 0), dtype=np.int32))
            continue
        # receiver i's request list, padded; device j sends what its
        # round-k receiver (j-k)%d asked for
        req_pad = np.zeros((d, Lk), dtype=np.int32)
        for i in range(d):
            req_pad[i, :len(reqs[i])] = reqs[i]
        send = np.zeros((d, Lk), dtype=np.int32)
        for j in range(d):
            send[j] = req_pad[(j - k) % d]
        sendidx.append(send)
        # remap this round's remote references
        for i in range(d):
            rows = slice(i * Lrow, (i + 1) * Lrow)
            mask = live[rows] & (shift[rows] == k)
            pos = np.searchsorted(reqs[i], cols[rows][mask] % L)
            block = cols_local[rows]
            block[mask] = (offset + pos).astype(np.int32)
            cols_local[rows] = block
        offset += Lk
    return cols_local, tuple(map(jnp.asarray, sendidx)), tuple(lens)


@functools.lru_cache(maxsize=None)
def _gather_mv_factory(axis, n_dev, round_lens, mesh):
    """shard_map-wrapped scheduled-gather ELL matvec, memoized per config
    so equal-config operators share one function object (pytree aux)."""
    perms = [tuple((j, (j - k) % n_dev) for j in range(n_dev))
             for k in range(1, n_dev)]

    def local_mv(data_blk, cols_blk, x_blk, *send_blks):
        bufs = [x_blk]
        for k, Lk in enumerate(round_lens):
            if Lk == 0:
                continue
            out = jax.lax.ppermute(x_blk[send_blks[k][0]], axis,
                                   perm=list(perms[k]))
            bufs.append(out)
        xfull = jnp.concatenate(bufs) if len(bufs) > 1 else bufs[0]
        return jnp.sum(data_blk * xfull[cols_blk], axis=1)

    nsend = len(round_lens)
    mapped = shard_map(
        local_mv, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis))
        + (P(axis, None),) * nsend,
        out_specs=P(axis))

    def mv(params, x):
        data, cols, send = params
        return mapped(data, cols, x, *send)

    return mv


@functools.lru_cache(maxsize=None)
def _gather_mvT_factory(axis, n_dev, round_lens, L, mesh):
    """Transpose product under the SAME gather schedule, reversed.

    ``y = A' x`` for row-sharded A: device i's local block A_i is the
    only holder of its rows, so ``A' x = sum_i A_i' x_i`` — device i
    scatter-adds ``data * x_local[row]`` into its private address space
    ``[local | round-1 buffer | ...]`` (the transpose lands
    contributions exactly where the forward gather fetched operands),
    then each round's buffer segment rides the REVERSE ppermute back to
    its owning device, which scatter-adds it at its forward send list.
    Traffic volume is identical to the forward schedule, direction
    reversed (the device analogue of the MPI reduce-scatter dual of the
    Alltoallv gather; the reference's pysparse C SpMV serves
    ``matvec_transp`` single-process, ``linop/linop.py:666-681``)."""
    rev_perms = [tuple((j, (j + k) % n_dev) for j in range(n_dev))
                 for k in range(1, n_dev)]
    width = L + sum(round_lens)

    def local_mv_t(data_blk, cols_blk, x_blk, *send_blks):
        prods = data_blk * x_blk[:, None]
        y_priv = jnp.zeros(width, prods.dtype).at[cols_blk].add(prods)
        y = y_priv[:L]
        off = L
        for k, Lk in enumerate(round_lens):
            if Lk == 0:
                continue
            seg = jax.lax.ppermute(y_priv[off:off + Lk], axis,
                                   perm=list(rev_perms[k]))
            off += Lk
            # padded send slots repeat index 0; their segment values are
            # zero (the forward remap never references padding), so the
            # duplicate adds are harmless
            y = y.at[send_blks[k][0]].add(seg)
        return y

    nsend = len(round_lens)
    mapped = shard_map(
        local_mv_t, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis))
        + (P(axis, None),) * nsend,
        out_specs=P(axis))

    def mv_t(params, x):
        data, cols, send = params
        return mapped(data, cols, x, *send)

    return mv_t


@functools.lru_cache(maxsize=None)
def _gather_ff_factory(axis, n_dev, round_lens, mesh):
    """Compensated (double-f32) scheduled-gather ELL matvec
    ``(params, xh, xl) -> (yh, yl)``: the (hi, lo)
    request slices ride ONE stacked ppermute per round, the local
    product is the TwoProd/TwoSum cascade of
    :func:`~pykrylov_tpu.sparse.formats.ell_matvec_ff` over the
    private address space."""
    from ..utils.ff import two_prod, two_sum

    perms = [tuple((j, (j - k) % n_dev) for j in range(n_dev))
             for k in range(1, n_dev)]

    def local_ff(data_blk, cols_blk, xh_blk, xl_blk, *send_blks):
        bufs_h, bufs_l = [xh_blk], [xl_blk]
        for k, Lk in enumerate(round_lens):
            if Lk == 0:
                continue
            sl = jnp.stack([xh_blk[send_blks[k][0]],
                            xl_blk[send_blks[k][0]]])
            out = jax.lax.ppermute(sl, axis, perm=list(perms[k]))
            bufs_h.append(out[0])
            bufs_l.append(out[1])
        xfh = jnp.concatenate(bufs_h) if len(bufs_h) > 1 else bufs_h[0]
        xfl = jnp.concatenate(bufs_l) if len(bufs_l) > 1 else bufs_l[0]
        db = data_blk.astype(xh_blk.dtype)
        gh = xfh[cols_blk]
        gl = xfl[cols_blk]
        p, pe = two_prod(db, gh)
        pe = pe + db * gl
        mloc, K = p.shape
        yh = jnp.zeros(mloc, dtype=p.dtype)
        yl = jnp.zeros(mloc, dtype=p.dtype)
        for k in range(K):   # static unroll over the padded row width
            s, e = two_sum(yh, p[:, k])
            yh, yl = two_sum(s, yl + e + pe[:, k])
        return yh, yl

    nsend = len(round_lens)
    mapped = shard_map(
        local_ff, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis), P(axis))
        + (P(axis, None),) * nsend,
        out_specs=(P(axis), P(axis)))

    def ff(params, xh, xl):
        data, cols, send = params
        return mapped(data, cols, xh, xl, *send)

    return ff


class GatherEllOperator(LinearOperator):
    """Row-sharded general-sparsity operator with a partition-time gather
    schedule instead of the all-gather fallback.

    Parameters
    ----------
    ell : :class:`pykrylov_tpu.sparse.formats.ELL` container or a COO
        container (converted).  RECTANGULAR containers are supported:
        the row space (length ``m + self.pad``) and the column space
        (length ``n + self.pad_n``) are blocked over the SAME mesh axis,
        so both-sides-large m×n least squares runs fully sharded — the
        regime :class:`~pykrylov_tpu.parallel.tall.TallSkinnyOperator`'s
        replicated n-side cannot hold (reference single-process analogue:
        pysparse C SpMV + matvec_transp, ``linop/linop.py:666-706``).
        Pass HOST-resident containers (``device=False``): construction
        reads the arrays on the host, so a device-resident container
        is first copied back from the device.
    mesh : 1-D ``jax.sharding.Mesh``; rows are blocked over ``axis``.
    symmetric : structural+value symmetry contract (``op.T`` reuses the
        forward product; square only).  Nonsymmetric operators get a
        true transpose product through the REVERSED schedule (same
        traffic volume) — sharded LSQR/LSMR/CRAIG on general systems
        work out of the box.

    Maps column-space vectors (length ``n + self.pad_n``) to row-space
    vectors (length ``m + self.pad``), both sharded with
    :func:`~pykrylov_tpu.parallel.sharded.shard_vector`.
    """

    def __init__(self, ell, mesh, axis=ROW_AXIS, symmetric=False, **kwargs):
        if isinstance(ell, F.COO):
            ell = F.ell_from_coo(ell, device=False)
        m, n = ell.shape
        if symmetric and m != n:
            raise ValueError("symmetric requires a square operator")
        d = mesh.shape[axis]
        mp = pad_to_multiple(m, d)
        np_ = pad_to_multiple(n, d)
        Lrow = mp // d   # rows of A (and y entries) per device
        Lx = np_ // d    # x entries per device
        K = ell.data.shape[1]

        data = np.zeros((mp, K), dtype=np.asarray(ell.data).dtype)
        cols = np.zeros((mp, K), dtype=np.int64)
        data[:m] = np.asarray(ell.data)
        cols[:m] = np.asarray(ell.cols)

        cols_local, sendidx, lens = build_gather_schedule(cols, data, d,
                                                          Lx, Lrow)
        round_lens = tuple(s.shape[1] for s in sendidx)

        sh2 = NamedSharding(mesh, P(axis, None))
        data_s = jax.device_put(data, sh2)
        cols_s = jax.device_put(cols_local, sh2)
        send_s = tuple(jax.device_put(s, sh2) for s in sendidx)

        mv = _gather_mv_factory(axis, d, round_lens, mesh)
        if symmetric:
            rmv = mv
        else:
            rmv = _gather_mvT_factory(axis, d, round_lens, Lx, mesh)
        from ..solvers.ffmv import register_ff_matvec
        register_ff_matvec(mv, _gather_ff_factory(axis, d, round_lens,
                                                  mesh))

        is_complex = np.issubdtype(data.dtype, np.complexfloating)
        super().__init__(np_, mp, matvec=mv,
                         matvec_transp=rmv,
                         params=(data_s, cols_s, send_s),
                         _takes_params=True, symmetric=symmetric,
                         hermitian=symmetric and not is_complex,
                         dtype=data.dtype, **kwargs)
        self.pad = mp - m
        self.pad_n = np_ - n
        self.mesh = mesh
        # padded entries actually shipped per matvec vs the all-gather
        self.comm_entries_per_matvec = int(sum(d * Lk for Lk in round_lens))
        self.comm_entries_true = int(sum(sum(t) for t in lens))
        self.allgather_entries_per_matvec = int(d * (d - 1) * Lx)

    @property
    def container(self):
        return self._params


_register_as_linop(GatherEllOperator)
