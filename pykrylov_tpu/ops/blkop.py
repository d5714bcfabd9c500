"""Block operators.

JAX-native equivalent of the reference block-operator layer
(``/root/reference/pykrylov/linop/blkop.py``): a 2-D grid of operators acting
on conformally split vectors, a block-diagonal variant, and preconditioner
aliases exposing ``solve``.  The block matvec slices the input once at trace
time (static offsets), applies each block, and concatenates — XLA sees a flat
fused expression, not a Python loop at run time.

Parity notes:
  * symmetric/hermitian construction auto-fills the lower triangle with
    ``.T``/``.H`` twins (``blkop.py:21-42``);
  * ``__getitem__`` returns sub-block operators for slice indexing
    (``blkop.py:122-144``, ``blkop.py:237-243``);
  * ``BlockDiagonalLinearOperator`` is symmetric iff all blocks are
    (``blkop.py:162-165``).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .base import (BaseLinearOperator, LinearOperator, ShapeError,
                   ZeroOperator, _register_as_linop)

__all__ = [
    "BlockLinearOperator",
    "BlockDiagonalLinearOperator",
    "BlockHorizontalLinearOperator",
    "BlockVerticalLinearOperator",
    "BlockPreconditioner",
    "BlockDiagonalPreconditioner",
]


def _split_offsets(sizes):
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    return offs


def _blk_mv_factory(col_sizes, row_sizes, transpose=False, adjoint=False):
    col_offs = _split_offsets(col_sizes)

    def mv(params, x):
        blocks = params  # tuple of tuples of operators
        nrow = len(blocks)
        ncol = len(blocks[0])
        row_parts = []
        for i in range(nrow):
            acc = None
            for j in range(ncol):
                op = blocks[i][j]
                xj = x[col_offs[j]:col_offs[j + 1]]
                if adjoint:
                    yij = op.apply_with(op._hmv, xj)
                elif transpose:
                    yij = op.apply_with(op._rmv, xj)
                else:
                    yij = op.apply_with(op._mv, xj)
                acc = yij if acc is None else acc + yij
            row_parts.append(acc)
        return jnp.concatenate(row_parts)
    return mv


class BlockLinearOperator(LinearOperator):
    """General block operator from a 2-D grid (list of lists) of operators.

    In symmetric/hermitian mode, pass only the upper triangle of each row;
    the lower triangle is completed with transposed/adjoint twins.
    """

    def __init__(self, blocks, symmetric=False, hermitian=False, **kwargs):
        if symmetric or hermitian:
            # Upper-triangular input: row i has (ncols - i) blocks.
            nrow = len(blocks)
            full = [[None] * nrow for _ in range(nrow)]
            for i, row in enumerate(blocks):
                if len(row) != nrow - i:
                    raise ShapeError("symmetric block structure must be upper triangular")
                for k, op in enumerate(row):
                    j = i + k
                    full[i][j] = op
                    if i != j:
                        full[j][i] = op.H if hermitian else op.T
                if not (full[i][i].symmetric or (hermitian and full[i][i].hermitian)):
                    raise ValueError("diagonal blocks must be symmetric/hermitian")
            blocks = full

        nrow = len(blocks)
        ncol = len(blocks[0])
        for row in blocks:
            if len(row) != ncol:
                raise ShapeError("all block rows must have the same length")
        # Consistent shapes along rows and columns.
        row_sizes = [row[0].nargout for row in blocks]
        col_sizes = [op.nargin for op in blocks[0]]
        for i, row in enumerate(blocks):
            for j, op in enumerate(row):
                if op.nargout != row_sizes[i] or op.nargin != col_sizes[j]:
                    raise ShapeError("block (%d,%d) has inconsistent shape" % (i, j))

        dtype = jnp.result_type(*[op.dtype for row in blocks for op in row])
        m, n = sum(row_sizes), sum(col_sizes)
        blocks_t = tuple(tuple(row) for row in blocks)
        # Transpose grid for rmv/hmv.
        grid_T = tuple(tuple(blocks_t[i][j] for i in range(nrow)) for j in range(ncol))

        def rmv(params, x):
            return _blk_mv_factory(row_sizes, col_sizes, transpose=True)(
                tuple(tuple(params[i][j] for i in range(nrow)) for j in range(ncol)), x)

        def hmv(params, x):
            return _blk_mv_factory(row_sizes, col_sizes, adjoint=True)(
                tuple(tuple(params[i][j] for i in range(nrow)) for j in range(ncol)), x)

        super().__init__(
            n, m,
            matvec=_blk_mv_factory(col_sizes, row_sizes),
            matvec_transp=rmv, matvec_adj=hmv,
            params=blocks_t, _takes_params=True,
            symmetric=symmetric, hermitian=hermitian,
            dtype=dtype, **kwargs)
        self._row_sizes = row_sizes
        self._col_sizes = col_sizes

    @property
    def blocks(self):
        """The grid of blocks as a tuple of tuples."""
        return self._params

    def __getitem__(self, indices):
        grid = np.empty((len(self._params), len(self._params[0])), dtype=object)
        for i, row in enumerate(self._params):
            for j, op in enumerate(row):
                grid[i, j] = op
        sub = grid[indices]
        if isinstance(sub, np.ndarray):
            if sub.ndim == 1:
                # A 1-D selection is a block ROW unless the column index
                # was the scalar one: blk[0] / blk[0, :] -> 1xk row;
                # blk[:, 0] / blk[[0,1], 1] -> kx1 column.
                if isinstance(indices, tuple) and np.isscalar(indices[1]):
                    sub = sub.reshape(-1, 1)
                else:
                    sub = sub.reshape(1, -1)
            return BlockLinearOperator([list(r) for r in sub])
        return sub

    def __setitem__(self, indices, val):
        grid = [list(row) for row in self._params]
        i, j = indices
        if not isinstance(val, BaseLinearOperator):
            raise ValueError("block must be a linear operator")
        if val.shape != (self._row_sizes[i], self._col_sizes[j]):
            raise ShapeError(
                "block (%d,%d) must have shape %s, got %s"
                % (i, j, (self._row_sizes[i], self._col_sizes[j]),
                   val.shape))
        grid[i][j] = val
        self._params = tuple(tuple(row) for row in grid)
        # Cached .T/.H twins captured the old params tuple at creation;
        # drop them so they are rebuilt against the mutated grid.
        self._transpose_of = self._adjoint_of = self._conjugate_of = None

    def __contains__(self, op):
        return any(op is b or op == b for row in self._params for b in row)

    def __iter__(self):
        for row in self._params:
            for b in row:
                yield b


_register_as_linop(BlockLinearOperator)


class BlockDiagonalLinearOperator(LinearOperator):
    """Block-diagonal operator from a 1-D list of blocks (``blkop.py:154-256``)."""

    def __init__(self, blocks, **kwargs):
        blocks = tuple(blocks)
        for op in blocks:
            if not isinstance(op, BaseLinearOperator):
                raise ValueError("blocks must be linear operators")
        row_sizes = [op.nargout for op in blocks]
        col_sizes = [op.nargin for op in blocks]
        symmetric = all(op.symmetric for op in blocks)
        hermitian = all(op.hermitian for op in blocks)
        dtype = jnp.result_type(*[op.dtype for op in blocks])
        m, n = sum(row_sizes), sum(col_sizes)
        col_offs = _split_offsets(col_sizes)
        row_offs = _split_offsets(row_sizes)

        def mv(params, x):
            return jnp.concatenate([
                op.apply_with(op._mv, x[col_offs[j]:col_offs[j + 1]])
                for j, op in enumerate(params)])

        def rmv(params, x):
            return jnp.concatenate([
                op.apply_with(op._rmv, x[row_offs[j]:row_offs[j + 1]])
                for j, op in enumerate(params)])

        def hmv(params, x):
            return jnp.concatenate([
                op.apply_with(op._hmv, x[row_offs[j]:row_offs[j + 1]])
                for j, op in enumerate(params)])

        super().__init__(n, m, matvec=mv, matvec_transp=rmv, matvec_adj=hmv,
                         params=blocks, _takes_params=True,
                         symmetric=symmetric, hermitian=hermitian,
                         dtype=dtype, **kwargs)

    @property
    def blocks(self):
        return self._params

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return BlockDiagonalLinearOperator(self._params[idx])
        return self._params[idx]

    def __setitem__(self, idx, ops):
        blocks = list(self._params)
        blocks[idx] = ops
        if isinstance(idx, slice):
            self.__init__(blocks)
        else:
            if not isinstance(ops, BaseLinearOperator):
                raise ValueError("block must be a linear operator")
            self._params = tuple(blocks)

    def __iter__(self):
        return iter(self._params)


_register_as_linop(BlockDiagonalLinearOperator)


def BlockHorizontalLinearOperator(blocks, **kwargs):
    """A 1 x k row of blocks as a single operator."""
    return BlockLinearOperator([list(blocks)], **kwargs)


def BlockVerticalLinearOperator(blocks, **kwargs):
    """A k x 1 column of blocks as a single operator."""
    return BlockLinearOperator([[b] for b in blocks], **kwargs)


class BlockPreconditioner(BlockLinearOperator):
    """Block operator with a ``solve`` alias for preconditioning
    (``blkop.py:259-266``)."""

    def solve(self, x):
        return self.__call__(x)


class BlockDiagonalPreconditioner(BlockDiagonalLinearOperator):
    """Block-diagonal preconditioner with ``solve`` (``blkop.py:269-276``)."""

    def solve(self, x):
        return self.__call__(x)


_register_as_linop(BlockPreconditioner)
_register_as_linop(BlockDiagonalPreconditioner)
