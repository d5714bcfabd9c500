"""Multi-chip parallelism: meshes, sharded operators, halo exchange.

The reference is a single-process library with no distributed backend
(SURVEY §2.5); its scaling story is "matrix-free closures".  The device-native
equivalent (SURVEY §7 stage 7) is 1-D row-block partitioning of the system
over a ``jax.sharding.Mesh``:

  * sparse containers carry ``NamedSharding`` on their row dimension;
  * vectors are sharded with the matching row layout;
  * dot products inside the fused solver loops become partial reductions +
    ``psum`` — inserted automatically by XLA's SPMD partitioner because the
    solvers are plain jit functions over sharded pytrees;
  * stencil/banded (DIA) matvecs use an explicit ``shard_map`` +
    ``ppermute`` neighbor halo exchange (:mod:`.halo`) — the analogue of
    ring/CP neighbor exchange in transformer training;
  * general sparsity (ELL) falls back to an XLA-inserted all-gather of x.

Multi-host bootstrap is ``jax.distributed.initialize`` + the same mesh API;
nothing in this package distinguishes single-host from multi-host meshes.
"""

from .mesh import (make_mesh, default_mesh, device_mesh_info,
                   initialize_multihost)
from .sharded import (shard_vector, replicate, shard_operator,
                      sharded_poisson3d)
from .halo import HaloDiaOperator
from .stencil import HaloStencilPoisson3DOperator
from .gather import GatherEllOperator, build_gather_schedule
from .tall import TallSkinnyOperator
from .halo2d import (Halo2DPoissonOperator, make_mesh2d, shard_vector_2d,
                     to_bricks, from_bricks)

__all__ = [
    "TallSkinnyOperator",
    "make_mesh", "default_mesh", "device_mesh_info",
    "initialize_multihost",
    "shard_vector", "replicate", "shard_operator", "sharded_poisson3d",
    "HaloDiaOperator", "HaloStencilPoisson3DOperator",
    "GatherEllOperator", "build_gather_schedule",
    "Halo2DPoissonOperator", "make_mesh2d", "shard_vector_2d",
    "to_bricks", "from_bricks",
]
