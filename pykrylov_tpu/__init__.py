"""pykrylov_tpu — a JAX-native Krylov subspace solver framework.

Built from scratch on JAX / XLA / pjit with the capabilities of
the reference PythonOptimizers/pykrylov library (see SURVEY.md): a
composable linear-operator layer, the full Krylov solver family (CG,
MINRES, SYMMLQ, BiCGSTAB, CGS, TFQMR, LSQR, LSMR, CRAIG, CRAIG-MR),
sparse-matrix containers with XLA SpMV paths, MatrixMarket tooling,
a problem gallery, and multi-chip sharding over ``jax.sharding.Mesh``.
"""

from .version import __version__

from . import utils
from . import ops
from .ops import (
    ShapeError, BaseLinearOperator, LinearOperator, IdentityOperator,
    DiagonalOperator, ZeroOperator, MatrixOperator, CoordLinearOperator,
    PysparseLinearOperator, ReducedLinearOperator,
    SymmetricallyReducedLinearOperator, linop_from_ndarray, aslinearoperator,
    sqrt, BlockLinearOperator, BlockDiagonalLinearOperator,
    BlockPreconditioner, BlockDiagonalPreconditioner,
    InverseLBFGSOperator, LBFGSOperator, CompactLBFGSOperator,
    StructuredLBFGSOperator, CholeskyOperator, HostFactorizationOperator,
    lanczos_bounds, ChebyshevOperator, chebyshev_preconditioner,
    pack_complex, unpack_complex, real_equivalent_dense,
    real_equivalent_coo, real_equivalent_operator, complex_solve,
)
from .utils import (machine_epsilon, roots_quadratic, check_symmetric,
                    check_positive_definite)
from .solve import solve

# Subpackages with heavier imports are imported lazily by attribute access.
_LAZY_SUBMODULES = ("solvers", "sparse", "parallel", "io", "gallery", "compat")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib
        mod = importlib.import_module("." + name, __name__)
        globals()[name] = mod
        return mod
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
