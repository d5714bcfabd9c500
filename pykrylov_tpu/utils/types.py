"""Numeric type whitelists for operators and solvers.

JAX-native re-design of the reference type tables
(``/root/reference/pykrylov/tools/types.py:1-16``): the reference whitelists
NumPy dtypes up to ``float128``/``complex256``; JAX supports
``bfloat16``/``float32`` always and ``float64``/``complex128`` when x64 is
enabled, so the tables are built from what the active JAX build exposes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Integer dtypes accepted for promotion into operators.
integer_types = [np.dtype(t) for t in (np.int8, np.int16, np.int32, np.int64)]

# Real floating dtypes, smallest to largest.
real_types = [np.dtype(t) for t in (jnp.bfloat16, np.float16, np.float32, np.float64)]

# Complex dtypes.
complex_types = [np.dtype(t) for t in (np.complex64, np.complex128)]

# All dtypes allowed as an operator/vector dtype.
allowed_types = integer_types + real_types + complex_types


def is_complex_dtype(dtype) -> bool:
    """True if ``dtype`` is a complex floating dtype."""
    return np.issubdtype(np.dtype(dtype), np.complexfloating)


def is_real_dtype(dtype) -> bool:
    """True if ``dtype`` is a real floating dtype (incl. bfloat16)."""
    d = np.dtype(dtype)
    return d in real_types


def result_type(*dtypes):
    """Promote dtypes with JAX semantics (respects x64 enablement)."""
    return jnp.result_type(*dtypes)
