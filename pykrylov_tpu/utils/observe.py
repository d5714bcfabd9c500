"""Observability: profiling hooks, solve tracing, distributed assertions.

The reference's only observability artifacts are matvec counters and
residual histories (SURVEY §5); those are first-class in
:class:`~pykrylov_tpu.solvers.SolveResult`.  This module adds the
JAX-native extras SURVEY §5 calls for:

  * :func:`trace` / :func:`profiled` — ``jax.profiler`` trace capture
    around a solve, viewable in TensorBoard/Perfetto;
  * :func:`annotate` — named ``TraceAnnotation`` spans inside traces;
  * :func:`assert_replicated` — the analogue of a race detector for SPMD
    numerics: verifies a supposedly replicated quantity is bitwise
    identical on every device of a mesh (catching nondeterministic or
    divergent collectives);
  * :func:`solve_stats` — host-side summary dict of a SolveResult for
    metrics pipelines.
"""

from __future__ import annotations

import contextlib

import numpy as np
import jax

__all__ = ["trace", "profiled", "annotate", "assert_replicated",
           "solve_stats"]


@contextlib.contextmanager
def trace(log_dir):
    """Capture a ``jax.profiler`` device trace around a block.

    >>> with trace("/tmp/pykrylov-trace"):
    ...     res = cg(A, b)
    """
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def profiled(fn, log_dir):
    """Wrap a solve callable so each invocation is trace-captured."""
    def wrapper(*args, **kwargs):
        with trace(log_dir):
            out = fn(*args, **kwargs)
            jax.block_until_ready(jax.tree_util.tree_leaves(out))
        return out
    return wrapper


def annotate(name):
    """Named span inside a profiler trace (``jax.profiler`` annotation)."""
    return jax.profiler.TraceAnnotation(name)


def assert_replicated(x, atol=0.0):
    """Assert an addressable array holds identical values on all devices.

    For a fully-replicated sharding this checks the per-device shards are
    bitwise equal (``atol=0``) — divergence means a nondeterministic
    collective or data race in a custom kernel.  Returns the host value.
    """
    shards = getattr(x, "addressable_shards", None)
    if not shards or len(shards) <= 1:
        return np.asarray(x)
    ref = np.asarray(shards[0].data)
    for s in shards[1:]:
        got = np.asarray(s.data)
        if ref.shape != got.shape:
            raise AssertionError(
                "shard shapes differ: %s vs %s (device %s)"
                % (ref.shape, got.shape, s.device))
        if atol == 0.0:
            same = np.array_equal(ref, got)
        else:
            same = np.allclose(ref, got, atol=atol, rtol=0)
        if not same:
            raise AssertionError(
                "replicated value diverges on device %s "
                "(max abs diff %.3e)" % (
                    s.device, float(np.max(np.abs(ref - got)))))
    return ref


def solve_stats(result, wall_time=None):
    """Host-side metrics summary of a :class:`SolveResult`."""
    stats = {
        "converged": bool(result.converged),
        "istop": int(result.istop),
        "n_iter": int(result.n_iter),
        "n_matvec": int(result.n_matvec),
        "resid_norm": float(result.resid_norm),
        "resid_norm0": float(result.resid_norm0),
    }
    if wall_time is not None:
        stats["wall_time_s"] = float(wall_time)
        stats["iter_per_s"] = stats["n_iter"] / max(wall_time, 1e-12)
    for k, v in result.info.items():
        if np.ndim(v) == 0:
            try:
                stats[k] = float(v)
            except (TypeError, ValueError):
                pass
    return stats
