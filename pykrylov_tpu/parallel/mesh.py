"""Device-mesh construction helpers.

Thin wrappers over ``jax.make_mesh`` fixing this library's axis convention:
the system's row dimension is sharded over the ``"rows"`` axis.  The cards
of one host are joined all to all by NVLink, so a 1-D ``rows`` mesh loses
nothing to topology; across hosts, ``jax.distributed.initialize`` makes all
devices visible and the same calls produce a mesh spanning the hosts.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, AxisType

__all__ = ["make_mesh", "default_mesh", "device_mesh_info",
           "initialize_multihost", "ROW_AXIS"]

ROW_AXIS = "rows"

# environment hints that indicate a real multi-process launch
_MULTIHOST_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, **kwargs):
    """Multi-host bootstrap: ``jax.distributed.initialize`` + the
    post-init device summary.

    The reference is single-process (SURVEY §2.5); the device-native
    equivalent is one JAX process per host with all devices globally
    visible, after which the SAME ``make_mesh``/solver code produces a
    mesh spanning the hosts and XLA hands the collectives to NCCL.  Call
    this once at startup on every host.

    Explicit arguments are forwarded verbatim: give
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``.  With no arguments the call initializes only when a
    coordinator variable is set, and degrades to a documented no-op on a
    plain single-process launch — so driver scripts can call it
    unconditionally.  Idempotent.
    """
    import os
    explicit = (coordinator_address is not None
                or num_processes is not None or kwargs)
    detected = any(os.environ.get(k) for k in _MULTIHOST_ENV)
    if explicit or detected:
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id,
                **kwargs)
        except RuntimeError as e:
            # idempotent on re-init; a live single-process backend only
            # errors when the caller explicitly demanded multi-host
            already = ("already" in str(e).lower()
                       or "before" in str(e).lower())
            if explicit and "already" not in str(e).lower():
                raise
            if not already:
                raise
        except ValueError:
            # env hinted at multi-host but auto-detection could not
            # resolve a coordinator: a single-process launch, not an
            # error
            if explicit:
                raise
    info = device_mesh_info(default_mesh())
    info["process_index"] = jax.process_index()
    info["process_count"] = jax.process_count()
    return info


def make_mesh(n_devices=None, axis_name=ROW_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all).

    Axes are ``Auto``-typed: sharding propagates through the unchanged
    solver jits and XLA inserts the collectives (newer JAX defaults to
    Explicit sharding-in-types, which would require annotating every
    intermediate in the solver loops).
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError("requested %d devices, only %d available"
                         % (n_devices, len(devs)))
    return jax.make_mesh((n_devices,), (axis_name,),
                         axis_types=(AxisType.Auto,),
                         devices=devs[:n_devices])


def default_mesh() -> Mesh:
    return make_mesh()


def device_mesh_info(mesh: Mesh) -> dict:
    """Host-side summary used by benchmarks and logs."""
    return {
        "axis_names": tuple(mesh.axis_names),
        "shape": dict(mesh.shape),
        "n_devices": mesh.size,
        "platform": mesh.devices.ravel()[0].platform,
    }
