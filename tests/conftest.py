"""Test configuration: run everything on a virtual 8-device CPU mesh.

The reference validates numerics in float64 (SURVEY §4); we enable x64 and
force the CPU backend with 8 virtual devices so sharding tests exercise real
multi-device meshes without a GPU.  Tests that need the card are marked
``gpu`` and take the :func:`gpu` fixture; they run on the card with

    PYKRYLOV_TEST_ON_CARD=1 python -m pytest tests/ -m gpu

which leaves JAX on its default (GPU) backend.
"""

import os

ON_CARD = os.environ.get("PYKRYLOV_TEST_ON_CARD") == "1"

_FLAG = "--xla_force_host_platform_device_count=8"
if not ON_CARD and "xla_force_host_platform_device_count" not in \
        os.environ.get("XLA_FLAGS", ""):
    # Append rather than setdefault: a pre-set XLA_FLAGS (user dump
    # flags) must not silently drop the virtual device count.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                               + _FLAG).strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except Exception:
        pass
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The GPU devices; skips the test when JAX runs on another backend.
    Decided here, at run time, so every worker collects the same tests.
    Asked to run on the card (``PYKRYLOV_TEST_ON_CARD=1``) the test fails
    instead: JAX falls back to the CPU with only a warning when its GPU
    plugin does not load, and a skip would then pass for a card run."""
    if jax.default_backend() != "gpu":
        if ON_CARD:
            pytest.fail("PYKRYLOV_TEST_ON_CARD=1 but JAX's backend is %r"
                        % jax.default_backend())
        pytest.skip("needs the GPU: PYKRYLOV_TEST_ON_CARD=1 python -m "
                    "pytest tests/ -m gpu")
    return jax.devices()
