"""Bring-up helpers for the scripts that run on the card.

* :func:`enable_compile_cache` — one rule for JAX's persistent compile
  cache: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
  itself), else a fixed directory inside the checkout.  The path is part
  of the cache key, so it is never temporary or per-process.
* :func:`require_gpu` — a measurement path that finds no GPU fails; it
  never falls back to the CPU.
* :func:`card_info` — the card's name and power limit, read by a child
  process that does not touch JAX.
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["compile_cache_dir", "enable_compile_cache", "require_gpu",
           "card_info", "CACHE_ENV"]

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_CACHE_SUBDIR = ".jax_cache"


def compile_cache_dir(root):
    """The compile-cache directory for a checkout rooted at ``root``."""
    return (os.environ.get(CACHE_ENV)
            or os.path.join(os.path.abspath(root), _CACHE_SUBDIR))


def enable_compile_cache(root):
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    and return the path.  With ``$JAX_COMPILATION_CACHE_DIR`` set, JAX
    already uses it and nothing is set here."""
    path = compile_cache_dir(root)
    if not os.environ.get(CACHE_ENV):
        import jax
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """Return the GPU devices, or raise when JAX found none."""
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            "no GPU: JAX found %s devices; a measurement on the card "
            "cannot run here" % devs[0].platform)
    return devs


def card_info():
    """``nvidia-smi --query-gpu=name,power.limit`` lines (one per card),
    or a one-line note when ``nvidia-smi`` cannot be run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return ["nvidia-smi unavailable (%s)" % type(e).__name__]
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
