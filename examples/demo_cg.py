"""CG demo (parity: ``/root/reference/examples/demo_cg.py``).

Solves A x = A·e on a symmetric matrix (default the bundled 1138bus) with
per-iteration logging to stdout.
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))  # repo root

import jax as _jax
# The demo protocol reproduces the reference's float64 numbers (1138bus is
# too ill-conditioned for f32); f64 is native on the GPU.  The default
# device is used; set JAX_PLATFORMS=cpu to run on the CPU.
_jax.config.update("jax_enable_x64", True)

import logging
import sys

from pykrylov_tpu.compat import CG
from demo_common import demo

if __name__ == "__main__":
    cglog = logging.getLogger("CG")
    cglog.setLevel(logging.INFO)
    fmt = logging.Formatter("%(name)-2s %(levelname)-8s %(message)s")
    hndlr = logging.StreamHandler(sys.stdout)
    hndlr.setFormatter(fmt)
    cglog.addHandler(hndlr)

    mtx = sys.argv[1] if len(sys.argv) > 1 else "1138bus"
    demo(CG, mtx, symmetric=True, logger=cglog)
