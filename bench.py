"""Headline benchmark: DIA SpMV streaming bandwidth on one GPU.

The reference publishes no wall-clock numbers (BASELINE.md); the build's
perf north star is SpMV throughput above 0.8 of the HBM-bandwidth roofline
(BASELINE.json).  This benchmark streams the banded format — DIA, shifted
axpys that XLA fuses into one pass — for the 7-point 3-D Poisson operator
on a 256^3 grid (16.8M unknowns, the local grid commonly run per GPU in
HPCG) and reports the achieved effective bandwidth.  Beside it: the XLA
ELL product of jpwh_991 tiled 1024-fold (general sparsity) and a large
copy measured in the same process.

Model: one matvec must move the diagonal data (ndiag·m values) plus read x
and write y once each → minimal HBM traffic = (ndiag·m + 2m)·sizeof(dtype).
``vs_baseline`` is that rate over the card's published peak
(:data:`HBM_PEAK_GBPS`); the north-star target is 0.8.

Needs a GPU (no CPU fallback).  Prints ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "detail"}.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.abspath(__file__))

# Peak HBM bandwidth in GB/s by ``device_kind``.  Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM part (80 GB HBM3 at 3.35 TB/s).
HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def peak_bandwidth_gbps(kind) -> float:
    """Published peak for a ``device_kind``; an unknown device is an
    error, not a default."""
    try:
        return HBM_PEAK_GBPS[kind]
    except KeyError:
        raise ValueError("no published HBM peak for device kind %r; add "
                         "it to HBM_PEAK_GBPS with its source" % (kind,))


def _best_chain(mv, params, x, iters):
    """Best-of-3 wall of ``iters`` chained products, each run on a fresh
    input and ended by ``block_until_ready``."""
    chain = jax.jit(lambda p, v: jax.lax.fori_loop(
        0, iters, lambda _, u: mv(p, u), v))
    jax.block_until_ready(chain(params, x))
    best = np.inf
    for rep in range(3):
        xr = jax.block_until_ready(x * (1.0 + 0.125 * (rep + 1)))
        t0 = time.perf_counter()
        jax.block_until_ready(chain(params, xr))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    from pykrylov_tpu.gallery.general import tiled_general_coo
    from pykrylov_tpu.gallery.poisson import poisson3d_dia
    from pykrylov_tpu.sparse import formats as F
    from pykrylov_tpu.utils.device import (card_info, enable_compile_cache,
                                           require_gpu)

    enable_compile_cache(ROOT)
    devs = require_gpu()
    kind = devs[0].device_kind
    peak = peak_bandwidth_gbps(kind)
    dtype = np.float32

    # The 1/12 scale keeps the spectral radius under 1, so the chain
    # neither overflows nor underflows; folded into the data once.
    n = 256
    dia = poisson3d_dia(n, dtype=dtype)
    data = jnp.asarray(dia.data / 12.0)
    m, ndiag = dia.shape[0], data.shape[0]
    iters = 200
    best = _best_chain(lambda d, v: F.dia_matvec(
        F.DIA(d, dia.offsets, dia.shape), v), data, jnp.ones(m, dtype),
        iters)
    bytes_per_mv = (ndiag * m + 2 * m) * np.dtype(dtype).itemsize
    gbps = iters * bytes_per_mv / best / 1e9

    # general sparsity: XLA ELL on jpwh_991 tiled 1024-fold, uncoupled
    # (the matrix chip_smoke.py solves and times)
    v, r, c, s = tiled_general_coo(tiles=1024, coupling=0, dtype=dtype)
    v = (v / np.abs(v).max() / 8.0).astype(dtype)
    ell = F.ell_from_coo(F.coo_from_arrays(v, r, c, s, device=False),
                         pad_to=4)
    best_e = _best_chain(lambda a, u: F.ell_matvec(a, u), ell,
                         jnp.ones(s[1], dtype), iters)
    ell_bytes = (ell.data.size * 4 + ell.cols.size * 4 + 8 * s[0])

    # a large copy in the same process: what plain streaming reaches
    big = jnp.ones((4, m), dtype)
    best_c = _best_chain(lambda _, u: u * 0.999, None, big, 50)
    copy_gbps = 50 * 2 * big.size * 4 / best_c / 1e9

    print(json.dumps({
        "metric": "spmv_dia_poisson3d_bandwidth",
        "value": round(gbps, 2),
        "unit": "GB/s",
        "vs_baseline": round(gbps / peak, 4),
        "detail": {
            "device": {"platform": devs[0].platform, "kind": kind,
                       "count": len(devs)},
            "card": card_info(),
            "n_grid": n, "m": m, "ndiag": ndiag,
            "ms_per_mv": round(best / iters * 1e3, 4),
            "peak_gbps": peak,
            "peak_source": "NVIDIA H100 data sheet (SXM)",
            "copy_gbps": round(copy_gbps, 1),
            "vs_copy": round(gbps / copy_gbps, 4),
            "ell_tiled_jpwh": {
                "m": s[0], "nnz": len(v), "K": int(ell.data.shape[1]),
                "ms_per_mv": round(best_e / iters * 1e3, 4),
                "gbps_own_arrays": round(iters * ell_bytes / best_e / 1e9,
                                         1),
                "nnz_per_s_G": round(iters * len(v) / best_e / 1e9, 2),
            },
        },
    }))


if __name__ == "__main__":
    main()
