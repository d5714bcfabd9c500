"""Run the solver library's main path once on the GPU and check it.

    python chip_smoke.py              # one card, phases 1-7
    python chip_smoke.py --four       # four cards: the sharded phase only
    python chip_smoke.py --rehearse   # CPU backend, tiny sizes (add --four
                                      # for four virtual CPU devices)

Every phase goes through the public front door (``operator_from_coo(fmt=
"auto")`` / ``sparse_operator``, then ``solve()`` or a named solver) and is
checked against an f64 host (NumPy/SciPy) reference of the same matrix.
Each check prints its tolerance and the reason for it.  A failed check
raises, so the process exits non-zero and prints no result line.  Without
``--rehearse`` a process that finds no GPU fails at once.

The last line of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Times are host-clock walls ended by ``block_until_ready``; compile time is
reported as set-up.  Phase 6 times are information only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class Sizes:
    """Problem sizes: the card-filling ones, or tiny ones for a rehearsal."""

    def __init__(self, rehearse):
        small = rehearse
        # 256^3: the local grid commonly run per GPU in HPCG
        self.poisson_n = 12 if small else 256
        # jpwh_991 tiled 1024-fold: ~1.01M rows, ~6.2M nnz
        self.tiles = 4 if small else 1024
        # tall sparse least squares, ~8 nnz per row
        self.lsq_m, self.lsq_n = (4000, 1000) if small else \
            (2_000_000, 500_000)
        self.ff_n = 1 << (12 if small else 24)
        self.chain = 3 if small else 100
        # four cards: 4 x 256^3 unknowns (406^3 ~ 67M), tiled jpwh ~4x.
        # The tile count is odd, so shard boundaries cut through tiles
        # and the gather schedule must move x entries between cards.
        self.four_poisson_n = 20 if small else 406
        self.four_tiles = 9 if small else 4095


def log(*a):
    print(*a, flush=True)


def check(ok, what, value, tol, why):
    """Print one check with its tolerance and reason; raise if it failed."""
    log("    %-44s %-12s limit %-10s (%s)  %s"
        % (what, "%.3e" % value if isinstance(value, float) else value,
           "%.3e" % tol if isinstance(tol, float) else tol, why,
           "ok" if ok else "FAILED"))
    if not ok:
        raise AssertionError("%s = %r outside %r" % (what, value, tol))


def _block(tree):
    import jax
    return jax.block_until_ready(tree)


def _walls(fn, make_args, reps):
    """Walls of ``reps`` calls after one warm-up, each on fresh inputs
    (``make_args(r)``) so no call can reuse an earlier result."""
    _block(fn(*make_args(-1)))
    out = []
    for r in range(reps):
        args = _block(make_args(r))
        t0 = time.perf_counter()
        _block(fn(*args))
        out.append(time.perf_counter() - t0)
    return out


def _compile(fn, *args):
    """Jit ``fn`` and compile it for ``args``: returns the jitted function,
    the compile seconds and the compiled program (for its memory
    analysis).  The jitted function's own first call finds the program in
    the compile cache."""
    import jax
    jf = jax.jit(fn)
    t0 = time.perf_counter()
    compiled = jf.lower(*args).compile()
    return jf, time.perf_counter() - t0, compiled


def _memory(compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        return "memory_analysis: not available on this backend"
    return ("memory_analysis: arguments %.3f GB, outputs %.3f GB, "
            "temporaries %.3f GB" % (ma.argument_size_in_bytes / 1e9,
                                     ma.output_size_in_bytes / 1e9,
                                     ma.temp_size_in_bytes / 1e9))


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    if not stats or "peak_bytes_in_use" not in stats:
        return "peak_bytes_in_use: not available on this backend"
    return "peak_bytes_in_use: %.3f GB" % (stats["peak_bytes_in_use"] / 1e9)


def _csr64(vals, rows, cols, shape):
    import scipy.sparse as sp
    return sp.csr_matrix((np.asarray(vals, np.float64), (rows, cols)),
                         shape=shape)


def _rel_resid(A64, x, b):
    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(b - A64 @ x) / np.linalg.norm(b))


EPS32 = 2.0 ** -24


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase1_flagship(sz):
    """BASELINE config 1: verified CG on 1138bus in f32 with double-f32
    residual replacement, through ``__graft_entry__.entry()``."""
    import __graft_entry__ as g
    from pykrylov_tpu.io.datasets import load_bundled

    fn, args = g.entry()
    f, tc, _ = _compile(fn, *args)
    x, _, nit = _block(f(*args))
    check(x.dtype == np.float32, "solution dtype", str(x.dtype), "float32",
          "the f32 path with double-f32 carries is what is under test")
    vals, rows, cols, shape = load_bundled("1138bus")
    A64 = _csr64(vals, rows, cols, shape)
    b64 = A64 @ np.ones(shape[0])
    rel = _rel_resid(A64, x, b64)
    log("    compile %.2f s, %d iterations" % (tc, int(nit)))
    check(rel < 5e-6, "true rel. residual vs f64 host matrix", rel, 5e-6,
          "rtol 1e-6 plus the f32 rounding of b = A e")
    check(int(nit) < 20000, "iterations", int(nit), 20000, "maxiter")


def phase2_golden(sz):
    """Golden parity in native f64 on the device: the bmark trio on
    jpwh_991, and MINRES / SYMMLQ with Jacobi on 1138bus."""
    import jax
    import jax.numpy as jnp
    from pykrylov_tpu.sparse import sparse_operator, jacobi_preconditioner
    from pykrylov_tpu.solvers import bicgstab, cgs, tfqmr, minres, symmlq

    with open(os.path.join(ROOT, "data", "golden_histories.json")) as fh:
        gold = json.load(fh)
    op = sparse_operator("jpwh_991", symmetric=False, dtype=np.float64)
    n = 991
    e = jnp.ones(n, jnp.float64)
    b = op * e
    guess = 1.0 + jnp.arange(n, dtype=jnp.float64)
    for name, solver in (("cgs", cgs), ("tfqmr", tfqmr),
                         ("bicgstab", bicgstab)):
        ref = gold["%s_jpwh991_rtol1e-8" % name]
        res = solver(op, b, x0=guess, rtol=1e-8, matvec_max=2 * n)
        check(bool(res.converged), "%s converged" % name,
              bool(res.converged), True,
              "bmark protocol, rtol 1e-8")
        check(res.x.dtype == np.float64, "%s dtype" % name,
              str(res.x.dtype), "float64", "native f64 on the device")
        d = abs(int(res.n_matvec) - ref["n_matvec"])
        log("    %s: %d matvecs on %s, %d in the CPU golden"
            % (name, int(res.n_matvec), res.x.devices().pop().platform,
               ref["n_matvec"]))
        check(d <= 4, "%s matvec count - golden" % name, d, 4,
              "slack of tests/test_golden.py: reduction order")

    # MINRES / SYMMLQ have no checked-in golden: the device counts are
    # compared with the same solves on the host CPU backend
    op1 = sparse_operator("1138bus", symmetric=True, dtype=np.float64)
    M = jacobi_preconditioner("1138bus")
    e1 = jnp.ones(1138, jnp.float64)
    b1 = op1 * e1
    counts = {}
    for where in ("device", "cpu"):
        dev = jax.devices()[0] if where == "device" else \
            jax.devices("cpu")[0]
        with jax.default_device(dev):
            o, m_, bb = jax.device_put((op1, M, b1), dev)
            rm = minres(o, bb, M=m_, rtol=1e-10)
            rs = symmlq(o, bb, M=m_, rtol=1e-8)
            counts[where] = (int(rm.n_matvec), int(rs.n_matvec))
            if where == "device":
                for nm, r, tol in (("minres", rm, 5e-3),
                                   ("symmlq", rs, 5e-4)):
                    check(bool(r.converged), "%s converged" % nm,
                          bool(r.converged), True, "1138bus + Jacobi")
                    err = float(jnp.linalg.norm(r.x - e1) / np.sqrt(1138))
                    check(err < tol, "%s rms error vs e" % nm, err, tol,
                          "bound of tests/test_lanczos.py")
    log("    minres/symmlq matvecs: device %s, cpu %s"
        % (counts["device"], counts["cpu"]))
    for i, nm in enumerate(("minres", "symmlq")):
        d = abs(counts["device"][i] - counts["cpu"][i])
        check(d <= 4, "%s matvecs device - cpu" % nm, d, 4,
              "reduction order differs between backends")


def phase3_poisson(sz):
    """Card-filling banded system: 7-point 3-D Poisson, f32 CG."""
    import jax.numpy as jnp
    from pykrylov_tpu import solve
    from pykrylov_tpu.gallery.poisson import poisson3d_coo
    from pykrylov_tpu.sparse import operator_from_coo

    n = sz.poisson_n
    t0 = time.perf_counter()
    vals, rows, cols, shape = poisson3d_coo(n, dtype=np.float32)
    op = operator_from_coo(vals, rows, cols, shape, symmetric=True,
                           fmt="auto", dtype=np.float32)
    tb = time.perf_counter() - t0
    m = shape[0]
    fmt = type(op.container).__name__
    log("    %d^3 = %d unknowns, auto format %s, host build %.1f s"
        % (n, m, fmt, tb))
    check(fmt == "DIA", "auto format", fmt, "DIA", "7 diagonals")

    def run(op, b):
        r = solve(op, b, method="cg", rtol=1e-6, atol=0.0, maxiter=4 * n * n)
        return r.x, r.n_iter, r.converged

    b = jnp.ones(m, jnp.float32)
    f, tc, comp = _compile(run, op, b)
    log("    compile %.2f s; %s" % (tc, _memory(comp)))
    walls = _walls(f, lambda r: (op, b * (1.0 + 0.01 * (r + 1))), 3)
    x, nit, conv = _block(f(op, b))
    log("    %d iterations; solve walls %s s; %.4f ms/iteration (best); %s"
        % (int(nit), ["%.4f" % w for w in walls],
           min(walls) / int(nit) * 1e3, _peak_bytes()))
    check(bool(conv), "converged", bool(conv), True, "rtol 1e-6")
    A64 = _csr64(vals, rows, cols, shape)
    rel = _rel_resid(A64, x, np.ones(m))
    # An f32 solve cannot get below its rounding floor eps |A||x| / |b|;
    # the recursive residual drifts from the true one by about
    # sqrt(iterations) of it (0.19 sqrt(k) floor measured on the CPU)
    x64 = np.asarray(x, np.float64)
    floor = EPS32 * np.linalg.norm(abs(A64) @ np.abs(x64)) / np.sqrt(m)
    tol = max(1e-6, float(np.sqrt(int(nit)) * floor))
    check(rel < tol, "true rel. residual vs SciPy f64", rel, tol,
          "sqrt(iterations) x f32 floor %.2e" % floor)


def phase4_general(sz):
    """Card-filling general sparsity: tiled jpwh_991, BiCGSTAB in f64."""
    import jax.numpy as jnp
    from pykrylov_tpu import solve
    from pykrylov_tpu.gallery.general import tiled_general_coo
    from pykrylov_tpu.sparse import operator_from_coo

    # Native f64: the f32 BiCGSTAB recurrence stalls near 4e-4 relative
    # on jpwh_991 itself.  Uncoupled tiles: the random inter-tile
    # entries of tiled_general_coo are as large as the matrix's own; at
    # 64 tiles they raise the 1-norm condition estimate from 7.3e2 to
    # 1.1e5 and SciPy's own f64 BiCGSTAB breaks down on that matrix.
    t0 = time.perf_counter()
    vals, rows, cols, shape = tiled_general_coo(tiles=sz.tiles, coupling=0,
                                                dtype=np.float64)
    op = operator_from_coo(vals, rows, cols, shape, fmt="auto")
    tb = time.perf_counter() - t0
    fmt = type(op.container).__name__
    log("    %d rows, %d nnz, auto format %s (K=%d), host build %.1f s"
        % (shape[0], len(vals), fmt, op.container.data.shape[1], tb))
    check(fmt == "ELL", "auto format", fmt, "ELL", "general sparsity")
    A64 = _csr64(vals, rows, cols, shape)
    xs = np.random.default_rng(4).standard_normal(shape[0])
    b64 = A64 @ xs
    b = jnp.asarray(b64, jnp.float64)

    def run(op, b):
        r = solve(op, b, method="bicgstab", rtol=1e-8, atol=0.0,
                  matvec_max=4000)
        return r.x, r.n_iter, r.converged

    f, tc, comp = _compile(run, op, b)
    log("    compile %.2f s; %s" % (tc, _memory(comp)))
    walls = _walls(f, lambda r: (op, b * (1.0 + 0.01 * (r + 1))), 3)
    x, nit, conv = _block(f(op, b))
    log("    %d iterations; solve walls %s s; %s"
        % (int(nit), ["%.4f" % w for w in walls], _peak_bytes()))
    check(bool(conv), "converged", bool(conv), True, "rtol 1e-8")
    rel = _rel_resid(A64, x, b64)
    check(rel < 1e-7, "true rel. residual vs f64 host", rel, 1e-7,
          "rtol 1e-8 plus drift of the recursive residual")


def phase5_lsq(sz):
    """Least squares: LSQR and LSMR on a seeded tall sparse operator."""
    import jax.numpy as jnp
    from pykrylov_tpu import solve
    from pykrylov_tpu.sparse import operator_from_coo

    m, n = sz.lsq_m, sz.lsq_n
    rng = np.random.default_rng(5)
    rows = np.repeat(np.arange(m), 8)
    cols = rng.integers(0, n, rows.size)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    t0 = time.perf_counter()
    op = operator_from_coo(vals, rows, cols, (m, n), fmt="auto",
                           dtype=np.float32)
    log("    %d x %d, %d nnz, auto format %s, host build %.1f s"
        % (m, n, rows.size, type(op.container).__name__,
           time.perf_counter() - t0))
    A64 = _csr64(vals, rows, cols, (m, n))
    normA = float(np.sqrt((A64.data ** 2).sum()))
    b = jnp.asarray(rng.standard_normal(m).astype(np.float32))
    for method in ("lsqr", "lsmr"):
        def run(op, b, method=method):
            r = solve(op, b, method=method, atol=1e-6, btol=1e-6,
                      itnlim=2000)
            return r.x, r.n_iter, r.istop
        f, tc, _ = _compile(run, op, b)
        walls = _walls(f, lambda r: (op, b * (1.0 + 0.01 * (r + 1))), 2)
        x, nit, istop = _block(f(op, b))
        x64 = np.asarray(x, np.float64)
        r64 = np.asarray(b, np.float64) - A64 @ x64
        opt = float(np.linalg.norm(A64.T @ r64)
                    / (normA * np.linalg.norm(r64)))
        log("    %s: compile %.2f s, %d iterations, istop %d, walls %s s"
            % (method, tc, int(nit), int(istop),
               ["%.4f" % w for w in walls]))
        check(opt < 1e-5, "%s |A'r|/(|A|_F |r|) in f64" % method, opt,
              1e-5, "atol 1e-6 plus f32 products")


def phase6_kernels(sz):
    """Kernel comparison.  No hand-written kernel is left: the sparse
    products are XLA's.  Each is checked against the f64 host product at
    the phase-3/4 widths and timed beside a large copy (information)."""
    import jax
    import jax.numpy as jnp
    from pykrylov_tpu.gallery.general import tiled_general_coo
    from pykrylov_tpu.gallery.poisson import poisson3d_coo
    from pykrylov_tpu.sparse import formats as F

    rng = np.random.default_rng(6)
    iters = sz.chain
    cases = []
    n = sz.poisson_n
    v, r, c, s = poisson3d_coo(n, dtype=np.float32)
    coo = F.coo_from_arrays(v / 12.0, r, c, s, device=False)
    cases.append(("dia poisson %d^3" % n, F.dia_from_coo(coo), v / 12.0,
                  r, c, s))
    v, r, c, s = tiled_general_coo(tiles=sz.tiles, coupling=0,
                                   dtype=np.float32)
    scale = 1.0 / np.abs(v).max() / 8.0
    v = (v * scale).astype(np.float32)
    coo = F.coo_from_arrays(v, r, c, s, device=False)
    cases.append(("ell tiled jpwh", F.ell_from_coo(coo, pad_to=4), v, r, c,
                  s))
    cases.append(("csr tiled jpwh", F.csr_from_coo(coo), v, r, c, s))

    def mv(a, x):
        if isinstance(a, F.DIA):
            return F.dia_matvec(a, x)
        if isinstance(a, F.ELL):
            return F.ell_matvec(a, x)
        return F.csr_matvec(a, x)

    for name, a, v, r, c, s in cases:
        A64 = _csr64(v, r, c, s)
        x = rng.standard_normal(s[1]).astype(np.float32)
        y = np.asarray(jax.jit(mv)(a, jnp.asarray(x)), np.float64)
        y64 = A64 @ x.astype(np.float64)
        absAx = abs(A64) @ np.abs(x.astype(np.float64))
        err = float(np.max(np.abs(y - y64) / np.maximum(absAx, 1e-30)))
        k = max(1, int(np.diff(A64.indptr).max()))
        check(err <= 2 * k * EPS32, "%s |y-y64|/(|A||x|)" % name, err,
              2 * k * EPS32, "f32 sum of %d products" % k)
        nbytes = sum(int(np.prod(t.shape)) * t.dtype.itemsize
                     for t in jax.tree_util.tree_leaves(a)) + 8 * s[0]

        def chain(a, x):
            return jax.lax.fori_loop(0, iters, lambda _, u: mv(a, u), x)
        cf = jax.jit(chain)
        walls = _walls(cf, lambda q: (a, jnp.asarray(x) * (1 + 0.01 * q)),
                       3)
        t = min(walls) / iters
        log("    %s: %.4f ms/matvec, %.1f GB/s of its own arrays "
            "(information)" % (name, t * 1e3, nbytes / t / 1e9))
    m = 4 * (sz.poisson_n ** 3)
    big = jnp.ones(m, jnp.float32)
    cp = jax.jit(lambda u: jax.lax.fori_loop(0, iters,
                                             lambda _, w: w * 0.999, u))
    walls = _walls(cp, lambda q: (big * (1 + 0.01 * q),), 3)
    log("    copy of %.2f GB: %.1f GB/s read+write (information)"
        % (m * 4 / 1e9, 2 * m * 4 * iters / min(walls) / 1e9))


def phase7_ff(sz):
    """Double-f32 arithmetic on the device: two_sum / two_prod must be
    error-free against f64 (an FMA contraction or reassociation by the
    compiler would break them)."""
    import jax
    import jax.numpy as jnp
    from pykrylov_tpu.utils.ff import two_sum, two_prod

    rng = np.random.default_rng(7)
    N = sz.ff_n
    # exponents spread over 2^+-30: every product and its rounding error
    # stay normal f32 numbers (no overflow, no subnormal flush)
    a = (rng.standard_normal(N) * 2.0 ** rng.integers(-30, 30, N)
         ).astype(np.float32)
    b = (rng.standard_normal(N) * 2.0 ** rng.integers(-30, 30, N)
         ).astype(np.float32)
    da, db = jnp.asarray(a), jnp.asarray(b)
    s, e = jax.jit(two_sum)(da, db)
    p, pe = jax.jit(two_prod)(da, db)
    s, e, p, pe = (np.asarray(t, np.float64) for t in (s, e, p, pe))
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    # an error-free pair sums to the exact real a+b (a*b), whose f64
    # rounding is then the same number (products exactly: 24+24 < 53)
    bad_s = int(np.sum((s + e) != (a64 + b64)))
    bad_p = int(np.sum((p + pe) != (a64 * b64)))
    check(bad_s == 0, "two_sum inexact of %d" % N, bad_s, 0,
          "error-free transform")
    check(bad_p == 0, "two_prod inexact of %d" % N, bad_p, 0,
          "error-free transform")


PHASES = (phase1_flagship, phase2_golden, phase3_poisson, phase4_general,
          phase5_lsq, phase6_kernels, phase7_ff)


def four_cards(sz):
    """The sharded paths on four devices, each compared with the same
    system solved on one device in the same process."""
    import jax
    import jax.numpy as jnp
    from pykrylov_tpu.gallery.general import tiled_general_coo
    from pykrylov_tpu.ops import DiagonalOperator
    from pykrylov_tpu.parallel import (GatherEllOperator, make_mesh,
                                       shard_vector, sharded_poisson3d)
    from pykrylov_tpu.solvers import bicgstab, cg, cg_pipelined, lsqr
    from pykrylov_tpu.sparse import formats as F

    check(len(jax.devices()) >= 4, "devices", len(jax.devices()), 4,
          "a four-card mesh")
    # Native f64 throughout: in f32 the pipelined recurrence stalls near
    # 1e-5 relative already at 48^3 (its residual gap), and BiCGSTAB
    # near 4e-4 on jpwh_991.
    dt = np.float64
    n = sz.four_poisson_n
    v, r, c, s = tiled_general_coo(tiles=sz.four_tiles, coupling=0,
                                   dtype=dt)
    coo = F.coo_from_arrays(v, r, c, s, device=False)
    A64 = _csr64(v, r, c, s)
    bj64 = A64 @ np.random.default_rng(4).standard_normal(s[0])
    normA = float(np.sqrt((A64.data ** 2).sum()))
    res = {}
    for nd in (4, 1):
        mesh = make_mesh(nd)
        t0 = time.perf_counter()
        op, b, e, pad = sharded_poisson3d(n, mesh, halo=True, dtype=dt)
        mtot = n ** 3 + pad
        M = DiagonalOperator(shard_vector(np.full(mtot, 1.0 / 6.0, dt),
                                          mesh))
        log("    [%d device(s)] poisson %d^3 = %d unknowns, build %.1f s"
            % (nd, n, n ** 3, time.perf_counter() - t0))
        for name, solver in (("cg", cg), ("cg_pipelined", cg_pipelined)):
            t0 = time.perf_counter()
            out = solver(op, b, M=M, rtol=1e-6, atol=0.0,
                         maxiter=8 * n * n)
            _block(out.x)
            t1 = time.perf_counter()
            out = solver(op, b * 1.0, M=M, rtol=1e-6, atol=0.0,
                         maxiter=8 * n * n)
            _block(out.x)
            t2 = time.perf_counter()
            res[(name, nd)] = (out, np.asarray(out.x, np.float64)[:n ** 3])
            log("    [%d] %s: %d iterations, first call %.2f s, warm "
                "%.3f s" % (nd, name, int(out.n_iter), t1 - t0, t2 - t1))
            check(len(out.x.sharding.device_set) == nd,
                  "%s devices holding x" % name,
                  len(out.x.sharding.device_set), nd, "sharded solve")
            check(bool(out.converged), "%s converged" % name,
                  bool(out.converged), True,
                  "rtol 1e-6")

        t0 = time.perf_counter()
        opg = GatherEllOperator(coo, mesh)
        bg = np.zeros(opg.nargout, dt)
        bg[:s[0]] = bj64
        bg = shard_vector(bg, mesh)
        log("    [%d] GatherEll tiled jpwh %d rows, build %.1f s; x entries "
            "exchanged per product %d (all-gather would be %d)"
            % (nd, s[0], time.perf_counter() - t0, opg.comm_entries_true,
               opg.allgather_entries_per_matvec))
        if nd > 1:
            check(opg.comm_entries_true > 0, "x entries exchanged",
                  opg.comm_entries_true, "> 0",
                  "tiles straddle the shards: the schedule must send")
        # both products against the f64 host: the forward schedule and
        # its reversal, entry by entry
        rng = np.random.default_rng(8)
        for what, o, ref, pad_in, pad_out in (
                ("A x", opg, A64, opg.nargin, opg.nargout),
                ("A'y", opg.T, A64.T.tocsr(), opg.nargout, opg.nargin)):
            u = rng.standard_normal(ref.shape[1])
            ud = np.zeros(pad_in, dt)
            ud[:u.size] = u
            got = np.asarray(o * shard_vector(ud, mesh))[:ref.shape[0]]
            k = int(np.diff(ref.indptr).max())
            err = float(np.max(np.abs(got - ref @ u)
                               / np.maximum(abs(ref) @ np.abs(u), 1e-300)))
            check(err <= 2 * k * np.finfo(dt).eps,
                  "%s |y-y64|/(|A||x|)" % what, err,
                  float(2 * k * np.finfo(dt).eps),
                  "f64 sum of %d products" % k)
        for name in ("bicgstab", "lsqr"):
            t0 = time.perf_counter()
            if name == "bicgstab":
                out = bicgstab(opg, bg, rtol=1e-8, atol=0.0,
                               matvec_max=4000)
            else:
                out = lsqr(opg, bg, atol=1e-8, btol=1e-8, itnlim=8000)
            _block(out.x)
            x64 = np.asarray(out.x, np.float64)[:s[1]]
            log("    [%d] %s: %d iterations, %.2f s with compile"
                % (nd, name, int(out.n_iter), time.perf_counter() - t0))
            check(len(out.x.sharding.device_set) == nd,
                  "%s devices holding x" % name,
                  len(out.x.sharding.device_set), nd, "sharded solve")
            rel = _rel_resid(A64, x64, bj64)
            if name == "bicgstab":
                tol, why = 1e-7, "rtol 1e-8 plus recurrence drift"
            else:   # LSQR stops at |r| <= btol |b| + atol |A|_F |x|
                tol = 2e-8 * (1.0 + normA * np.linalg.norm(x64)
                              / np.linalg.norm(bj64))
                why = "twice LSQR's own stopping bound"
            check(rel < tol, "%s true rel. residual (f64 host)" % name,
                  rel, tol, why)
            res[(name, nd)] = (out, x64)

    for name in ("cg", "cg_pipelined", "bicgstab", "lsqr"):
        (o4, x4), (o1, x1) = res[(name, 4)], res[(name, 1)]
        it4, it1 = int(o4.n_iter), int(o1.n_iter)
        slack = max(5, int(0.03 * it1))
        check(abs(it4 - it1) <= slack, "%s iterations 4 vs 1 card" % name,
              abs(it4 - it1), slack,
              "reduction order differs across the mesh: 3%, at least 5")
        d = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
        check(d < 1e-5, "%s |x4 - x1| / |x1|" % name, d, 1e-5,
              "f64 runs that differ only in reduction order")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU backend, tiny sizes (no GPU needed)")
    args = ap.parse_args(argv)

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four and "xla_force_host_platform_device_count" not in \
                os.environ.get("XLA_FLAGS", ""):
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                       " --xla_force_host_platform_"
                                       "device_count=4").strip()
    sys.path.insert(0, ROOT)
    import jax
    from pykrylov_tpu.utils.device import (card_info, enable_compile_cache,
                                           require_gpu)

    jax.config.update("jax_enable_x64", True)
    cache = enable_compile_cache(ROOT)
    if not args.rehearse:
        require_gpu()
    devs = jax.devices()
    log("devices: %s" % devs)
    log("platform %s, device_kind %s, count %d"
        % (devs[0].platform, devs[0].device_kind, len(devs)))
    for line in card_info():
        log(line)
    log("compile cache: %s" % cache)

    sz = Sizes(args.rehearse)
    phases = (four_cards,) if args.four else PHASES
    t_all = time.perf_counter()
    for i, phase in enumerate(phases, 1):
        log("[%s] %s" % (phase.__name__, phase.__doc__.split("\n")[0]))
        t0 = time.perf_counter()
        phase(sz)
        log("[%s] passed in %.1f s" % (phase.__name__,
                                       time.perf_counter() - t0))
    log("all phases passed in %.1f s" % (time.perf_counter() - t_all))
    out = {"ok": True, "device": {"platform": devs[0].platform,
                                  "kind": devs[0].device_kind,
                                  "count": len(devs)}}
    if args.rehearse:
        out["rehearsal"] = True
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
