"""Complex systems demo: Hermitian solve via the real-equivalent
formulation.

The reference handles complex operators natively in NumPy
(``/root/reference/pykrylov/tools/types.py``, conjugation-inferred
``.H`` twins).  This demo solves ``A z = b`` as the real system
``[[Re A, -Im A], [Im A, Re A]] [Re z; Im z] = [Re b; Im b]`` —
Hermitian positive definite A maps to a real SPD system whose spectrum
is the (real) complex spectrum with doubled multiplicity, so CG behaves
identically in real arithmetic.

Run from anywhere: ``python examples/demo_complex.py [n]``.
"""

import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))  # repo root

import numpy as np
import jax

from pykrylov_tpu.ops import real_equivalent_operator, complex_solve
from pykrylov_tpu.solvers import cg, lsqr


def main(n=None):
    n = n or 256
    rng = np.random.default_rng(0)

    # Hermitian positive definite system
    Q = np.linalg.qr(rng.standard_normal((n, n))
                     + 1j * rng.standard_normal((n, n)))[0]
    lam = np.logspace(0, 3, n)
    a = (Q * lam) @ Q.conj().T
    a = (a + a.conj().T) / 2
    zstar = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = a @ zstar

    dt, ct = np.float32, np.complex64
    op = real_equivalent_operator(a.astype(ct), hermitian=True, dtype=dt)
    print("Hermitian PD n=%d (kappa 1e3) on %s -> real SPD %s"
          % (n, jax.devices()[0], op.shape))
    res = complex_solve(cg, op, b.astype(ct), rtol=1e-5)
    err = np.linalg.norm(res.x - zstar) / np.linalg.norm(zstar)
    print("CG: %d iterations, converged=%s, ||z - z*||/||z*|| = %.2e"
          % (int(res.n_iter), bool(res.converged), err))

    # complex least squares: min ||C z - d|| maps exactly
    m2, n2 = 2 * n, n // 2
    C = (rng.standard_normal((m2, n2))
         + 1j * rng.standard_normal((m2, n2))).astype(ct)
    d = (rng.standard_normal(m2) + 1j * rng.standard_normal(m2)).astype(ct)
    zref = np.linalg.lstsq(C, d, rcond=None)[0]
    lres = complex_solve(lsqr, real_equivalent_operator(C, dtype=dt),
                         d, atol=1e-6, btol=1e-6)
    lerr = np.linalg.norm(lres.x - zref) / np.linalg.norm(zref)
    print("LSQR least squares (%dx%d): %d iterations, error vs lstsq"
          " %.2e" % (m2, n2, int(lres.n_iter), lerr))


if __name__ == "__main__":
    main(int(_sys.argv[1]) if len(_sys.argv) > 1 else None)
