"""ctypes bindings to the native host-side data pipeline (native.cpp).

The reference's host-side sparse machinery lived in pysparse's C
extensions; this module is the build's equivalent: a small C++ library for
MatrixMarket parsing and COO -> ELL / DIA packing, loaded via ctypes (the
image has no pybind11).  The shared object is compiled lazily with g++ on
first import and cached next to the source; every entry point has a pure
NumPy fallback in the callers, so an environment without a compiler still
works (just slower on large matrices).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "mm_parse_native", "ell_fill_native",
           "dia_fill_native", "row_counts_native"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native.cpp")
_SO = os.path.join(_HERE, "_native.so")
_lock = threading.Lock()
_lib = None
_FIELDS = {0: "real", 1: "integer", 2: "pattern", 3: "complex"}
_SYMMETRIES = {0: "general", 1: "symmetric", 2: "skew-symmetric",
               3: "hermitian"}


def _build():
    # compile to a temp path and os.replace() it: a concurrent process
    # (pytest + bench, xdist workers) must never dlopen a half-written
    # library — g++ truncates the output before writing
    tmp = "%s.%d.tmp" % (_SO, os.getpid())
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    if _lib is not None:
        if _lib is False:
            raise RuntimeError("native build previously failed")
        return _lib
    with _lock:
        if _lib is not None:
            if _lib is False:
                raise RuntimeError("native build previously failed")
            return _lib
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                _build()
        except Exception:
            # negative-cache the failure: without this every
            # available() / native-entry call re-spawns a full g++
            # compile attempt (seconds each, several per operator)
            _lib = False
            raise
        lib = ctypes.CDLL(_SO)
        c = ctypes
        lib.mm_parse.restype = c.c_void_p
        lib.mm_parse.argtypes = [
            c.c_char_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64),
            c.POINTER(c.c_int64), c.POINTER(c.c_int), c.POINTER(c.c_int),
            c.c_char_p, c.c_int]
        lib.mm_copy.restype = None
        lib.mm_copy.argtypes = [c.c_void_p, c.c_void_p, c.c_void_p,
                                c.c_void_p]
        lib.mm_free.restype = None
        lib.mm_free.argtypes = [c.c_void_p]
        lib.ell_fill.restype = c.c_int
        lib.ell_fill.argtypes = [c.c_int64] + [c.c_void_p] * 3 + \
            [c.c_int64, c.c_int64] + [c.c_void_p] * 2
        lib.dia_fill.restype = c.c_int
        lib.dia_fill.argtypes = [c.c_int64] + [c.c_void_p] * 3 + \
            [c.c_int64, c.c_int64] + [c.c_void_p] * 2
        lib.row_counts.restype = None
        lib.row_counts.argtypes = [c.c_int64, c.c_void_p, c.c_int64,
                                   c.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _exceeds_i32(*index_arrays, m=0):
    """True when any index would overflow the int32 C interface — the
    downcast in np.ascontiguousarray is an unchecked same-kind cast
    that silently wraps, corrupting the filled containers."""
    if m >= 2**31:
        return True
    for a in index_arrays:
        a = np.asarray(a)
        if a.size and int(a.max()) >= 2**31:
            return True
    return False


def mm_parse_native(path):
    """Parse a plain (non-gzip) MatrixMarket coordinate file.

    Returns ``(vals, rows, cols, shape, field, symmetry)`` with 0-based
    indices and UNexpanded symmetric storage, matching what the NumPy
    parser produces before ``_finish`` post-processing.  Returns ``None``
    for files the native parser does not handle (gzip, array format).
    """
    path = os.fspath(path)
    if path.endswith(".gz"):
        return None
    lib = _load()
    nnz = ctypes.c_int64()
    m = ctypes.c_int64()
    n = ctypes.c_int64()
    field = ctypes.c_int()
    symmetry = ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    h = lib.mm_parse(path.encode(), ctypes.byref(nnz), ctypes.byref(m),
                     ctypes.byref(n), ctypes.byref(field),
                     ctypes.byref(symmetry), err, len(err))
    if not h:
        msg = err.value.decode()
        if "not a MatrixMarket" in msg or "supported natively" in msg:
            return None  # let the NumPy parser handle/diagnose it
        raise IOError("MatrixMarket parse failed: %s" % msg)
    try:
        k = int(nnz.value)
        fld = _FIELDS[field.value]
        nv = 2 * k if fld == "complex" else k
        raw = np.empty(nv, dtype=np.float64)
        rows = np.empty(k, dtype=np.int32)
        cols = np.empty(k, dtype=np.int32)
        lib.mm_copy(h, _ptr(raw), _ptr(rows), _ptr(cols))
    finally:
        lib.mm_free(h)
    vals = raw.view(np.complex128) if fld == "complex" else raw
    return (vals, rows, cols, (int(m.value), int(n.value)), fld,
            _SYMMETRIES[symmetry.value])


def ell_fill_native(rows, cols, vals, m, K):
    """Fill (m, K) padded-row ELL arrays from row-sorted real COO triples.

    Returns ``(ell_data, ell_cols)`` or ``None`` when unavailable or the
    dtype is not float64.
    """
    if np.asarray(vals).dtype != np.float64 or not available():
        return None
    if _exceeds_i32(rows, cols, m):
        return None  # int32 C interface; NumPy path handles huge indices
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    ell_data = np.zeros((m, K), dtype=np.float64)
    ell_cols = np.zeros((m, K), dtype=np.int32)
    rc = lib.ell_fill(len(vals), _ptr(rows), _ptr(cols), _ptr(vals),
                      m, K, _ptr(ell_data), _ptr(ell_cols))
    if rc != 0:
        raise ValueError("row exceeded %d ELL slots" % K)
    return ell_data, ell_cols


def dia_fill_native(rows, cols, vals, m, offsets):
    """Fill (ndiag, m) DIA data from real COO triples; ``offsets`` sorted.

    Returns the array or ``None`` when unavailable / non-float64.
    """
    if np.asarray(vals).dtype != np.float64 or not available():
        return None
    if _exceeds_i32(rows, cols, m):
        return None
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    data = np.zeros((len(offs), m), dtype=np.float64)
    rc = lib.dia_fill(len(vals), _ptr(rows), _ptr(cols), _ptr(vals),
                      m, len(offs), _ptr(offs), _ptr(data))
    if rc != 0:
        raise ValueError("nnz on a diagonal missing from offsets")
    return data


def row_counts_native(rows, m):
    if not available() or _exceeds_i32(rows, m=m):
        return None
    lib = _load()
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    counts = np.empty(m, dtype=np.int64)
    lib.row_counts(len(rows), _ptr(rows), m, _ptr(counts))
    return counts

