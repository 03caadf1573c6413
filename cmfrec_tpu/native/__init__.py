"""ctypes loader for the native data layer (bucketize.cpp).

Compiles the C++ source on first use with the system toolchain and caches
the shared object under .native_cache/ at the checkout root, keyed by a
source hash, so the
package needs no build step (pybind11 is not assumed; the C ABI + ctypes
is the binding layer).  Falls back to pure NumPy if no compiler is
available — callers check ``get_lib() is not None``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "bucketize.cpp")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)
_F64 = ctypes.POINTER(ctypes.c_double)


def _cache_path() -> str:
    with open(_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    d = os.environ.get(
        "CMFREC_TPU_NATIVE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), ".native_cache"),
    )
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, f"libbucketize-{h}.so")


def _compile(out: str) -> bool:
    cmd = [
        "g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
        "-std=c++17", _SRC, "-o", out,
    ]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0:
            # retry without -march=native / -fopenmp (restricted toolchains)
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
                   "-o", out]
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        return r.returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False


_U16 = ctypes.POINTER(ctypes.c_uint16)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _declare(lib) -> None:
    lib.coo_csr_perm.argtypes = [_I64, ctypes.c_int64, ctypes.c_int64,
                                 _I64, _I64, _I64]
    lib.coo_csr_fill_wire.argtypes = [
        _I64, _I64, _F64, _F64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _I64, _I64, _I64, _U16, _U8, _U16, _U16]
    lib.coo_hist.argtypes = [_I64, _I64, ctypes.c_int64, ctypes.c_int64,
                             ctypes.c_int64, _I64, _I64, _I64]
    lib.coo_fill_wire_range.argtypes = [
        _I64, _I64, _F64, _F64, ctypes.c_int64, _I64,
        ctypes.c_int64, ctypes.c_int64, _U16, _U8, _U16, _U16]
    lib.coo_csr_fill_f32.argtypes = [
        _I64, _I64, _F64, _F64, ctypes.c_int64, ctypes.c_int64,
        _I64, _I64, _I32, _F32, _F32]
    for name, vt in (("gather_entries_f32", _F32),
                     ("gather_entries_f64", _F64)):
        fn = getattr(lib, name)
        fn.argtypes = [_I64, ctypes.c_int64, _I64, _F64, _F64, _I32, vt, vt]
    for name, vt in (("fill_bucket_f32", _F32), ("fill_bucket_f64", _F64)):
        fn = getattr(lib, name)
        fn.argtypes = [_I64, ctypes.c_int64, _I64, _I64, _I32, vt, vt,
                       ctypes.c_int64, _I32, vt, vt, _I32]
    lib.degree_sort.argtypes = [_I64, ctypes.c_int64, _I64]
    lib.omp_max_threads.restype = ctypes.c_int


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("CMFREC_TPU_NO_NATIVE", "0") == "1":
            return None
        try:
            path = _cache_path()
            if not os.path.exists(path) and not _compile(path):
                return None
            lib = ctypes.CDLL(path)
            _declare(lib)
            _LIB = lib
        except Exception as e:  # pragma: no cover - defensive
            print(f"cmfrec_tpu: native layer unavailable ({e})",
                  file=sys.stderr)
            _LIB = None
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def csr_from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 weights, n_rows: int, dtype):
    """Native COO->CSR: returns (counts, indptr, csr_cols i32, csr_vals,
    csr_wgt) with values downcast to `dtype`.  None if the lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    nnz = rows.shape[0]
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals64 = np.ascontiguousarray(vals, np.float64)
    wgt64 = (None if weights is None
             else np.ascontiguousarray(weights, np.float64))
    counts = np.empty(n_rows, np.int64)
    indptr = np.empty(n_rows + 1, np.int64)
    perm = np.empty(nnz, np.int64)
    lib.coo_csr_perm(_ptr(rows, _I64), nnz, n_rows, _ptr(counts, _I64),
                     _ptr(indptr, _I64), _ptr(perm, _I64))
    dt = np.dtype(dtype)
    csr_cols = np.empty(nnz, np.int32)
    csr_vals = np.empty(nnz, dt)
    csr_wgt = np.empty(nnz, dt) if weights is not None else None
    if dt == np.float32:
        fn, vt = lib.gather_entries_f32, _F32
    else:
        fn, vt = lib.gather_entries_f64, _F64
    fn(_ptr(perm, _I64), nnz, _ptr(cols, _I64), _ptr(vals64, _F64),
       _ptr(wgt64, _F64) if wgt64 is not None else None,
       _ptr(csr_cols, _I32), _ptr(csr_vals, vt),
       _ptr(csr_wgt, vt) if csr_wgt is not None else None)
    return counts, indptr, csr_cols, csr_vals, csr_wgt


def csr_wire_from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                      weights, n_rows: int, n_cols: int = 0):
    """Fused native COO->CSR producing WIRE-READY buffers in one pass:
    (counts, indptr, cols_lo u16, cols_hi u8, vals_bf16 u16,
    wgt_bf16 u16|None, col_counts|None) — the 3-byte id split of
    device_fill._ship_ids plus round-to-nearest-even bf16 values, with no
    extra host passes.  n_cols > 0 also histograms the column ids in the
    same pass (the opposing orientation's degree counts).  None if the
    lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    nnz = rows.shape[0]
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals64 = np.ascontiguousarray(vals, np.float64)
    wgt64 = (None if weights is None
             else np.ascontiguousarray(weights, np.float64))
    counts = np.empty(n_rows, np.int64)
    indptr = np.empty(n_rows + 1, np.int64)
    col_counts = np.empty(n_cols, np.int64) if n_cols > 0 else None
    lo = np.empty(nnz, np.uint16)
    hi = np.empty(nnz, np.uint8)
    vb = np.empty(nnz, np.uint16)
    wb = np.empty(nnz, np.uint16) if weights is not None else None
    lib.coo_csr_fill_wire(
        _ptr(rows, _I64), _ptr(cols, _I64), _ptr(vals64, _F64),
        _ptr(wgt64, _F64) if wgt64 is not None else None,
        nnz, n_rows, n_cols, _ptr(counts, _I64), _ptr(indptr, _I64),
        _ptr(col_counts, _I64) if col_counts is not None else None,
        _ptr(lo, _U16), _ptr(hi, _U8), _ptr(vb, _U16),
        _ptr(wb, _U16) if wb is not None else None)
    return counts, indptr, lo, hi, vb, wb, col_counts


def coo_hist(rows: np.ndarray, cols: np.ndarray, n_rows: int,
             n_cols: int = 0):
    """Histogram-only prefix of the wire build: (counts, indptr,
    col_counts|None).  None if the lib is missing."""
    lib = get_lib()
    if lib is None:
        return None
    nnz = rows.shape[0]
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    counts = np.empty(n_rows, np.int64)
    indptr = np.empty(n_rows + 1, np.int64)
    col_counts = np.empty(n_cols, np.int64) if n_cols > 0 else None
    lib.coo_hist(_ptr(rows, _I64), _ptr(cols, _I64), nnz, n_rows, n_cols,
                 _ptr(counts, _I64), _ptr(indptr, _I64),
                 _ptr(col_counts, _I64) if col_counts is not None else None)
    return counts, indptr, col_counts


def wire_fill_range(rows: np.ndarray, cols: np.ndarray, vals64: np.ndarray,
                    wgt64, indptr: np.ndarray, r0: int, r1: int,
                    lo: np.ndarray, hi: np.ndarray, vb: np.ndarray,
                    wb) -> None:
    """Fill the wire buffers (u16 id-low, u8 id-high, bf16-bits values
    [, bf16-bits weights]) for rows [r0, r1) at their global CSR
    positions.  Inputs must be contiguous; the caller slices each buffer
    at [indptr[r0]:indptr[r1]] for the upload."""
    lib = get_lib()
    assert lib is not None, "native layer required for wire_fill_range"
    lib.coo_fill_wire_range(
        _ptr(rows, _I64), _ptr(cols, _I64), _ptr(vals64, _F64),
        _ptr(wgt64, _F64) if wgt64 is not None else None,
        rows.shape[0], _ptr(indptr, _I64), r0, r1,
        _ptr(lo, _U16), _ptr(hi, _U8), _ptr(vb, _U16),
        _ptr(wb, _U16) if wb is not None else None)


def degree_order(counts: np.ndarray):
    """Stable degree-descending row order (native), or None."""
    lib = get_lib()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, np.int64)
    order = np.empty(counts.shape[0], np.int64)
    lib.degree_sort(_ptr(counts, _I64), counts.shape[0], _ptr(order, _I64))
    return order


def fill_bucket(row_order_slice, indptr, counts, csr_cols, csr_vals, csr_wgt,
                width: int, R: int, dtype):
    """Fill one zero-padded [R, width] bucket natively.  Returns
    (idx, val, wgt, length) or None."""
    lib = get_lib()
    if lib is None:
        return None
    dt = np.dtype(dtype)
    n_real = row_order_slice.shape[0]
    idx = np.zeros((R, width), np.int32)
    val = np.zeros((R, width), dt)
    wgt = np.zeros((R, width), dt) if csr_wgt is not None else None
    length = np.zeros(R, np.int32)
    row_order_slice = np.ascontiguousarray(row_order_slice, np.int64)
    if dt == np.float32:
        fn, vt = lib.fill_bucket_f32, _F32
    else:
        fn, vt = lib.fill_bucket_f64, _F64
    fn(_ptr(row_order_slice, _I64), n_real, _ptr(indptr, _I64),
       _ptr(counts, _I64), _ptr(csr_cols, _I32), _ptr(csr_vals, vt),
       _ptr(csr_wgt, vt) if csr_wgt is not None else None,
       width, _ptr(idx, _I32), _ptr(val, vt),
       _ptr(wgt, vt) if wgt is not None else None, _ptr(length, _I32))
    return idx, val, wgt, length
