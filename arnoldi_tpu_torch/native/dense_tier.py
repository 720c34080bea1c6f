"""ctypes binding for the native dense tier (``dense_tier.cpp``).

The port's copy of ``arnoldi_tpu/native/dense_tier.py``: the same binding
and arithmetic, but the library builds into ``<checkout>/build/
arnoldi_tpu_torch/`` (:data:`BUILD_DIR`), never next to a source file.

Lazily compiles the shared library on first use and exposes NumPy-friendly
wrappers with the same contracts the Python dispatch layer
(:mod:`arnoldi_tpu_torch.ops.dense_tier`) expects.  All native
computation is complex128; complex64 inputs are upcast and the results cast
back, preserving the reference's dtype contract
(``tests/test_utils.py`` of the reference asserts F-in F-out).
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

from . import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "dense_tier.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libdense_tier.so")

_lock = threading.Lock()
_lib = None
_build_failed = False

_c128 = np.ctypeslib.ndpointer(dtype=np.complex128, flags="C_CONTIGUOUS")
_f64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def _build():
    # Compile to a per-process temp name and rename atomically: a second
    # process compiling in place could truncate a .so this (or another)
    # process has already dlopen-mapped, or hand a half-written ELF to a
    # concurrent CDLL (which would permanently flip it to the scipy path).
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-march=native",
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            if (not os.path.exists(_LIB_PATH)
                    or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB_PATH)
            lib.schur_z.argtypes = [ctypes.c_int, _c128, _c128]
            lib.schur_z.restype = ctypes.c_int
            lib.trexc_z.argtypes = [ctypes.c_int, _c128, _c128,
                                    ctypes.c_int, ctypes.c_int]
            lib.trexc_z.restype = ctypes.c_int
            lib.ordered_schur_z.argtypes = [ctypes.c_int, _c128, _c128, _i32]
            lib.ordered_schur_z.restype = ctypes.c_int
            lib.trevc_z.argtypes = [ctypes.c_int, _c128, _c128]
            lib.trevc_z.restype = ctypes.c_int
            lib.eig_z.argtypes = [ctypes.c_int, _c128, _c128, _c128]
            lib.eig_z.restype = ctypes.c_int
            lib.schur_d.argtypes = [ctypes.c_int, _f64, _f64]
            lib.schur_d.restype = ctypes.c_int
            lib.reorder_blocks_d.argtypes = [ctypes.c_int, _f64, _f64,
                                             ctypes.c_int, _i32]
            lib.reorder_blocks_d.restype = ctypes.c_int
            _lib = lib
        except Exception:
            _build_failed = True
            _lib = None
        return _lib


def available():
    return _load() is not None


def _as_c128(A):
    return np.ascontiguousarray(np.asarray(A), dtype=np.complex128)


def schur_complex(A):
    """Complex Schur ``A = Z T Z^H``; preserves complex64/complex128 dtype."""
    lib = _load()
    in_dtype = np.result_type(np.asarray(A).dtype, np.complex64)
    T = _as_c128(A).copy()
    n = T.shape[0]
    Z = np.zeros((n, n), dtype=np.complex128)
    rc = lib.schur_z(n, T, Z)
    if rc != 0:
        raise RuntimeError(f"native schur_z failed to converge (rc={rc})")
    return T.astype(in_dtype), Z.astype(in_dtype)


def trexc(T, Z, ifst, ilst):
    lib = _load()
    in_dtype = np.result_type(np.asarray(T).dtype, np.complex64)
    T = _as_c128(T).copy()
    Z = _as_c128(Z).copy()
    rc = lib.trexc_z(T.shape[0], T, Z, int(ifst), int(ilst))
    if rc != 0:
        raise RuntimeError(f"native trexc_z failed (rc={rc})")
    return T.astype(in_dtype), Z.astype(in_dtype)


def ordered_schur(T, Z, order):
    """Greedy reorder of an existing Schur form — one native call for the
    reference's whole utils.py:45-63 loop."""
    lib = _load()
    in_dtype = np.result_type(np.asarray(T).dtype, np.complex64)
    T = _as_c128(T).copy()
    Z = _as_c128(Z).copy()
    order = np.ascontiguousarray(order, dtype=np.int32)
    # the native loop reads order[t] for every t < n — a top-k prefix (legal
    # for the Python fallback) would read past the buffer (UB)
    n_ = T.shape[0]
    if len(order) != n_ or order.size and (
            order.min() < 0 or order.max() >= n_):
        raise RuntimeError(
            f"ordered_schur_z needs a full permutation of 0..{n_ - 1}; "
            f"got {len(order)} indices (use the LAPACK fallback for "
            "partial orders)")
    rc = lib.ordered_schur_z(T.shape[0], T, Z, order)
    if rc != 0:
        raise RuntimeError(f"native ordered_schur_z failed (rc={rc})")
    return T.astype(in_dtype), Z.astype(in_dtype)


def triangular_eigvecs(T):
    lib = _load()
    in_dtype = np.result_type(np.asarray(T).dtype, np.complex64)
    Tc = _as_c128(T)
    n = Tc.shape[0]
    S = np.zeros((n, n), dtype=np.complex128)
    lib.trevc_z(n, Tc, S)
    return S.astype(in_dtype)


def eig(A):
    lib = _load()
    in_dtype = np.result_type(np.asarray(A).dtype, np.complex64)
    Ac = _as_c128(A).copy()
    n = Ac.shape[0]
    vals = np.zeros(n, dtype=np.complex128)
    vecs = np.zeros((n, n), dtype=np.complex128)
    rc = lib.eig_z(n, Ac, vals, vecs)
    if rc != 0:
        raise RuntimeError(f"native eig_z failed (rc={rc})")
    return vals.astype(in_dtype), vecs.astype(in_dtype)


def schur_real(A):
    """Real Schur ``A = Q T Q^T`` (T quasi-triangular with standardized
    2x2 blocks); float32 inputs upcast and cast back (integer inputs
    promote to float64 — casting BACK to int would return truncated
    garbage)."""
    lib = _load()
    in_dtype = np.result_type(np.asarray(A).dtype, np.float32)
    T = np.ascontiguousarray(np.asarray(A), dtype=np.float64).copy()
    n = T.shape[0]
    Q = np.zeros((n, n), dtype=np.float64)
    rc = lib.schur_d(n, T, Q)
    if rc != 0:
        raise RuntimeError(f"native schur_d failed to converge (rc={rc})")
    return T.astype(in_dtype), Q.astype(in_dtype)


def reorder_blocks_real(T, Q, block_order):
    """Greedy BLOCK reorder of a real quasi-triangular Schur form — the
    dtrexc/dlaexc analog, whole loop in one native call."""
    lib = _load()
    in_dtype = np.result_type(np.asarray(T).dtype, np.float32)
    T = np.ascontiguousarray(T, dtype=np.float64).copy()
    Q = np.ascontiguousarray(Q, dtype=np.float64).copy()
    order = np.ascontiguousarray(block_order, dtype=np.int32)
    rc = lib.reorder_blocks_d(T.shape[0], T, Q, len(order), order)
    if rc != 0:
        raise RuntimeError(f"native reorder_blocks_d failed (rc={rc})")
    return T.astype(in_dtype), Q.astype(in_dtype)
