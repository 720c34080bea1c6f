"""ctypes binding for the host-tier restart engine (``host_engine.cpp``).

The port's copy of ``arnoldi_tpu/native/host_engine.py``: the same binding
and arithmetic, but the library builds into ``<checkout>/build/
arnoldi_tpu_torch/`` (:data:`BUILD_DIR`), never next to a source file.

Real-float64 CSR operators only — the regime of the reference's benchmarks
(mark/SuiteSparse matrices on CPU).  Complex, dense, callable, and device
operators keep the NumPy host path (``host_arnoldi_expand``), which also
remains the correctness oracle for this engine
(``tests/test_host_engine.py`` for the original).

BLAS is reached through the very pointers scipy carries in its
``cython_blas`` capsules, so the engine links against nothing and always
uses the same BLAS as the NumPy path.
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

from . import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_engine.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libhost_engine.so")

_lock = threading.Lock()
_lib = None
_build_failed = False

_f64 = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")


def _capsule_ptr(capsule):
    """Raw function pointer out of a PyCapsule (scipy cython_blas entry)."""
    api = ctypes.pythonapi
    api.PyCapsule_GetName.restype = ctypes.c_char_p
    api.PyCapsule_GetName.argtypes = [ctypes.py_object]
    api.PyCapsule_GetPointer.restype = ctypes.c_void_p
    api.PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]
    return api.PyCapsule_GetPointer(capsule, api.PyCapsule_GetName(capsule))


def _build():
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-march=native",
           _SRC, "-o", tmp]
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
            lib.ks_init_blas.argtypes = [ctypes.c_void_p] * 4
            lib.ks_blas_ready.restype = ctypes.c_int
            lib.ks_expand_d.restype = ctypes.c_int
            lib.ks_expand_d.argtypes = [
                ctypes.c_int, _i32, _i32, _f64, _f64, ctypes.c_int, _f64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                ctypes.c_int, _f64,
            ]
            lib.ks_cycle_d.restype = ctypes.c_int
            lib.ks_cycle_d.argtypes = [
                ctypes.c_int, _i32, _i32, _f64, _f64, _f64, ctypes.c_int,
                _f64, ctypes.c_int, _f64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
                _f64,
            ]
            from scipy.linalg import cython_blas

            capi = cython_blas.__pyx_capi__
            lib.ks_init_blas(
                _capsule_ptr(capi["dgemv"]), _capsule_ptr(capi["dgemm"]),
                _capsule_ptr(capi["dnrm2"]), _capsule_ptr(capi["ddot"]))
            if not lib.ks_blas_ready():
                raise RuntimeError("BLAS pointers not installed")
            _lib = lib
        except Exception as e:
            # The NumPy fallback is ~25%/iteration slower; a broken
            # toolchain must not degrade silently.  Warn ONCE (the
            # _build_failed latch guarantees it) with the compiler output
            # when there is any, then keep the silent-fallback behavior.
            import warnings

            detail = ""
            stderr = getattr(e, "stderr", None)
            if stderr:
                detail = ": " + stderr.decode(errors="replace").strip()
            warnings.warn(
                "native host engine unavailable, falling back to the "
                f"slower NumPy restart path ({type(e).__name__}: {e}"
                f"{detail})", RuntimeWarning, stacklevel=3)
            _build_failed = True
            _lib = None
        return _lib


def available():
    return _load() is not None


#: ortho kernel name -> engine enum
_ORTHO_CODE = {"cgs_dgks": 0, "cgs2": 1, "mgs_dgks": 2}


class CsrEngine:
    """Per-operator engine state: the CSR buffers in engine layout plus the
    per-solve dgemv scratch."""

    def __init__(self, A_csr, max_dim):
        self.n = A_csr.shape[0]
        self.indptr = np.ascontiguousarray(A_csr.indptr, dtype=np.int32)
        self.indices = np.ascontiguousarray(A_csr.indices, dtype=np.int32)
        self.data = np.ascontiguousarray(A_csr.data, dtype=np.float64)
        self.scratch = np.empty(2 * max_dim + 2, dtype=np.float64)
        self._lib = _load()

    def expand(self, Vt, H, tol, *, start_dim, max_dim, ortho="cgs_dgks"):
        """In-place expansion; same contract as ``host_arnoldi_expand``."""
        assert Vt.dtype == np.float64 and Vt.flags.c_contiguous
        n_iter = self._lib.ks_expand_d(
            self.n, self.indptr, self.indices, self.data, Vt, Vt.shape[1],
            H, H.shape[1], int(start_dim), int(max_dim), float(tol),
            _ORTHO_CODE[ortho], self.scratch)
        return Vt, H, n_iter

    def cycle(self, Vt, out, H, Qp, *, m, pa, carry, max_dim, tol,
              ortho="cgs_dgks"):
        """Fused truncate+expand: truncates ``Vt`` into ``out`` and expands
        there (H must already hold the truncated projected matrix).
        Returns ``(out, H, n_iter)`` — the caller swaps buffers."""
        assert out.shape == Vt.shape and out.dtype == Vt.dtype
        Qp = np.ascontiguousarray(Qp, dtype=np.float64)
        assert Qp.shape == (m, pa)
        n_iter = self._lib.ks_cycle_d(
            self.n, self.indptr, self.indices, self.data, Vt, out,
            Vt.shape[1], H, H.shape[1], Qp, int(m), int(pa), int(carry),
            int(max_dim), float(tol), _ORTHO_CODE[ortho], self.scratch)
        return out, H, n_iter


def engine_for(A, wdtype, max_dim, ortho):
    """A :class:`CsrEngine` when the engine applies (real float64 CSR-able
    sparse operator, supported ortho kernel, library built), else None."""
    if np.dtype(wdtype) != np.float64 or ortho not in _ORTHO_CODE:
        return None
    import scipy.sparse as sp

    if not sp.issparse(A):
        return None
    if not available():
        return None
    A_csr = A.astype(np.float64).tocsr()
    # The C kernel indexes with int32; a matrix whose nnz (or n) exceeds
    # the int32 range would wrap silently under a forced cast and read out
    # of bounds.  Fall back to the NumPy path instead.
    if A_csr.nnz > np.iinfo(np.int32).max or A_csr.shape[0] > np.iinfo(np.int32).max:
        return None
    return CsrEngine(A_csr, max_dim)
