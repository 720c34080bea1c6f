"""Build and load the port's CUDA kernels.

Each of ``arnoldi_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc`` for
``sm_90a`` (all started together), and the objects link into one shared
library with a plain C interface,
``<checkout>/build/arnoldi_tpu_torch/libkernels.so``, which is loaded with
``ctypes``.  The build happens on the first kernel launch (never at import),
and again whenever a source is newer than the library.  No PyTorch header is
compiled, so the build takes seconds.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``.  Entry points are named ``<kernel>_<suffix>`` by
operand dtype: ``f32``, ``f64``, ``c64`` and ``c128``.

Every wrapper launches through this module alone: :func:`operand_device`
checks its operands, :func:`resolve` finds an entry point (resolved once
per process, when the library loads), and :func:`launch` calls it on the
current stream, raises on a nonzero code and counts the launch
(:data:`launches`).  The two cooperative kernels take their grid barrier's
counters from :func:`ticket`.
"""

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import torch

from ...native import BUILD_DIR

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
LIB_PATH = BUILD_DIR / "libkernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Operand dtypes of the kernels and the suffix of their entry points.
SUFFIXES = {torch.float32: "f32", torch.float64: "f64",
            torch.complex64: "c64", torch.complex128: "c128"}
#: Their names, the keys of ``kernels.dtype_launch_counts()``' entries.
DTYPE_NAMES = {dtype: str(dtype).removeprefix("torch.") for dtype in SUFFIXES}

_lock = threading.Lock()
_lib = None
#: ``(entry point name, dtype)`` -> C entry point, and a scalar query's name
#: -> its value; filled when the library loads.
_entries = {}
#: ``(device index, raw stream, counter dtype)`` -> a grid barrier's counters.
_tickets = {}
#: ``(kernel name, operand dtype)`` -> launches since the last reset, the
#: kernel named as in ``kernels.KERNELS``.
launches = {}

_p = ctypes.c_void_p
_i64 = ctypes.c_longlong
_i32 = ctypes.c_int
_f64 = ctypes.c_double
_SIGNATURES = {
    # bands, x, y, rows, k, offsets (host int64[k]), nb, bands row stride,
    # row0, x_base, x_len, stream
    "arn_spmv_dia": [_p, _p, _p, _i64, _i32, _p, _i32, _i64, _i64, _i64, _i64,
                     _p],
    # data, cols, x, y, n_rows, n_cols, L, nb, stream
    "arn_spmv_ell": [_p, _p, _p, _p, _i64, _i64, _i32, _i32, _p],
    # blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb, stream
    "arn_spmv_bsr": [_p, _p, _p, _p, _i64, _i32, _i32, _i32, _i64, _i64, _i32,
                     _p],
    # blocks, window cols, tile_base, x, y, n_brow, L, r, c, n_rows, n_cols,
    # nb, tile_brows, Wt, columns per pass (block shapes other than 8 x 8),
    # stream
    "arn_spmv_bsr_window": [_p, _p, _p, _p, _p, _i64, _i32, _i32, _i32, _i64,
                            _i64, _i32, _i32, _i32, _i32, _p],
    # Vt, w, c, partials, ticket, n, mp1, n_active, chunk, n_chunks, stream
    "arn_masked_project": [_p, _p, _p, _p, _p, _i64, _i32, _i32, _i32, _i32, _p],
    # Vt, w, c, w_out, partials, norm_sq, n, n_active, n_blocks, stream
    "arn_project_update_norm": [_p, _p, _p, _p, _p, _p, _i64, _i32, _i32, _p],
    # bands, x (T_j), prev (T_{j-1}), out (T_{j+1}), y, n, k, offsets (host
    # int64[k]), nb, c, scale, c0, coef, first, stream
    "arn_cheby_dia": [_p, _p, _p, _p, _p, _i64, _i32, _p, _i32, _f64, _f64, _f64,
                      _f64, _i32, _p],
    # bands, k, offsets (host int64[k]), n, sigma, b, x, r, p0, p1, Ap,
    # partials, partials' capacity, ticket, iterations, tol^2, atol^2,
    # maxiter, stream
    "arn_cg_dia": [_p, _i32, _p, _i64, _f64, _p, _p, _p, _p, _p, _p, _p, _i32, _p,
                   _p, _f64, _f64, _i64, _p],
}
#: The entry points with real forms alone (every other has all of SUFFIXES).
_REAL_ONLY = ("arn_cheby_dia", "arn_cg_dia")
#: C functions of no arguments that return an int the wrappers size with:
#: the fused CG's partials' capacity, the update pass's columns a block.
_QUERIES = ("arn_cg_dia_partials", "arn_update_cols_per_block")


def _sources():
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME  # toolkit lookup only

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc); cannot build the "
                           "arnoldi_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _stale():
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in _sources())


def build():
    """Compile the library if it is missing or older than a source.

    Returns the compiler's output (``-Xptxas -v`` register and shared-memory
    report), or ``""`` when the library was already up to date.
    """
    with _lock:
        return _build_locked()


def _build_locked():
    if not _stale():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Compile to per-process names and rename: a concurrent build must never
    # hand a half-written library to a loader.
    tag = f"{os.getpid()}.tmp"
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}")
    srcs = sorted(_CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    nvcc = _nvcc()
    procs = []
    try:
        for src, obj in zip(srcs, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(srcs, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name} ({proc.returncode}):\n{log}")
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        os.replace(tmp, LIB_PATH)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (tmp, *objs):
            if path.exists():
                path.unlink()
    return "".join(logs)


def library():
    """The loaded kernel library, building it first if needed.  Loading it
    types every entry point and reads every scalar query once
    (:func:`resolve` hands them out)."""
    global _lib
    with _lock:
        if _lib is None:
            _build_locked()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                for dtype, suffix in SUFFIXES.items():
                    if name in _REAL_ONLY and dtype.is_complex:
                        continue
                    fn = getattr(lib, f"{name}_{suffix}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    _entries[name, dtype] = fn
            for name in _QUERIES:
                query = getattr(lib, name)
                query.argtypes = []
                query.restype = ctypes.c_int
                _entries[name] = query()
            lib.arn_error_string.argtypes = [ctypes.c_int]
            lib.arn_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def is_loaded():
    """True once a kernel launch has loaded the library in this process."""
    return _lib is not None


def resolve(name, dtype=None):
    """The C entry point ``name`` for operand ``dtype`` (one of
    :data:`SUFFIXES`), or with no dtype the value of the scalar query
    ``name``; loads the library (building it first if needed) on the first
    call of the process."""
    key = name if dtype is None else (name, dtype)
    found = _entries.get(key)
    if found is None:
        library()
        found = _entries[key]
    return found


def launch(kernel, entry, dtype, device, *args):
    """The one launch path: call the C entry point ``entry`` for operand
    ``dtype`` with ``args`` and the raw handle of the current stream of
    CUDA device ``device`` (an index), read without building a
    ``torch.cuda.Stream``.  A device guard is entered only when ``device``
    is not the current device.  Raises on a nonzero return code, else
    counts one launch of ``kernel`` (its name in ``kernels.KERNELS``)."""
    fn = resolve(entry, dtype)
    stream = torch._C._cuda_getCurrentRawStream(device)
    if device == torch._C._cuda_getDevice():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc:
        msg = library().arn_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")
    key = (kernel, dtype)
    launches[key] = launches.get(key, 0) + 1


def ticket(device, dtype):
    """The address of a cooperative kernel's grid barrier: two counters of
    ``dtype`` on CUDA device ``device`` (an index), one zeroed pair per
    device, current stream and dtype (int32 for ``arn_masked_project``,
    int64 for ``arn_cg_dia``, so the two kernels never share one).  They
    are zero between launches (the last block resets them) and shared only
    by launches on one stream, which run in order."""
    key = (device, torch._C._cuda_getCurrentRawStream(device), dtype)
    counters = _tickets.get(key)
    if counters is None:
        counters = _tickets[key] = torch.zeros(2, dtype=dtype, device=device)
    return counters.data_ptr()


def on_device(t, device):
    """True when ``t`` lies on the operands' device (an index of
    :func:`operand_device`; -1: the CPU)."""
    return (t.is_cuda and t.get_device() == device) if device >= 0 else t.is_cpu


def operand_device(kernel, a, b):
    """The checks every wrapper makes of two operands before it dispatches,
    by plain attribute compares: one dtype among :data:`SUFFIXES`, one
    device, contiguous.  Returns the CUDA device index (launch the kernel),
    or -1 for CPU tensors (run the plain version); any other device
    raises."""
    dtype = a.dtype
    if dtype not in DTYPE_NAMES:
        names = " or ".join(DTYPE_NAMES.values())
        raise TypeError(f"{kernel}: {names} operands, got {dtype}")
    if b.dtype != dtype:
        raise TypeError(f"{kernel}: mixed dtypes {dtype} and {b.dtype}")
    if a.is_cuda and b.is_cuda:
        index = a.get_device()
        if b.get_device() != index:
            raise ValueError(f"{kernel}: operands on {a.device} and {b.device}")
    elif a.is_cpu and b.is_cpu:
        index = -1
    elif a.device != b.device:
        raise ValueError(f"{kernel}: operands on {a.device} and {b.device}")
    else:
        raise ValueError(f"{kernel}: CPU or CUDA tensors, got {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{kernel}: operands must be contiguous")
    return index
