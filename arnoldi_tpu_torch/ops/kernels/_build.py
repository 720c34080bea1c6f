"""Build and load the port's CUDA kernels.

Each of ``arnoldi_tpu_torch/csrc/*.cu`` compiles with its own ``nvcc`` for
``sm_90a`` (all started together), and the objects link into one shared
library with a plain C interface,
``<checkout>/build/arnoldi_tpu_torch/libkernels.so``, which is loaded with
``ctypes``.  The build happens on the first kernel launch (never at import),
and again whenever a source is newer than the library.  No PyTorch header is
compiled, so the build takes seconds.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
Entry points are named ``<kernel>_<suffix>`` by operand dtype: ``f32``,
``f64``, ``c64`` and ``c128``.
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

_lock = threading.Lock()
_lib = None

_p = ctypes.c_void_p
_i64 = ctypes.c_longlong
_i32 = ctypes.c_int
_SIGNATURES = {
    # bands, x, y, n, k, offsets (host int64[k]), nb, stream
    "arn_spmv_dia": [_p, _p, _p, _i64, _i32, _p, _i32, _p],
    # bands, x, y, rows, k, offsets, nb, bands row stride, row0, x_base,
    # x_len, stream
    "arn_spmv_dia_ext": [_p, _p, _p, _i64, _i32, _p, _i32, _i64, _i64, _i64,
                         _i64, _p],
    # data, cols, x, y, n_rows, n_cols, L, nb, stream
    "arn_spmv_ell": [_p, _p, _p, _p, _i64, _i64, _i32, _i32, _p],
    # blocks, cols, x, y, n_brow, L, r, c, n_rows, n_cols, nb, stream
    "arn_spmv_bsr": [_p, _p, _p, _p, _i64, _i32, _i32, _i32, _i64, _i64, _i32,
                     _p],
    # blocks, window cols, tile_base, x, y, n_brow, L, r, c, n_rows, n_cols,
    # nb, tile_brows, Wt, columns per pass, stream
    "arn_spmv_bsr_window": [_p, _p, _p, _p, _p, _i64, _i32, _i32, _i32, _i64,
                            _i64, _i32, _i32, _i32, _i32, _p],
    # Vt, w, c, partials, ticket, n, mp1, n_active, chunk, n_chunks, stream
    "arn_masked_project": [_p, _p, _p, _p, _p, _i64, _i32, _i32, _i32, _i32, _p],
    # Vt, w, c, w_out, partials, norm_sq, n, n_active, n_blocks, stream
    "arn_project_update_norm": [_p, _p, _p, _p, _p, _p, _i64, _i32, _i32, _p],
}


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
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _build_locked()
            lib = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                for suffix in SUFFIXES.values():
                    fn = getattr(lib, f"{name}_{suffix}")
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            lib.arn_error_string.argtypes = [ctypes.c_int]
            lib.arn_error_string.restype = ctypes.c_char_p
            lib.arn_update_cols_per_block.argtypes = []
            lib.arn_update_cols_per_block.restype = ctypes.c_int
            _lib = lib
        return _lib


def is_loaded():
    """True once a kernel launch has loaded the library in this process."""
    return _lib is not None


def check(rc, kernel):
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = library().arn_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA error {rc} ({msg})")


def kernel_fn(name, dtype):
    """The C entry point ``name`` for an operand dtype of :data:`SUFFIXES`."""
    return getattr(library(), f"{name}_{SUFFIXES[dtype]}")


def count_launch(wrapper, dtype):
    """Count one launch of ``wrapper``'s kernel: ``wrapper.launches`` (all
    dtypes) and ``wrapper.dtype_launches[name]`` (``"complex128"``, ...)."""
    wrapper.launches += 1
    key = str(dtype).removeprefix("torch.")
    wrapper.dtype_launches[key] = wrapper.dtype_launches.get(key, 0) + 1


def launch_context(device):
    """``(device guard, raw stream handle)`` for a launch on ``device``."""
    return torch.cuda.device(device), torch.cuda.current_stream(device).cuda_stream


def on_cuda(kernel, *tensors, dtypes=tuple(SUFFIXES)):
    """The checks every wrapper makes before it dispatches.

    All operands must be of one dtype among ``dtypes`` (float32, float64,
    complex64 or complex128 by default; ``int32`` index arrays are checked
    by the caller), on one device, and contiguous.  Returns True for CUDA
    tensors (launch the kernel) and False for CPU tensors (run the plain
    PyTorch version); any other device raises.
    """
    dtype, device = tensors[0].dtype, tensors[0].device
    if dtype not in dtypes:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{kernel}: {names} operands, got {dtype}")
    for t in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{kernel}: mixed dtypes {dtype} and {t.dtype}")
        if t.device != device:
            raise ValueError(f"{kernel}: operands on {device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: CPU or CUDA tensors, got {device}")
    return device.type == "cuda"
