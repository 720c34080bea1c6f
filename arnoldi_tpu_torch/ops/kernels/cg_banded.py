"""Conjugate gradients on a shifted DIA operator, one launch a solve.

:func:`cg_banded` solves ``(A - sigma I) x = b`` from ``x0 = 0`` with no
preconditioner, ``A`` given by its DIA ``bands`` and ``offsets`` (as
:mod:`.spmv_banded` takes them) and ``sigma`` real, under the stopping rule
of :func:`arnoldi_tpu_torch.solvers.inner.cg`: ``r.r <= max(tol^2 ||b||^2,
atol^2)`` or ``maxiter`` iterations.  It returns ``(x, SolveInfo)`` as
``inner.cg`` does.

On CUDA tensors (float32 or float64) it launches ``csrc/cg_banded.cu``
once: the whole CG loop runs on the card, every reduction a fixed-order
sum, and the host reads the iteration count once, where the eager loop
launches about 12 kernels and reads ``r.r`` once an iteration.  The
solve's vectors (x, r, two directions, Ap) and the partial sums are
allocated for the call and freed with it.  On CPU tensors it runs
:func:`cg_banded_plain`: ``inner.cg`` over the plain shifted DIA product,
the bits of the eager loop.

The shift-invert operators route a solve here for a single-device
``BandedOperator`` of real dtype, a real shift, ``cg`` and no
preconditioner (``solvers/spectral_transform.py``).
"""

import ctypes

import torch

from . import _build
from .spmv_banded import MAX_OFFSETS, banded_matvec_plain, launch_plan

#: The operand dtypes the kernel takes.
DTYPES = (torch.float32, torch.float64)

_p = ctypes.c_void_p
_i64 = ctypes.c_longlong
_i32 = ctypes.c_int
_f64 = ctypes.c_double
# bands, k, offsets (host int64[k]), n, sigma, b, x, r, p0, p1, Ap, partials,
# partials' capacity, ticket, iterations, tol^2, atol^2, maxiter, stream
_ARGTYPES = [_p, _i32, _p, _i64, _f64, _p, _p, _p, _p, _p, _p, _p, _i32, _p, _p,
             _f64, _f64, _i64, _p]

_entries = None    # ({dtype: C entry point}, partials' capacity), on first launch
_TICKETS = {}


def _resolve():
    global _entries
    if _entries is None:
        lib = _build.library()
        fns = {}
        for dtype in DTYPES:
            fn = getattr(lib, f"arn_cg_dia_{_build.SUFFIXES[dtype]}")
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            fns[dtype] = fn
        lib.arn_cg_dia_partials.argtypes = []
        lib.arn_cg_dia_partials.restype = ctypes.c_int
        _entries = fns, lib.arn_cg_dia_partials()
    return _entries


def _ticket(device, stream):
    """The kernel's two barrier counters (int64), one pair per device and
    stream: zero between launches (the last block resets them), and shared
    only by launches on one stream, which run in order."""
    key = (device, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(2, dtype=torch.int64, device=device)
    return _TICKETS[key]


def cg_banded_plain(bands, offsets, sigma, b, *, tol=1e-5, atol=0.0,
                    maxiter=None):
    """``inner.cg`` from ``x0 = 0`` over the eager loop's product in plain
    PyTorch: the DIA product, then ``torch.add(y, v, alpha=-sigma)``."""
    from ...solvers.inner import cg

    offsets = tuple(int(o) for o in offsets)

    def shifted(v):
        return torch.add(banded_matvec_plain(bands, v, offsets), v, alpha=-sigma)

    return cg(shifted, b, tol=tol, atol=atol, maxiter=maxiter)


def cg_banded(bands, offsets, sigma, b, *, tol=1e-5, atol=0.0, maxiter=None):
    """CG on ``(A - sigma I) x = b``: the kernel for CUDA tensors, the plain
    version for CPU tensors.  ``bands``: (k, n); ``b``: (n,); ``offsets``: k
    ints; ``sigma`` a real number; ``maxiter`` defaults to ``10 n``.
    Returns ``(x, SolveInfo(iterations, iterations + 1))``."""
    from ...solvers.inner import SolveInfo

    device = _build.operand_device("cg_banded", bands, b)
    offsets, k, array = launch_plan(tuple(offsets))
    n = bands.shape[-1]
    if bands.ndim != 2 or bands.shape[0] != k or b.shape != (n,):
        raise ValueError(f"cg_banded: bands {tuple(bands.shape)}, b "
                         f"{tuple(b.shape)}, {k} offsets")
    if b.dtype not in DTYPES:
        raise TypeError(f"cg_banded: float32 or float64 operands, got {b.dtype}")
    sigma = float(sigma)
    if device < 0:
        return cg_banded_plain(bands, offsets, sigma, b, tol=tol, atol=atol,
                               maxiter=maxiter)
    if not 1 <= k <= MAX_OFFSETS:
        raise ValueError(f"cg_banded: the kernel takes 1 to {MAX_OFFSETS} "
                         f"diagonals, got {k}")
    maxiter = 10 * n if maxiter is None else int(maxiter)
    fns, capacity = _resolve()
    x, r, p0, p1, Ap = (torch.empty_like(b) for _ in range(5))
    partials = torch.empty(capacity, dtype=b.dtype, device=b.device)
    iters = torch.empty((), dtype=torch.int64, device=b.device)
    guard, stream = _build.launch_context(b.device)
    ticket = _ticket(b.device, stream)
    with guard:
        rc = fns[b.dtype](bands.data_ptr(), k, array, n, sigma, b.data_ptr(),
                          x.data_ptr(), r.data_ptr(), p0.data_ptr(),
                          p1.data_ptr(), Ap.data_ptr(), partials.data_ptr(),
                          capacity, ticket.data_ptr(), iters.data_ptr(),
                          tol * tol, atol * atol, maxiter, stream)
    _build.check(rc, "cg_banded")
    _build.count_launch(cg_banded, b.dtype)
    its = int(iters.item())               # the solve's one host read
    return x, SolveInfo(its, its + 1)


cg_banded.launches = 0
cg_banded.dtype_launches = {}
