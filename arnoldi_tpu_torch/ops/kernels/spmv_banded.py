"""DIA (banded) SpMV: ``y[i] = sum_d bands[d, i] * x[i + offsets[d]]``.

Counterpart of ``arnoldi_tpu/ops/pallas/spmv_banded.py``.  On CUDA tensors
:func:`banded_matvec` (one column) and :func:`banded_matmat` (b columns, the
rows of a ``(b, n)`` array) launch the hand-written kernel
``csrc/spmv_banded.cu``; on CPU tensors they run
:func:`banded_matvec_plain`, the plain PyTorch version that the CPU tests
use and that the card's smoke run compares the kernel against.
"""

import ctypes

import torch

from . import _build

#: Offsets the kernel takes as an argument; ``as_operator`` routes a matrix
#: to the banded format only with this many distinct diagonals or fewer.
MAX_OFFSETS = 16


def banded_matvec_plain(bands, x, offsets):
    """Plain PyTorch DIA product, any device, for ``x`` of shape (n,) or
    (b, n) (b columns as rows).  Entries whose ``i + off`` leaves
    ``[0, n)`` contribute zero."""
    n = bands.shape[1]
    y = torch.zeros(x.shape, dtype=bands.dtype, device=bands.device)
    for d, off in enumerate(offsets):
        if abs(off) >= n:
            continue
        if off >= 0:
            y[..., : n - off] += bands[d, : n - off] * x[..., off:]
        else:
            y[..., -off:] += bands[d, -off:] * x[..., : n + off]
    return y


def _launch(kernel, wrapper, bands, x, offsets):
    offsets = tuple(int(o) for o in offsets)
    cuda = _build.on_cuda(kernel, bands, x)
    k, n = bands.shape
    if x.shape[-1:] != (n,) or len(offsets) != k:
        raise ValueError(f"{kernel}: bands {tuple(bands.shape)}, x "
                         f"{tuple(x.shape)}, {len(offsets)} offsets")
    if not cuda:
        return banded_matvec_plain(bands, x, offsets)
    if k > MAX_OFFSETS:
        raise ValueError(f"{kernel}: the kernel takes at most {MAX_OFFSETS} "
                         f"diagonals, got {k}")
    y = torch.empty_like(x)
    nb = x.shape[0] if x.ndim == 2 else 1
    offs = (ctypes.c_longlong * max(k, 1))(*offsets)
    fn = _build.kernel_fn("arn_spmv_dia", x.dtype)
    guard, stream = _build.launch_context(x.device)
    with guard:
        rc = fn(bands.data_ptr(), x.data_ptr(), y.data_ptr(), n, k, offs, nb,
                stream)
    _build.check(rc, kernel)
    wrapper.launches += 1
    return y


def banded_matvec(bands, x, offsets):
    """DIA matvec: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``bands``: (k, n); ``x``: (n,); ``offsets``: k ints."""
    if x.ndim != 1:
        raise ValueError(f"spmv_dia: x must be (n,), got {tuple(x.shape)}")
    return _launch("spmv_dia", banded_matvec, bands, x, offsets)


banded_matvec.launches = 0


def banded_matmat(bands, X, offsets):
    """DIA product with b columns given as the rows of ``X`` (b, n); returns
    (b, n).  Each band value is read once for all b columns."""
    if X.ndim != 2:
        raise ValueError(f"spmv_dia_cols: X must be (b, n), got {tuple(X.shape)}")
    return _launch("spmv_dia_cols", banded_matmat, bands, X, offsets)


banded_matmat.launches = 0
