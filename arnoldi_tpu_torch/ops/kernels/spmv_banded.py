"""DIA (banded) SpMV: ``y[i] = sum_d bands[d, i] * x[i + offsets[d]]``.

Counterpart of ``arnoldi_tpu/ops/pallas/spmv_banded.py``.  On a CUDA tensor
:func:`banded_matvec` launches the hand-written kernel
``csrc/spmv_banded.cu``; on a CPU tensor it runs
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
    """Plain PyTorch DIA matvec, any device.  Entries whose ``i + off``
    leaves ``[0, n)`` contribute zero."""
    n = bands.shape[1]
    y = torch.zeros(n, dtype=bands.dtype, device=bands.device)
    for d, off in enumerate(offsets):
        if abs(off) >= n:
            continue
        if off >= 0:
            y[: n - off] += bands[d, : n - off] * x[off:]
        else:
            y[-off:] += bands[d, -off:] * x[: n + off]
    return y


def banded_matvec(bands, x, offsets):
    """DIA matvec: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``bands``: (k, n); ``x``: (n,); ``offsets``: k ints."""
    offsets = tuple(int(o) for o in offsets)
    cuda = _build.on_cuda("spmv_dia", bands, x)
    k, n = bands.shape
    if x.shape != (n,) or len(offsets) != k:
        raise ValueError(f"spmv_dia: bands {tuple(bands.shape)}, x "
                         f"{tuple(x.shape)}, {len(offsets)} offsets")
    if not cuda:
        return banded_matvec_plain(bands, x, offsets)
    if k > MAX_OFFSETS:
        raise ValueError(f"spmv_dia: the kernel takes at most {MAX_OFFSETS} "
                         f"diagonals, got {k}")
    y = torch.empty_like(x)
    offs = (ctypes.c_longlong * max(k, 1))(*offsets)
    fn = _build.kernel_fn("arn_spmv_dia", x.dtype)
    guard, stream = _build.launch_context(x.device)
    with guard:
        rc = fn(bands.data_ptr(), x.data_ptr(), y.data_ptr(), n, k, offs, stream)
    _build.check(rc, "spmv_dia")
    banded_matvec.launches += 1
    return y


banded_matvec.launches = 0
