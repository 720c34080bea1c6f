"""DIA (banded) SpMV: ``y[i] = sum_d bands[d, i] * x[i + offsets[d]]``.

Counterpart of ``arnoldi_tpu/ops/pallas/spmv_banded.py``.  On CUDA tensors
:func:`banded_matvec` (one column) and :func:`banded_matmat` (b columns, the
rows of a ``(b, n)`` array) launch the hand-written kernel
``csrc/spmv_banded.cu``; on CPU tensors they run
:func:`banded_matvec_plain`, the plain PyTorch version that the CPU tests
use and that the card's smoke run compares the kernel against.

The shard form, :func:`banded_matvec_ext` and :func:`banded_matmat_ext`
(``spmv_dia_ext``), runs a row range of a row block's bands against a
window of ``x``: the sharded operators of ``parallel/`` (the ring halo's
extended window, the all-gather's whole vector), with its plain version
:func:`banded_matvec_ext_plain`.

Every form launches through one lean path, since a single-column launch
takes about 0.01 ms on the card and the host's work per call set its pace:
the C entry points are resolved once, the offsets' host array once per
offsets (:func:`launch_plan`), the operands are checked by plain attribute
compares (:func:`_build.operand_device`) and the stream handle is read raw
(:func:`_build.launch`).
"""

import ctypes
import functools

import torch

from . import _build

#: Offsets the kernel takes as an argument; ``as_operator`` routes a matrix
#: to the banded format only with this many distinct diagonals or fewer.
MAX_OFFSETS = 16

_entries = None   # {dtype: C entry point}, resolved on the first launch


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


@functools.lru_cache(maxsize=64)
def launch_plan(offsets):
    """What a launch with these offsets (a tuple) passes the kernel, built
    once per offsets: ``(offsets as ints, k, the host int64 array the C
    entry point reads)``."""
    offsets = tuple(int(o) for o in offsets)
    k = len(offsets)
    return offsets, k, (ctypes.c_longlong * max(k, 1))(*offsets)


def _dia(device, bands, x, y, rows, k, array, nb, bstride, row0, x_base, x_len,
         kernel):
    """Launch the kernel on CUDA device ``device`` (operands checked)."""
    global _entries
    if _entries is None:
        _entries = _build.entry_points("arn_spmv_dia")
    rc = _build.launch(_entries[x.dtype], device, bands.data_ptr(), x.data_ptr(),
                       y.data_ptr(), rows, k, array, nb, bstride, row0, x_base,
                       x_len)
    if rc:
        _build.check(rc, kernel)


def _launch(kernel, wrapper, bands, x, offsets):
    device = _build.operand_device(kernel, bands, x)
    offsets, k, array = launch_plan(tuple(offsets))
    if bands.ndim != 2 or bands.shape[0] != k or x.shape[-1] != bands.shape[1]:
        raise ValueError(f"{kernel}: bands {tuple(bands.shape)}, x "
                         f"{tuple(x.shape)}, {k} offsets")
    if device < 0:
        return banded_matvec_plain(bands, x, offsets)
    if k > MAX_OFFSETS:
        raise ValueError(f"{kernel}: the kernel takes at most {MAX_OFFSETS} "
                         f"diagonals, got {k}")
    n = bands.shape[1]
    y = torch.empty_like(x)
    _dia(device, bands, x, y, n, k, array, x.shape[0] if x.ndim == 2 else 1,
         n, 0, 0, n, kernel)
    _build.count_launch(wrapper, x.dtype)
    return y


def banded_matvec(bands, x, offsets):
    """DIA matvec: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``bands``: (k, n); ``x``: (n,); ``offsets``: k ints."""
    if x.ndim != 1:
        raise ValueError(f"spmv_dia: x must be (n,), got {tuple(x.shape)}")
    return _launch("spmv_dia", banded_matvec, bands, x, offsets)


banded_matvec.launches = 0
banded_matvec.dtype_launches = {}


def banded_matmat(bands, X, offsets):
    """DIA product with b columns given as the rows of ``X`` (b, n); returns
    (b, n).  Each band value is read once for all b columns."""
    if X.ndim != 2:
        raise ValueError(f"spmv_dia_cols: X must be (b, n), got {tuple(X.shape)}")
    return _launch("spmv_dia_cols", banded_matmat, bands, X, offsets)


banded_matmat.launches = 0
banded_matmat.dtype_launches = {}


# -- the shard form --------------------------------------------------------

def banded_matvec_ext_plain(bands, x, offsets, *, x_base, row0=0, rows=None):
    """Plain PyTorch shard product: for ``t < rows`` and ``i = row0 + t``,
    ``y[t] = sum_d bands[d, i] * x[i + x_base + offsets[d]]``, the terms
    whose x index leaves ``[0, x_len)`` left out (``x_len = x.shape[-1]``).
    ``x`` is (x_len,) or (b, x_len); ``rows`` defaults to the bands' row
    count less ``row0``."""
    n_band = bands.shape[1]
    rows = n_band - row0 if rows is None else int(rows)
    x_len = x.shape[-1]
    y = torch.zeros((*x.shape[:-1], rows), dtype=bands.dtype,
                    device=bands.device)
    for d, off in enumerate(offsets):
        s0 = row0 + x_base + int(off)
        lo, hi = max(0, -s0), min(rows, x_len - s0)
        if lo < hi:
            y[..., lo:hi] += (bands[d, row0 + lo:row0 + hi]
                              * x[..., s0 + lo:s0 + hi])
    return y


def _launch_ext(kernel, wrapper, bands, x, offsets, x_base, row0, rows):
    device = _build.operand_device(kernel, bands, x)
    offsets, k, array = launch_plan(tuple(offsets))
    n_band = bands.shape[-1]
    rows = n_band - row0 if rows is None else int(rows)
    if bands.ndim != 2 or bands.shape[0] != k or not (
            0 <= row0 and 0 <= rows and row0 + rows <= n_band):
        raise ValueError(f"{kernel}: bands {tuple(bands.shape)}, {k} "
                         f"offsets, rows [{row0}, {row0 + rows})")
    if device < 0:
        return banded_matvec_ext_plain(bands, x, offsets, x_base=x_base,
                                       row0=row0, rows=rows)
    if k > MAX_OFFSETS:
        raise ValueError(f"{kernel}: the kernel takes at most {MAX_OFFSETS} "
                         f"diagonals, got {k}")
    nb = x.shape[0] if x.ndim == 2 else 1
    y = x.new_empty((nb, rows) if x.ndim == 2 else (rows,))
    _dia(device, bands, x, y, rows, k, array, nb, n_band, row0, int(x_base),
         x.shape[-1], kernel)
    _build.count_launch(wrapper, x.dtype)
    return y


def banded_matvec_ext(bands, x, offsets, *, x_base, row0=0, rows=None):
    """The DIA shard matvec (``spmv_dia_ext``): rows ``[row0, row0 + rows)``
    of the (k, n_band) bands of a row block against the x window ``x``
    (x_len,), row i reading ``x[i + x_base + off]`` (see
    :func:`banded_matvec_ext_plain`); returns (rows,).  The CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if x.ndim != 1:
        raise ValueError(f"spmv_dia_ext: x must be (x_len,), got {tuple(x.shape)}")
    return _launch_ext("spmv_dia_ext", banded_matvec_ext, bands, x, offsets,
                       x_base, row0, rows)


banded_matvec_ext.launches = 0
banded_matvec_ext.dtype_launches = {}


def banded_matmat_ext(bands, X, offsets, *, x_base, row0=0, rows=None):
    """The b-column shard form (``spmv_dia_ext_cols``): ``X`` (b, x_len),
    returns (b, rows); each band value read once for all b columns."""
    if X.ndim != 2:
        raise ValueError(f"spmv_dia_ext_cols: X must be (b, x_len), got "
                         f"{tuple(X.shape)}")
    return _launch_ext("spmv_dia_ext_cols", banded_matmat_ext, bands, X,
                       offsets, x_base, row0, rows)


banded_matmat_ext.launches = 0
banded_matmat_ext.dtype_launches = {}
