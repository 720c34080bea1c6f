"""ELLPACK SpMV: ``y[r] = sum_l data[r, l] * x[cols[r, l]]``.

Counterpart of ``arnoldi_tpu/ops/pallas/spmv_ell.py``.  On a CUDA tensor
:func:`ell_matvec` launches the hand-written kernel ``csrc/spmv_ell.cu``; on
a CPU tensor it runs :func:`ell_matvec_plain`.  ``x`` may be longer than the
row count (rectangular operators): the gather width comes from ``x``.
"""

import torch

from . import _build


def ell_matvec_plain(data, cols, x):
    """Plain PyTorch ELL matvec, any device."""
    return (data * x[cols.long()]).sum(dim=1)


def ell_matvec(data, cols, x):
    """ELL matvec: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``data``: (n_rows, L); ``cols``: (n_rows, L) int32 column
    ids, each below ``len(x)``; ``x``: (n_cols,)."""
    cuda = _build.on_cuda("spmv_ell", data, x)
    if cols.dtype != torch.int32 or cols.device != data.device \
            or not cols.is_contiguous():
        raise TypeError("spmv_ell: cols must be contiguous int32 on the "
                        "operands' device")
    if data.ndim != 2 or cols.shape != data.shape or x.ndim != 1:
        raise ValueError(f"spmv_ell: data {tuple(data.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    if not cuda:
        return ell_matvec_plain(data, cols, x)
    n_rows, L = data.shape
    y = torch.empty(n_rows, dtype=data.dtype, device=data.device)
    fn = _build.kernel_fn("arn_spmv_ell", data.dtype)
    guard, stream = _build.launch_context(data.device)
    with guard:
        rc = fn(data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                n_rows, L, stream)
    _build.check(rc, "spmv_ell")
    ell_matvec.launches += 1
    return y


ell_matvec.launches = 0
