"""ELLPACK SpMV: ``y[r] = sum_l data[r, l] * x[cols[r, l]]``.

Counterpart of ``arnoldi_tpu/ops/pallas/spmv_ell.py``.  On CUDA tensors
:func:`ell_matvec` (one column) and :func:`ell_matmat` (b columns, the rows
of a ``(b, n_cols)`` array) launch the hand-written kernel
``csrc/spmv_ell.cu``; on CPU tensors they run :func:`ell_matvec_plain`.
``x`` may be longer than the row count (rectangular operators): the gather
width comes from ``x``.
"""

import torch

from . import _build


def ell_matvec_plain(data, cols, x):
    """Plain PyTorch ELL product, any device, for ``x`` of shape (n_cols,)
    or (b, n_cols) (b columns as rows)."""
    return (data * x[..., cols.long()]).sum(dim=-1)


def _launch(kernel, wrapper, data, cols, x):
    cuda = _build.on_cuda(kernel, data, x)
    if cols.dtype != torch.int32 or cols.device != data.device \
            or not cols.is_contiguous():
        raise TypeError(f"{kernel}: cols must be contiguous int32 on the "
                        "operands' device")
    if data.ndim != 2 or cols.shape != data.shape:
        raise ValueError(f"{kernel}: data {tuple(data.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    if not cuda:
        return ell_matvec_plain(data, cols, x)
    n_rows, L = data.shape
    n_cols = x.shape[-1]
    nb = x.shape[0] if x.ndim == 2 else 1
    y = torch.empty((*x.shape[:-1], n_rows), dtype=data.dtype, device=data.device)
    fn = _build.kernel_fn("arn_spmv_ell", data.dtype)
    guard, stream = _build.launch_context(data.device)
    with guard:
        rc = fn(data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                n_rows, n_cols, L, nb, stream)
    _build.check(rc, kernel)
    wrapper.launches += 1
    return y


def ell_matvec(data, cols, x):
    """ELL matvec: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``data``: (n_rows, L); ``cols``: (n_rows, L) int32 column
    ids, each below ``len(x)``; ``x``: (n_cols,)."""
    if x.ndim != 1:
        raise ValueError(f"spmv_ell: x must be (n_cols,), got {tuple(x.shape)}")
    return _launch("spmv_ell", ell_matvec, data, cols, x)


ell_matvec.launches = 0


def ell_matmat(data, cols, X):
    """ELL product with b columns given as the rows of ``X`` (b, n_cols);
    returns (b, n_rows).  Each value and id is read once for all b
    columns."""
    if X.ndim != 2:
        raise ValueError(f"spmv_ell_cols: X must be (b, n_cols), got "
                         f"{tuple(X.shape)}")
    return _launch("spmv_ell_cols", ell_matmat, data, cols, X)


ell_matmat.launches = 0
