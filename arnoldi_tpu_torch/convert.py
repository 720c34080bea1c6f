"""Carry operators and solver state over from the JAX package.

The JAX package's operators are pytrees: ``op.tree_flatten()`` gives their
arrays (leaves) and static fields (aux).  These functions take those
leaves as NumPy arrays, with the aux as it is, and build the port's
counterpart on ``device`` from the very same values, so both packages can
run on bit-identical operator arrays.  Nothing here imports JAX.
"""

import numpy as np
import torch

from .linop import BandedOperator, BsrOperator, DenseOperator, EllOperator
from .ops.kernels.spmv_bsr import bsr_window


def _tensor(a, device):
    return torch.tensor(np.asarray(a), device=device)


def operator_from_reference(kind, leaves, aux, *, device):
    """The port's operator for a JAX operator of class name ``kind``.

    ``leaves, aux = op.tree_flatten()`` on the JAX side, with each leaf
    passed as ``np.asarray(leaf)``.  The JAX ``backend`` field has no
    counterpart (a CUDA tensor always uses the kernel) and is dropped.
    """
    if kind == "DenseOperator":
        (A,) = leaves
        return DenseOperator(_tensor(A, device))
    if kind == "BandedOperator":
        (bands,) = leaves
        offsets, nnz_stored, _backend = aux
        return BandedOperator(_tensor(bands, device),
                              tuple(int(o) for o in offsets), int(nnz_stored))
    if kind == "EllOperator":
        data, cols = leaves
        nnz_stored, _backend, n_cols = aux
        return EllOperator(_tensor(data, device),
                           _tensor(np.asarray(cols, np.int32), device),
                           int(nnz_stored), n_cols=int(n_cols))
    if kind == "BsrOperator":
        blocks, block_cols = (np.asarray(a) for a in leaves)
        block_cols = block_cols.astype(np.int32)
        nnz_stored, n_cols, n_rows = aux
        return BsrOperator(_tensor(blocks, device), _tensor(block_cols, device),
                           int(nnz_stored), n_cols=int(n_cols),
                           n_rows=int(n_rows),
                           window=bsr_window(blocks, block_cols, device=device))
    raise NotImplementedError(
        f"{kind} has no counterpart in arnoldi_tpu_torch yet (ROADMAP.md, "
        "Queue 1 item 2)")


def workspace_from_reference(Vt, H, v0, *, device):
    """The solver state ``(Vt, H, v0)`` (NumPy arrays from the JAX side) as
    tensors on ``device``."""
    return tuple(_tensor(a, device) for a in (Vt, H, v0))
