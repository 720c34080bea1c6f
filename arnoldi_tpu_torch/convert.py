"""Carry operators and solver state over from the JAX package.

The JAX package's operators are pytrees: ``op.tree_flatten()`` gives their
arrays (leaves) and static fields (aux).  These functions take those
leaves as NumPy arrays, with the aux as it is, and build the port's
counterpart on ``device`` from the very same values, so both packages can
run on bit-identical operator arrays.  Nothing here imports JAX.
"""

import dataclasses

import numpy as np
import torch

from .linop import (BandedOperator, BsrOperator, DenseOperator, EllOperator,
                    GramOperator)
from .ops.kernels.spmv_bsr import bsr_window


def _tensor(a, device):
    return torch.tensor(np.asarray(a), device=device)


def operator_from_reference(kind, leaves, aux, *, device):
    """The port's operator for a JAX operator of class name ``kind``.

    ``leaves, aux = op.tree_flatten()`` on the JAX side, with each leaf
    passed as ``np.asarray(leaf)``.  The JAX ``backend`` field has no
    counterpart (a CUDA tensor always uses the kernel) and is dropped.

    A ``"GramOperator"``'s leaves are its legs ``(op, opT, lo, loT)``, each
    a JAX operator (or None) that is converted as ``(kind, leaves, aux)``
    from its own ``tree_flatten``, or passed already converted.  The
    port's legs hold what JAX's double-word pairs add up to: ``op + lo``
    and ``opT + loT``, summed in float64.  A ``"CallableOperator"`` raises
    ``TypeError``: a closure is not data.
    """
    if kind == "GramOperator":
        op, opT, lo, loT = (_leg(x, device) for x in leaves)
        transposed, nnz = aux
        return GramOperator(_exact_sum(op, lo), _exact_sum(opT, loT),
                            transposed=bool(transposed), nnz=int(nnz))
    if kind == "CallableOperator":
        raise TypeError("a CallableOperator has no counterpart built from "
                        "data: its closure is not data; wrap the port's own "
                        "closure in arnoldi_tpu_torch.CallableOperator")
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
    raise TypeError(f"{kind} has no counterpart in arnoldi_tpu_torch")


def _leg(x, device):
    """A Gram leg: None, a converted operator, or ``(kind, leaves, aux)``."""
    if x is None or not isinstance(x, tuple):
        return x
    kind, leaves, aux = x
    return operator_from_reference(kind, leaves, aux, device=device)


def _layout(op):
    """Everything of an operator but its values, for comparing layouts."""
    if isinstance(op, BandedOperator):
        return (op.offsets, tuple(op.bands.shape))
    if isinstance(op, EllOperator):
        return (op.shape, op.cols.cpu().numpy().tobytes())
    if isinstance(op, BsrOperator):
        return (op.shape, tuple(op.blocks.shape),
                op.block_cols.cpu().numpy().tobytes())
    return (op.shape,)


def _exact_sum(hi, lo):
    """``hi + lo`` in float64 for two operators of one format and layout
    (the JAX package's cast-residual pair), or ``hi`` when ``lo`` is None."""
    if lo is None:
        return hi
    if type(hi) is not type(lo) or _layout(hi) != _layout(lo):
        raise ValueError("a Gram leg and its cast residual differ in layout")
    if isinstance(hi, BandedOperator):
        return BandedOperator(hi.bands.double() + lo.bands.double(),
                              hi.offsets, hi.nnz_stored)
    if isinstance(hi, EllOperator):
        return EllOperator(hi.data.double() + lo.data.double(), hi.cols,
                           hi.nnz_stored, n_cols=hi.n_cols)
    if isinstance(hi, DenseOperator):
        return DenseOperator(hi.A.double() + lo.A.double())
    if isinstance(hi, BsrOperator):
        return dataclasses.replace(
            hi, blocks=hi.blocks.double() + lo.blocks.double())
    raise TypeError(f"no cast-residual sum for {type(hi).__name__}")


def workspace_from_reference(Vt, H, v0, *, device):
    """The solver state ``(Vt, H, v0)`` (NumPy arrays from the JAX side) as
    tensors on ``device``."""
    return tuple(_tensor(a, device) for a in (Vt, H, v0))
