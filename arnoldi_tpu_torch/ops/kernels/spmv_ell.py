"""ELLPACK SpMV: ``y[r] = sum_l data[r, l] * x[cols[r, l]]``.

Counterpart of ``arnoldi_tpu/ops/pallas/spmv_ell.py``.  On CUDA tensors
:func:`ell_matvec` (one column) and :func:`ell_matmat` (b columns, the rows
of a ``(b, n_cols)`` array) launch the hand-written kernel
``csrc/spmv_ell.cu``; on CPU tensors they run :func:`ell_matvec_plain`.
``x`` may be longer than the row count (rectangular operators): the gather
width comes from ``x``.  Every call is one launch, whose path is a fixed
rule on the row length L and the column count b (:func:`ell_plan` mirrors
it); the design note is at the top of ``csrc/spmv_ell.cu``.

Both wrappers take ``_build``'s one lean launch path, as ``spmv_banded.py``
does (:func:`_build.operand_device`, :func:`_build.launch`).
"""

import dataclasses

import torch

from . import _build

#: The staged paths' longest row (kMaxShortL in the CUDA source); longer
#: rows take a warp each.
MAX_SHORT_L = 32
#: Columns of a warp-path chunk (kMaxCols); up to this many columns a
#: thread of the column-group kernel takes 2 at a time, above it 4 (2 in
#: complex128).
WARP_COLS = 8
#: Rows of a tile: the single-column kernel's (kTileRows), the column-group
#: kernel's (kGroupRows).
TILE_ROWS, GROUP_ROWS = 32, 64
#: Columns a block of the column-group kernel serves (kGroupCols), and the
#: most threads it takes (kGroupThreads, also the warp path's block).
GROUP_COLS, BLOCK_THREADS = 64, 256


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """One launch of the ELL kernel (the arithmetic of ``launch_ell`` in
    ``csrc/spmv_ell.cu``).

    ``path``: ``"tiles"`` (L <= 32, one column: a persistent grid walks
    tiles of ``tile_rows`` rows staged in shared memory, a thread a row;
    ``grid`` counts the tiles, and the launch takes at most as many blocks
    as fit the card), ``"groups"`` (L <= 32, b >= 2: block ``(tile,
    group)`` stages its tile once and serves ``group_cols`` columns from
    it, ``thread_cols`` of them a thread at a time, with ``threads //
    tile_rows`` threads a row) or ``"warp"`` (L > 32: a warp a row,
    ``tile_rows`` rows a block, the columns ``group_cols`` at a time in one
    launch).
    """

    path: str
    tile_rows: int
    group_cols: int
    thread_cols: int
    threads: int
    grid: tuple


def ell_plan(n_rows, L, nb, dtype):
    """The launch ``ell_matvec`` (``nb = 1``) or ``ell_matmat`` makes for
    an ``(n_rows, L)`` operator with ``nb`` columns of ``dtype``."""
    if n_rows < 1 or L < 1 or nb < 1:
        raise ValueError(f"ell_plan: n_rows {n_rows}, L {L}, nb {nb}")
    if L > MAX_SHORT_L:
        rows = BLOCK_THREADS // 32
        return EllPlan("warp", rows, min(nb, WARP_COLS), 1, BLOCK_THREADS,
                       (-(-n_rows // rows), 1))
    if nb == 1:
        return EllPlan("tiles", TILE_ROWS, 1, 1, TILE_ROWS,
                       (-(-n_rows // TILE_ROWS), 1))
    per = 2 if nb <= WARP_COLS or dtype == torch.complex128 else 4
    lanes = min(BLOCK_THREADS // GROUP_ROWS, -(-min(nb, GROUP_COLS) // per))
    return EllPlan("groups", GROUP_ROWS, GROUP_COLS, per, GROUP_ROWS * lanes,
                   (-(-n_rows // GROUP_ROWS), -(-nb // GROUP_COLS)))


def ell_matvec_plain(data, cols, x):
    """Plain PyTorch ELL product, any device, for ``x`` of shape (n_cols,)
    or (b, n_cols) (b columns as rows)."""
    return (data * x[..., cols.long()]).sum(dim=-1)


def _launch(kernel, data, cols, x):
    device = _build.operand_device(kernel, data, x)
    if cols.dtype != torch.int32:
        raise TypeError(f"{kernel}: cols must be int32, got {cols.dtype}")
    if not _build.on_device(cols, device):
        raise ValueError(f"{kernel}: cols on {cols.device}, operands on "
                         f"{data.device}")
    if not cols.is_contiguous():
        raise ValueError(f"{kernel}: cols must be contiguous")
    if data.ndim != 2 or cols.shape != data.shape:
        raise ValueError(f"{kernel}: data {tuple(data.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    if device < 0:
        return ell_matvec_plain(data, cols, x)
    n_rows, L = data.shape
    nb = x.shape[0] if x.ndim == 2 else 1
    y = x.new_empty((nb, n_rows) if x.ndim == 2 else (n_rows,))
    _build.launch(kernel, "arn_spmv_ell", x.dtype, device, data.data_ptr(),
                  cols.data_ptr(), x.data_ptr(), y.data_ptr(), n_rows,
                  x.shape[-1], L, nb)
    return y


def ell_matvec(data, cols, x):
    """ELL matvec: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors.  ``data``: (n_rows, L); ``cols``: (n_rows, L) int32 column
    ids, each below ``len(x)``; ``x``: (n_cols,)."""
    if x.ndim != 1:
        raise ValueError(f"spmv_ell: x must be (n_cols,), got {tuple(x.shape)}")
    return _launch("spmv_ell", data, cols, x)


def ell_matmat(data, cols, X):
    """ELL product with b columns given as the rows of ``X`` (b, n_cols);
    returns (b, n_rows).  One launch at any b: a block stages its tile's
    values and ids once and serves a group of up to 64 columns from shared
    memory, so they are read from device memory once per 64 columns
    (:func:`ell_plan`); rows of more than 32 slots take a warp each, 8
    columns at a time."""
    if X.ndim != 2:
        raise ValueError(f"spmv_ell_cols: X must be (b, n_cols), got "
                         f"{tuple(X.shape)}")
    return _launch("spmv_ell_cols", data, cols, X)
