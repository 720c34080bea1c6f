"""BSR SpMV: ``y_blk[i] = sum_l blocks[i, l] @ x_blk[cols[i, l]]``.

Counterpart of ``arnoldi_tpu/ops/pallas/spmv_bsr.py``, both of its kernels:

* the gather kernel (``bsr_matvec_pallas``): :func:`bsr_matvec` (one
  column) and :func:`bsr_matmat` (b columns, the rows of a ``(b, n_cols)``
  array) read x straight from device memory;
* the window kernel (``bsr_matvec_pallas16`` with ``pack_bsr16``):
  :func:`bsr_window_matvec` and :func:`bsr_window_matmat` let each tile of
  block-rows read x only from a window of block-columns, staged in shared
  memory.  :func:`pack_bsr_window` computes the windows on the host;
  :func:`window_cols_per_pass`, :func:`window_stages` and
  :func:`window_items` are the launch's plan (the columns a pass stages,
  whether the next item's copy overlaps this one, and the run of (tile,
  pass) items each thread block of the persistent grid walks).

On CUDA tensors the wrappers launch ``csrc/spmv_bsr.cu``; on CPU tensors
they run :func:`bsr_matvec_plain` and :func:`bsr_window_matvec_plain`.  The
kernels take blocks whose column count ``c`` divides 32 and with at most
256 values (8 x 8 is the format's use); other block shapes raise on the
card.
"""

import dataclasses

import numpy as np
import torch

from . import _build

#: Block-rows one thread block of the window kernel owns (one tile).
WINDOW_TILE_BROWS = 128
#: A BsrOperator takes the window kernel when one column's window, Wt
#: block-columns of c values, fits this many bytes; a wider window takes the
#: gather kernel.  At 64 KB three columns fit one thread block.
WINDOW_BUDGET_BYTES = 64 * 1024
#: Dynamic shared memory one thread block may use on sm_90 (227 KB).
MAX_SHARED_BYTES = 232448
#: Columns a warp keeps in registers in the b-column forms (kCols in the
#: CUDA source); the window kernel stages at most this many per pass.
MAX_COLS_PER_PASS = 8
#: Shared memory the window kernel keeps beside its stages (two mbarriers).
_BARRIER_BYTES = 16


@dataclasses.dataclass(frozen=True)
class BsrWindow:
    """Window layout of a BSR operator for the window kernel.

    ``cols``: (n_brow, L) int32 block-column ids with each padding slot
    repointed at its row's own column range; ``tile_base``: (n_tiles,)
    int32 first block-column of each tile's window; ``width``: the window
    Wt in block-columns, the same for every tile; ``tile_brows``: block-rows
    per tile.
    """

    cols: torch.Tensor
    tile_base: torch.Tensor
    width: int
    tile_brows: int

    def to(self, device):
        return dataclasses.replace(self, cols=self.cols.to(device),
                                   tile_base=self.tile_base.to(device))

    def fits(self, c, dtype):
        """True when one column's window of ``c``-wide block-columns in
        ``dtype`` fits :data:`WINDOW_BUDGET_BYTES`: the rule that picks the
        window kernel over the gather kernel."""
        return self.width * c * dtype.itemsize <= WINDOW_BUDGET_BYTES


def pack_bsr_window(blocks, block_cols, tile_brows=WINDOW_TILE_BROWS):
    """Host packing for the window kernel, from NumPy ``blocks`` (n_brow,
    L, r, c) and ``block_cols`` (n_brow, L).

    Returns ``(cols, tile_base, Wt)``: the ids with padding slots repointed,
    each tile's unclamped window base, and the window width rounded up to a
    multiple of 8 block-columns.  Padding slots (all-zero blocks) hold id 0;
    left alone they would stretch every window to column 0, so each is
    repointed at its row's smallest valid id, and a row with none inherits
    the previous row's (``pack_bsr16``'s rule, so that a tile of
    ``16 * row_tile16`` block-rows gets its ``tile_base`` and ``Wt``).
    """
    blocks = np.asarray(blocks)
    cols = np.asarray(block_cols)
    n_brow, L = cols.shape
    n_tiles = max(-(-n_brow // tile_brows), 1)
    pad = n_tiles * tile_brows - n_brow
    valid = np.pad(blocks.reshape(n_brow, L, -1).any(axis=2), ((0, pad), (0, 0)))
    cols_p = np.pad(cols, ((0, pad), (0, 0)))
    row_min = np.where(valid, cols_p, np.iinfo(np.int32).max).min(axis=1)
    empty = ~valid.any(axis=1)
    if empty.any():
        idxs = np.arange(len(row_min))
        last_valid = np.maximum.accumulate(np.where(~empty, idxs, -1))
        row_min = np.where(last_valid >= 0, row_min[np.maximum(last_valid, 0)], 0)
    cols_p = np.where(valid, cols_p, row_min[:, None]).astype(np.int32)
    ct = cols_p.reshape(n_tiles, tile_brows * L)
    tile_base = ct.min(axis=1).astype(np.int32)
    Wt = int((ct.max(axis=1) - tile_base).max()) + 1
    Wt = -(-Wt // 8) * 8
    return np.ascontiguousarray(cols_p[:n_brow]), tile_base, Wt


def bsr_window(blocks, block_cols, *, device, tile_brows=WINDOW_TILE_BROWS):
    """:class:`BsrWindow` of a BSR operator's NumPy arrays, on ``device``."""
    cols, tile_base, Wt = pack_bsr_window(blocks, block_cols, tile_brows)
    return BsrWindow(torch.from_numpy(cols).to(device),
                     torch.from_numpy(tile_base).to(device), Wt, tile_brows)


def window_cols_per_pass(nb, col_bytes):
    """Columns the window kernel stages a pass, for ``nb`` columns that
    take ``col_bytes`` each in a stage (the window and one zero
    block-column): as many as one stage fits in :data:`MAX_SHARED_BYTES`,
    at most :data:`MAX_COLS_PER_PASS`, so that each block is read once for
    as many columns as can be; 0 when not even one column fits."""
    return min(nb, MAX_COLS_PER_PASS,
               (MAX_SHARED_BYTES - _BARRIER_BYTES) // col_bytes)


def window_stages(per_pass, col_bytes):
    """Stages of the window kernel's 8 x 8 path: 2 (the next item's
    windows copied while this item is contracted) when two stages of
    ``per_pass`` columns fit, else 1."""
    fits = _BARRIER_BYTES + 2 * per_pass * col_bytes <= MAX_SHARED_BYTES
    return 2 if fits else 1


def window_items(n_tiles, nb, per_pass, n_blocks):
    """The window kernel's plan: for each of ``n_blocks`` thread blocks of
    the persistent grid, the list of ``(tile, first column, columns)`` it
    stages and contracts, in order.  Item i is tile ``i // passes``, pass
    ``i % passes``; block g takes items ``[g*n // G, (g+1)*n // G)``, so the
    passes of a tile run back to back, mostly in one block (the arithmetic
    of ``spmv_bsr_window8_kernel``)."""
    passes = -(-nb // per_pass)
    n = n_tiles * passes
    plan = []
    for g in range(n_blocks):
        run = []
        for i in range(g * n // n_blocks, (g + 1) * n // n_blocks):
            tile, p = divmod(i, passes)
            j0 = p * per_pass
            run.append((tile, j0, min(per_pass, nb - j0)))
        plan.append(run)
    return plan


def window_bases(window, n_cols, c):
    """Each tile's staged window base in block-columns, clamped so the
    window stays inside ``max(n_bcol, Wt)`` block-columns (the kernel's and
    the JAX package's clamp)."""
    n_bcol = max(-(-n_cols // c), window.width)
    return window.tile_base.long().clamp(0, n_bcol - window.width)


def _x_blocks(x, c):
    """x (..., n_cols) zero-padded to whole block-columns, as (..., n_bcol, c)."""
    n_cols = x.shape[-1]
    n_bcol = -(-n_cols // c)
    xp = torch.zeros((*x.shape[:-1], n_bcol * c), dtype=x.dtype, device=x.device)
    xp[..., :n_cols] = x
    return xp.reshape(*x.shape[:-1], n_bcol, c)


def _contract(blocks, xg, n_rows):
    """sum over (l, c) of blocks (n_brow, L, r, c) times gathered x
    (..., n_brow, L, c); rows past ``n_rows`` dropped."""
    yb = torch.einsum("blrc,...blc->...br", blocks, xg)
    return yb.reshape(*yb.shape[:-2], -1)[..., :n_rows]


def bsr_matvec_plain(blocks, cols, x, n_rows):
    """Plain PyTorch BSR product, any device, for ``x`` of shape (n_cols,)
    or (b, n_cols) (b columns as rows)."""
    xb = _x_blocks(x, blocks.shape[3])
    return _contract(blocks, xb[..., cols.long(), :], n_rows)


def bsr_window_matvec_plain(blocks, window, x, n_rows):
    """Plain PyTorch version of the window kernel: each block-row reads x
    from its tile's window (base clamped as the kernel clamps it), and an id
    outside the window reads zero."""
    c = blocks.shape[3]
    xb = _x_blocks(x, c)
    base = window_bases(window, x.shape[-1], c)
    cols = window.cols.long()
    tile = torch.arange(cols.shape[0], device=cols.device) // window.tile_brows
    rel = cols - base[tile][:, None]
    inside = (rel >= 0) & (rel < window.width)
    xg = torch.where(inside[..., None], xb[..., cols, :], 0)
    return _contract(blocks, xg, n_rows)


def _check(kernel, blocks, cols, x, n_rows):
    cuda = _build.on_cuda(kernel, blocks, x)
    if cols.dtype != torch.int32 or cols.device != blocks.device \
            or not cols.is_contiguous():
        raise TypeError(f"{kernel}: block ids must be contiguous int32 on the "
                        "operands' device")
    if blocks.ndim != 4 or cols.shape != blocks.shape[:2] \
            or not 0 <= n_rows <= blocks.shape[0] * blocks.shape[2]:
        raise ValueError(f"{kernel}: blocks {tuple(blocks.shape)}, ids "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}, "
                         f"n_rows={n_rows}")
    if cuda:
        r, c = blocks.shape[2:]
        if c > 32 or c & (c - 1) or r * c > 256:
            raise ValueError(f"{kernel}: the kernel takes blocks whose column "
                             f"count divides 32 with at most 256 values, got "
                             f"{r} x {c}")
    return cuda


def _out(blocks, x, n_rows):
    return torch.empty((*x.shape[:-1], n_rows), dtype=blocks.dtype,
                       device=blocks.device)


def _gather(kernel, wrapper, blocks, cols, x, n_rows):
    n_rows = int(n_rows)
    if not _check(kernel, blocks, cols, x, n_rows):
        return bsr_matvec_plain(blocks, cols, x, n_rows)
    n_brow, L, r, c = blocks.shape
    y = _out(blocks, x, n_rows)
    nb = x.shape[0] if x.ndim == 2 else 1
    fn = _build.kernel_fn("arn_spmv_bsr", blocks.dtype)
    guard, stream = _build.launch_context(blocks.device)
    with guard:
        rc = fn(blocks.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(),
                n_brow, L, r, c, n_rows, x.shape[-1], nb, stream)
    _build.check(rc, kernel)
    wrapper.launches += 1
    return y


def _windowed(kernel, wrapper, blocks, window, x, n_rows):
    n_rows = int(n_rows)
    if not _check(kernel, blocks, window.cols, x, n_rows):
        return bsr_window_matvec_plain(blocks, window, x, n_rows)
    n_brow, L, r, c = blocks.shape
    tiles = -(-n_brow // window.tile_brows)
    if window.tile_base.dtype != torch.int32 or window.tile_base.shape != (tiles,) \
            or window.tile_base.device != blocks.device:
        raise ValueError(f"{kernel}: tile_base must be ({tiles},) int32 on the "
                         "operands' device")
    nb = x.shape[0] if x.ndim == 2 else 1
    col_bytes = (window.width + 1) * c * blocks.dtype.itemsize
    per_pass = window_cols_per_pass(nb, col_bytes)
    if per_pass < 1:
        raise ValueError(f"{kernel}: a window of {col_bytes} bytes a column does "
                         f"not fit {MAX_SHARED_BYTES} bytes of shared memory")
    y = _out(blocks, x, n_rows)
    fn = _build.kernel_fn("arn_spmv_bsr_window", blocks.dtype)
    guard, stream = _build.launch_context(blocks.device)
    with guard:
        rc = fn(blocks.data_ptr(), window.cols.data_ptr(),
                window.tile_base.data_ptr(), x.data_ptr(), y.data_ptr(), n_brow,
                L, r, c, n_rows, x.shape[-1], nb, window.tile_brows,
                window.width, per_pass, stream)
    _build.check(rc, kernel)
    wrapper.launches += 1
    return y


def _one(kernel, x):
    if x.ndim != 1:
        raise ValueError(f"{kernel}: x must be (n_cols,), got {tuple(x.shape)}")


def _rows(kernel, X):
    if X.ndim != 2:
        raise ValueError(f"{kernel}: X must be (b, n_cols), got {tuple(X.shape)}")


def bsr_matvec(blocks, cols, x, n_rows):
    """BSR matvec through the gather kernel (CUDA) or its plain version
    (CPU).  ``blocks``: (n_brow, L, r, c); ``cols``: (n_brow, L) int32;
    ``x``: (n_cols,); returns (n_rows,)."""
    _one("spmv_bsr", x)
    return _gather("spmv_bsr", bsr_matvec, blocks, cols, x, n_rows)


bsr_matvec.launches = 0


def bsr_matmat(blocks, cols, X, n_rows):
    """:func:`bsr_matvec` for b columns given as the rows of ``X`` (b,
    n_cols); returns (b, n_rows).  Each block is read once for all b."""
    _rows("spmv_bsr_cols", X)
    return _gather("spmv_bsr_cols", bsr_matmat, blocks, cols, X, n_rows)


bsr_matmat.launches = 0


def bsr_window_matvec(blocks, window, x, n_rows):
    """BSR matvec through the window kernel (CUDA) or its plain version
    (CPU); ``window`` a :class:`BsrWindow` of the same operator."""
    _one("spmv_bsr_window", x)
    return _windowed("spmv_bsr_window", bsr_window_matvec, blocks, window, x,
                     n_rows)


bsr_window_matvec.launches = 0


def bsr_window_matmat(blocks, window, X, n_rows):
    """:func:`bsr_window_matvec` for b columns given as the rows of ``X``
    (b, n_cols); returns (b, n_rows).  A pass stages the windows of
    :func:`window_cols_per_pass` columns; every column gets the bits the
    single-column kernel gives it."""
    _rows("spmv_bsr_window_cols", X)
    return _windowed("spmv_bsr_window_cols", bsr_window_matmat, blocks, window,
                     X, n_rows)


bsr_window_matmat.launches = 0
