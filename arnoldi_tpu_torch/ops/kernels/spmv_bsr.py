"""BSR SpMV: ``y_blk[i] = sum_l blocks[i, l] @ x_blk[cols[i, l]]``.

Counterpart of ``arnoldi_tpu/ops/pallas/spmv_bsr.py``, both of its kernels:

* the gather kernel (``bsr_matvec_pallas``): :func:`bsr_matvec` (one
  column) and :func:`bsr_matmat` (b columns, the rows of a ``(b, n_cols)``
  array) read x straight from device memory (L2); :func:`bsr_matmat` on
  8 x 8 blocks takes a kernel of its own, which stages each block's x
  segments in shared memory (:func:`uses_gather8` is the rule and
  :func:`gather8_steps` its persistent grid's walk);
* the window kernel (``bsr_matvec_pallas16`` with ``pack_bsr16``):
  :func:`bsr_window_matvec` and :func:`bsr_window_matmat` let each tile of
  block-rows read x only from a window of block-columns (an id outside it
  reads zero).  :func:`pack_bsr_window` computes the windows on the host;
  :func:`window_plan` is the launch.  On 8 x 8 blocks one column stages
  each tile's window in shared memory (:func:`window_stages`,
  :func:`window_items`), and b >= 2 columns take the walk: the staged 8 x
  8 gather kernel's walk (:func:`gather8_steps`) over the window layout,
  which copies only the x segments its blocks need and reads each block
  once for 8 columns.  Other block shapes stage :func:`window_cols_per_pass`
  columns' windows a pass.

On CUDA tensors the wrappers launch ``csrc/spmv_bsr.cu``; on CPU tensors
they run :func:`bsr_matvec_plain` and :func:`bsr_window_matvec_plain`.  The
kernels take blocks whose column count ``c`` divides 32 and with at most
256 values (8 x 8 is the format's use); other block shapes raise on the
card.  Values may be float32, float64, complex64 or complex128; the product
is ``blocks @ x`` with no conjugate in every dtype.  On other block shapes
than 8 x 8, complex128 carries :func:`cols_per_pass` = 4 columns a pass
(the others 8), so that the sums fit the registers; the 8 x 8 b-column
kernels keep 8 in every dtype.

Every wrapper takes ``_build``'s one lean launch path, as ``spmv_banded.py``
does (:func:`_build.operand_device`, :func:`_build.launch`).
"""

import dataclasses
import functools

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
#: Columns a warp keeps in registers in the b-column forms: a pass of the
#: 8 x 8 kernels in every dtype; on other block shapes Plan::kCols in the
#: CUDA source, half as many in complex128 (:func:`cols_per_pass`).
MAX_COLS_PER_PASS = 8
#: Shared memory the 8 x 8 window kernel keeps beside its stages (two
#: mbarriers).
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
        window kernel over the gather kernel.  It counts bytes, so a
        complex128 window takes half the block-columns a float64 one may
        (512 at c = 8)."""
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


def cols_per_pass(dtype):
    """Columns the general kernels (block shapes other than 8 x 8) keep in
    registers a pass, and the general window kernel stages at most, by
    value dtype: :data:`MAX_COLS_PER_PASS` (8), and 4 in complex128, whose
    values take twice a float64 value's registers (``Plan::kCols`` in the
    CUDA source)."""
    return MAX_COLS_PER_PASS // 2 if dtype == torch.complex128 else MAX_COLS_PER_PASS


def window_cols_per_pass(nb, col_bytes, max_cols=MAX_COLS_PER_PASS):
    """Columns the general window kernel (block shapes other than 8 x 8)
    stages a pass, for ``nb`` columns that take ``col_bytes`` each (the
    window and one block-column): as many as one stage fits in
    :data:`MAX_SHARED_BYTES`, at most ``max_cols`` (:func:`cols_per_pass`
    of the dtype); 0 when not even one column fits."""
    return min(nb, max_cols, (MAX_SHARED_BYTES - _BARRIER_BYTES) // col_bytes)


def window_stages(col_bytes):
    """Stages of the one-column 8 x 8 window kernel, whose stage takes
    ``col_bytes`` (the window and one zero block-column): 2 (the next
    tile's window copied while this tile is contracted) when two fit, else
    1."""
    return 2 if _BARRIER_BYTES + 2 * col_bytes <= MAX_SHARED_BYTES else 1


def window_items(n_tiles, n_blocks):
    """The one-column 8 x 8 window kernel's plan: for each of ``n_blocks``
    thread blocks of the persistent grid, the tiles it stages and
    contracts, in order: block g takes tiles ``[g*n // G, (g+1)*n // G)``
    (the arithmetic of ``spmv_bsr_window8_kernel``)."""
    return [list(range(g * n_tiles // n_blocks, (g + 1) * n_tiles // n_blocks))
            for g in range(n_blocks)]


def gather8_threads(dtype):
    """Threads a block of the staged 8 x 8 gather kernel (and of the
    window walk) runs: 256 in complex128, 512 otherwise
    (``Plan::kGatherThreads``)."""
    return 256 if dtype == torch.complex128 else 512


def gather8_shared_bytes(dtype):
    """Shared memory a block of the staged 8 x 8 gather kernel (and of the
    window walk) takes: each half-warp's slice of 4 slots x 8 columns x 8
    x values, plus 32 bytes that put the half-warps on other banks."""
    item = dtype.itemsize
    warps = gather8_threads(dtype) // 32
    return warps * 2 * (4 * MAX_COLS_PER_PASS * 8 + 32 // item) * item


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """One launch of the window wrapper (:func:`window_plan`).

    ``path``: ``"walk"`` (8 x 8 blocks, b >= 2: no window staged, the
    staged gather kernel's walk, :func:`gather8_steps`, over the window
    layout), ``"staged"`` (8 x 8, one column: its window staged a tile, in
    ``stages`` stages, :func:`window_items`) or ``"general"`` (other block
    shapes: ``cols_per_pass`` columns' windows staged a pass, one stage);
    ``passes``: the passes over the columns, each reading every block
    once; ``threads`` and ``shared_bytes``: a thread block's.
    """

    path: str
    cols_per_pass: int
    passes: int
    stages: int
    threads: int
    shared_bytes: int


@functools.lru_cache(maxsize=64)
def window_plan(r, c, nb, width, dtype):
    """The launch :func:`bsr_window_matvec` (``nb = 1``) or
    :func:`bsr_window_matmat` makes for ``r x c`` blocks, a window of
    ``width`` block-columns and ``nb`` columns of ``dtype`` (cached: the
    wrapper asks on every call).  ``cols_per_pass`` is 0 when not even one
    column's window fits shared memory (the wrapper refuses it)."""
    if uses_gather8(r, c, nb):
        return WindowPlan("walk", MAX_COLS_PER_PASS, -(-nb // MAX_COLS_PER_PASS),
                          0, gather8_threads(dtype), gather8_shared_bytes(dtype))
    col_bytes = (width + 1) * c * dtype.itemsize
    if r == 8 and c == 8:
        fits = int(_BARRIER_BYTES + col_bytes <= MAX_SHARED_BYTES)
        stages = window_stages(col_bytes)
        return WindowPlan("staged", fits, 1, stages, 256,
                          _BARRIER_BYTES + stages * col_bytes)
    per_pass = window_cols_per_pass(nb, col_bytes, cols_per_pass(dtype))
    return WindowPlan("general", per_pass, -(-nb // max(per_pass, 1)), 1, 256,
                      per_pass * width * c * dtype.itemsize)


def uses_gather8(r, c, nb):
    """True when a b-column launch takes the 8 x 8 walk: the gather
    wrapper's the staged 8 x 8 kernel (``spmv_bsr_gather8_kernel``), the
    window wrapper's the same kernel over the window layout.  8 x 8 blocks
    and at least two columns; one column, and every other block shape,
    take the other kernels."""
    return r == 8 and c == 8 and nb >= 2


def gather8_steps(n_brow, L, nb, n_warps):
    """The 8 x 8 gather kernel's walk: for each of ``n_warps`` warps of the
    persistent grid, the list of ``(block-row pair, first column, columns,
    first slot)`` steps it takes, in order.  Warp w takes the pairs w,
    w + n_warps, ...; a pair's steps are its passes of at most
    :data:`MAX_COLS_PER_PASS` columns (in every dtype), each over its slots
    4 at a time (the arithmetic of ``spmv_bsr_gather8_kernel``).  The
    window wrapper's walk takes the same steps over the window layout's
    ids."""
    n_pairs = -(-n_brow // 2)
    G, U = MAX_COLS_PER_PASS, 4
    plan = []
    for w in range(n_warps):
        run = []
        for pair in range(w, n_pairs, n_warps):
            for j0 in range(0, nb, G):
                for l0 in range(0, L, U):
                    run.append((pair, j0, min(G, nb - j0), l0))
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
    """The wrappers' checks; returns the CUDA device index (launch the
    kernel) or -1 (CPU tensors: run the plain version)."""
    device = _build.operand_device(kernel, blocks, x)
    if cols.dtype != torch.int32 or not _build.on_device(cols, device) \
            or not cols.is_contiguous():
        raise TypeError(f"{kernel}: block ids must be contiguous int32 on the "
                        "operands' device")
    if blocks.ndim != 4 or cols.shape != blocks.shape[:2] \
            or not 0 <= n_rows <= blocks.shape[0] * blocks.shape[2]:
        raise ValueError(f"{kernel}: blocks {tuple(blocks.shape)}, ids "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}, "
                         f"n_rows={n_rows}")
    if device >= 0:
        r, c = blocks.shape[2:]
        if c > 32 or c & (c - 1) or r * c > 256:
            raise ValueError(f"{kernel}: the kernel takes blocks whose column "
                             f"count divides 32 with at most 256 values, got "
                             f"{r} x {c}")
    return device


def _out(blocks, x, n_rows):
    return blocks.new_empty((*x.shape[:-1], n_rows))


def _gather(kernel, blocks, cols, x, n_rows):
    n_rows = int(n_rows)
    device = _check(kernel, blocks, cols, x, n_rows)
    if device < 0:
        return bsr_matvec_plain(blocks, cols, x, n_rows)
    n_brow, L, r, c = blocks.shape
    y = _out(blocks, x, n_rows)
    nb = x.shape[0] if x.ndim == 2 else 1
    _build.launch(kernel, "arn_spmv_bsr", blocks.dtype, device, blocks.data_ptr(),
                  cols.data_ptr(), x.data_ptr(), y.data_ptr(), n_brow, L, r, c,
                  n_rows, x.shape[-1], nb)
    if uses_gather8(r, c, nb):
        bsr_matmat.gather8_launches += 1
    return y


def _windowed(kernel, blocks, window, x, n_rows):
    n_rows = int(n_rows)
    device = _check(kernel, blocks, window.cols, x, n_rows)
    if device < 0:
        return bsr_window_matvec_plain(blocks, window, x, n_rows)
    n_brow, L, r, c = blocks.shape
    tiles = -(-n_brow // window.tile_brows)
    base = window.tile_base
    if base.dtype != torch.int32 or base.shape != (tiles,) \
            or not _build.on_device(base, device):
        raise ValueError(f"{kernel}: tile_base must be ({tiles},) int32 on the "
                         "operands' device")
    nb = x.shape[0] if x.ndim == 2 else 1
    plan = window_plan(r, c, nb, window.width, blocks.dtype)
    if plan.cols_per_pass < 1:
        raise ValueError(f"{kernel}: a window of {window.width} block-columns of "
                         f"{c} {blocks.dtype} values does not fit "
                         f"{MAX_SHARED_BYTES} bytes of shared memory")
    y = _out(blocks, x, n_rows)
    _build.launch(kernel, "arn_spmv_bsr_window", blocks.dtype, device,
                  blocks.data_ptr(), window.cols.data_ptr(), base.data_ptr(),
                  x.data_ptr(), y.data_ptr(), n_brow, L, r, c, n_rows,
                  x.shape[-1], nb, window.tile_brows, window.width,
                  plan.cols_per_pass)
    if plan.path == "walk":
        bsr_window_matmat.walk_launches += 1
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
    return _gather("spmv_bsr", blocks, cols, x, n_rows)


def bsr_matmat(blocks, cols, X, n_rows):
    """:func:`bsr_matvec` for b columns given as the rows of ``X`` (b,
    n_cols); returns (b, n_rows).  Each block is read once for every
    :data:`MAX_COLS_PER_PASS` columns on 8 x 8 blocks (:func:`cols_per_pass`
    on other shapes), and every column gets the bits
    :func:`bsr_matvec` gives it.  8 x 8 blocks take the staged kernel
    (:func:`uses_gather8`; ``gather8_launches`` counts those launches)."""
    _rows("spmv_bsr_cols", X)
    return _gather("spmv_bsr_cols", blocks, cols, X, n_rows)


bsr_matmat.gather8_launches = 0


def bsr_window_matvec(blocks, window, x, n_rows):
    """BSR matvec through the window kernel (CUDA) or its plain version
    (CPU); ``window`` a :class:`BsrWindow` of the same operator."""
    _one("spmv_bsr_window", x)
    return _windowed("spmv_bsr_window", blocks, window, x, n_rows)


def bsr_window_matmat(blocks, window, X, n_rows):
    """:func:`bsr_window_matvec` for b columns given as the rows of ``X``
    (b, n_cols); returns (b, n_rows).  The launch is :func:`window_plan`'s:
    on 8 x 8 blocks the walk (``walk_launches`` counts those launches),
    which reads each block once for 8 columns; on other shapes passes of
    :func:`window_cols_per_pass` columns' staged windows.  Every column
    gets the bits the single-column kernel gives it."""
    _rows("spmv_bsr_window_cols", X)
    return _windowed("spmv_bsr_window_cols", blocks, window, X, n_rows)


bsr_window_matmat.walk_launches = 0
