"""Ring-halo SpMV over a row mesh.

Counterpart of ``arnoldi_tpu/parallel/halo_spmv.py`` (its double-word
half is not ported: Hopper has float64).  The all-gather of ``x`` that the
sharded operator makes (``sharded.py``) moves the whole vector to every
rank; a banded or band-limited matrix needs only a halo of ``h`` rows from
each ring neighbour.  Each rank sends its first ``h`` entries to the
previous rank and its last ``h`` to the next (``Mesh.ring_start``: two
sends and two receives, the JAX package's two ``ppermute``s) and applies
its row block to the extended window ``[left halo | own block | right
halo]``.

The block's column ids are remapped into that window once, when the
operator is built (the JAX package remaps them inside every traced
matvec): ELL ids to ``col - row0 + h``, BSR block ids likewise in block
units, both clamped into the window (padding slots hold zeros); a banded
block reads the window through the ``spmv_dia_ext`` kernel's ``x_base``.

``overlap=True`` keeps the JAX package's structure: post the ring
exchange, run the whole block against the window with zero halos (no
dependence on the exchange; since the remapped block reads zeros outside
the shard, no second, masked copy of the data is needed), then wait, fill
the halo ends of the same buffer and recompute the first and last ``h``
rows.  ``overlap=False`` waits first and runs the block once.

At the global edges the ring wraps around; :class:`~..linop.BandedOperator`
stores zero band entries wherever ``i + offset`` leaves the matrix, and
ELL/BSR entries within the bandwidth never reach past it, so the wrapped
values are always multiplied by zero.
"""

import dataclasses

import numpy as np
import torch

from ..linop import BandedOperator, BsrOperator, EllOperator, cast_operator
from ..ops.kernels.spmv_bsr import bsr_matmat, bsr_matvec
from ..ops.kernels.spmv_ell import ell_matmat, ell_matvec
from .mesh import local_rows
from .sharded import DiaRows, _kernel_name, row_block


def sparsity_bandwidth(op):
    """Max |col - row| over stored entries: the halo a row partition
    needs (in rows for ELL and DIA, in block rows for BSR)."""
    if isinstance(op, EllOperator):
        cols = op.cols.cpu().numpy()
        rows = np.arange(cols.shape[0])[:, None]
        live = op.data.cpu().numpy() != 0
        return int(np.abs(np.where(live, cols - rows, 0)).max(initial=0))
    if isinstance(op, BsrOperator):
        bcols = op.block_cols.cpu().numpy()
        brows = np.arange(bcols.shape[0])[:, None]
        live = np.any(op.blocks.cpu().numpy() != 0, axis=(2, 3))
        return int(np.abs(np.where(live, bcols - brows, 0)).max(initial=0))
    if isinstance(op, BandedOperator):
        return int(max((abs(int(o)) for o in op.offsets), default=0))
    raise TypeError(type(op).__name__)


def _halo_product(full, part, x, mesh, h, edge, overlap):
    """``full(x_ext)`` over the window ``[left halo | x | right halo]`` (h
    entries each), with the exchange overlapped by a zero-halo pass and the
    ``edge`` first and last rows recomputed by ``part(x_ext, row0, rows)``
    when ``overlap``."""
    n_local = x.shape[-1]
    if h == 0:
        return full(x)
    ring = mesh.ring_start(x[..., :h], x[..., n_local - h:])
    x_ext = x.new_zeros((*x.shape[:-1], n_local + 2 * h))
    x_ext[..., h:h + n_local] = x

    def fill():
        left, right = ring.wait()
        x_ext[..., :h] = left
        x_ext[..., h + n_local:] = right

    if not overlap:
        fill()
        return full(x_ext)
    y = full(x_ext)
    fill()
    y[..., :edge] = part(x_ext, 0, edge)
    y[..., n_local - edge:] = part(x_ext, n_local - edge, edge)
    return y


def banded_matvec_halo(shard, x, mesh, overlap=True):
    """Ring-halo banded product of this rank's block ``shard`` (a
    :class:`~.sharded.DiaRows` whose ``x_base`` is the halo, max |offset|)
    with its block ``x`` of (n_local,) or (b, n_local); returns y like x."""
    h = int(max((abs(int(o)) for o in shard.offsets), default=0))
    if shard.x_base != h:
        raise ValueError(f"the block reads its window at x_base {shard.x_base}, "
                         f"not at the halo {h}")
    apply = shard.matmat_rows if x.ndim == 2 else shard.matvec
    return _halo_product(apply, apply, x, mesh, h, h, overlap)


def ell_matvec_halo(shard, x, mesh, halo, overlap=True):
    """Ring-halo ELL product of this rank's block ``shard`` (an
    :class:`~..linop.EllOperator` of n_local rows whose column ids address
    the window, n_local + 2 halo columns) with its block ``x``."""
    prod = ell_matmat if x.ndim == 2 else ell_matvec
    return _halo_product(
        shard.matmat_rows if x.ndim == 2 else shard.matvec,
        lambda xe, r0, rows: prod(shard.data[r0:r0 + rows],
                                  shard.cols[r0:r0 + rows], xe),
        x, mesh, halo, halo, overlap)


def bsr_matvec_halo(shard, x, mesh, halo_blocks, overlap=True):
    """Ring-halo BSR product of this rank's block ``shard`` (a
    :class:`~..linop.BsrOperator` of square blocks whose block ids address
    the window, nb_local + 2 halo_blocks block-columns) with its block
    ``x``; the fix-up rows run the gather kernel."""
    r, c = shard.blockshape
    prod = bsr_matmat if x.ndim == 2 else bsr_matvec

    def part(xe, r0, rows):
        return prod(shard.blocks[r0 // r:(r0 + rows) // r],
                    shard.block_cols[r0 // r:(r0 + rows) // r], xe, rows)

    return _halo_product(shard.matmat_rows if x.ndim == 2 else shard.matvec,
                         part, x, mesh, halo_blocks * c, halo_blocks * r,
                         overlap)


class HaloOperator:
    """This rank's row block of a banded, ELL or BSR operator, applied with
    the ring halo exchange (:func:`halo_matvec_closure` builds it).

    ``shape`` is the local ``(n_local, n_local)`` the solver sees,
    ``n_global`` the (padded) global size, ``halo`` the exchange width
    (rows; block rows for BSR).  ``fn_f64`` is the float64 product at the
    operator's own values: a refined float32 solve continues on it (the
    port's counterpart of ``matvec_dw``)."""

    def __init__(self, local, mesh, n_global, halo, nnz):
        self.local, self.mesh, self.n_global = local, mesh, n_global
        self.halo, self._nnz = halo, nnz
        self.n_local = n_global // mesh.size

    @property
    def shape(self):
        return (self.n_local, self.n_local)

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    @property
    def nnz(self):
        return self._nnz

    @property
    def kernel(self):
        """The kernel the block's full pass runs (for reports)."""
        return _kernel_name(self.local)

    def exchange_bytes(self, nb=1):
        """Bytes this rank sends (and receives) in one product of ``nb``
        columns: two halos."""
        width = self.halo * (self.local.blockshape[1]
                             if isinstance(self.local, BsrOperator) else 1)
        return 2 * width * nb * self.dtype.itemsize if self.mesh.size > 1 else 0

    def _apply(self, x):
        if isinstance(self.local, DiaRows):
            return banded_matvec_halo(self.local, x, self.mesh)
        if isinstance(self.local, EllOperator):
            return ell_matvec_halo(self.local, x, self.mesh, self.halo)
        return bsr_matvec_halo(self.local, x, self.mesh, self.halo)

    def matvec(self, x):
        return self._apply(x)

    def matmat_rows(self, Xt):
        return self._apply(Xt)

    def matmat(self, X):
        return self.matmat_rows(X.T.contiguous()).T.contiguous()

    def cast(self, dtype):
        if self.dtype == dtype:
            return self
        return HaloOperator(cast_operator(self.local, dtype), self.mesh,
                            self.n_global, self.halo, self._nnz)

    @property
    def fn_f64(self):
        return self.cast(torch.float64).matvec


def halo_matvec_closure(op, mesh):
    """Build this rank's :class:`HaloOperator` of a square banded, ELL or
    BSR operator (every rank passes the same one) whose row count the mesh
    divides (``pad_operator`` first; BSR: whole block rows, square
    blocks).  The halo is :func:`sparsity_bandwidth`, computed here once;
    it may not exceed a shard.  Its products overlap the exchange with the
    block's pass.  Raises ``TypeError`` for a format without a halo path
    (use ``shard_operator``'s all-gather)."""
    n = op.shape[0]
    if op.shape[1] != n:
        raise ValueError(f"need a square operator, got {op.shape}")
    row0, row1 = local_rows(n, mesh)
    n_local = row1 - row0
    if isinstance(op, BandedOperator):
        h = sparsity_bandwidth(op)
        local = dataclasses.replace(row_block(op, row0, row1, device=mesh.device),
                                    x_base=h)
    elif isinstance(op, EllOperator):
        h = sparsity_bandwidth(op)
        width = n_local + 2 * h
        local = row_block(op, row0, row1, n_cols=width, device=mesh.device,
                          col_map=lambda c: torch.clamp(c - row0 + h, 0, width - 1))
    elif isinstance(op, BsrOperator):
        r, c = op.blockshape
        if r != c or op.shape[0] != op.blocks.shape[0] * r:
            raise ValueError("the BSR halo path takes square blocks and a "
                             "square block grid (pad_operator to a multiple "
                             "of block * mesh size)")
        h = sparsity_bandwidth(op)
        b0, nbl = row0 // r, n_local // r
        width = nbl + 2 * h
        local = row_block(op, row0, row1, n_cols=width * c, device=mesh.device,
                          col_map=lambda bc: torch.clamp(bc - b0 + h, 0, width - 1))
        n_local = nbl
    else:
        raise TypeError(f"no halo path for {type(op).__name__}; use "
                        "shard_operator (the all-gather)")
    if h > n_local:
        raise ValueError(f"halo {h} exceeds the shard's {n_local} rows; use "
                         "fewer ranks or shard_operator (the all-gather)")
    return HaloOperator(local, mesh, n, h, op.nnz)


__all__ = ["HaloOperator", "banded_matvec_halo", "bsr_matvec_halo",
           "ell_matvec_halo", "halo_matvec_closure", "sparsity_bandwidth"]
