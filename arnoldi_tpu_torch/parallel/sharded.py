"""Sharded operators and solves over a row mesh.

Counterpart of ``arnoldi_tpu/parallel/sharded.py``.  The JAX package
places the operator's row buffers and the basis row-sharded on a device
mesh and lets GSPMD insert an all-gather of ``x`` before the ELL gather;
the port builds each rank's row block of the operator once
(:func:`shard_operator`) and its matvec all-gathers ``x`` over the mesh
and runs the format's kernel on the block: the same communication, made
explicit.  The ring-halo operator (``halo_spmv.py``) replaces the
all-gather for banded and band-limited sparsity.

A sharded operator maps the rank's (n_local,) block of ``x`` to its block
of ``y``: its ``shape`` is the local ``(n_local, n_local)`` the solver
sees, ``n_global`` the padded global row count.
"""

import dataclasses

import torch

from ..linop import (BandedOperator, BsrOperator, CallableOperator,
                     DenseOperator, EllOperator, cast_operator)
from ..ops.kernels.spmv_banded import banded_matmat_ext, banded_matvec_ext
from ..ops.kernels.spmv_bsr import bsr_window
from .mesh import Mesh, local_rows, make_mesh


@dataclasses.dataclass(frozen=True)
class DiaRows:
    """Rows of a banded operator against a window of ``x``: row ``i`` of
    ``bands`` (k, rows) reads ``x[i + x_base + offsets[d]]`` (the
    ``spmv_dia_ext`` kernel).  ``x_base`` is the block's first global row
    against the whole vector, or the halo width against the extended
    window."""

    bands: torch.Tensor
    offsets: tuple
    x_base: int
    nnz_stored: int

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def device(self):
        return self.bands.device

    @property
    def nnz(self):
        return self.nnz_stored

    def matvec(self, x, row0=0, rows=None):
        return banded_matvec_ext(self.bands, x, self.offsets,
                                 x_base=self.x_base, row0=row0, rows=rows)

    def matmat_rows(self, Xt, row0=0, rows=None):
        return banded_matmat_ext(self.bands, Xt, self.offsets,
                                 x_base=self.x_base, row0=row0, rows=rows)

    def cast(self, dtype):
        return dataclasses.replace(self, bands=self.bands.to(dtype))


def row_granularity(op):
    """Rows a shard boundary must fall on: the block height of a BSR
    operator, 1 otherwise."""
    return op.blockshape[0] if isinstance(op, BsrOperator) else 1


def row_block(op, row0, row1, *, n_cols=None, col_map=None, device=None):
    """Rows ``[row0, row1)`` of a square format operator as a rectangular
    format operator over ``n_cols`` columns (default all), on ``device``.

    ``col_map`` (ELL, BSR) maps the block's stored column ids (block ids
    for BSR) to the columns of the block's ``x``, once, at build; a banded
    operator's rows read ``x`` through ``DiaRows.x_base`` instead (the
    caller sets it)."""
    device = op.device if device is None else torch.device(device)
    n = op.shape[0]
    n_cols = n if n_cols is None else int(n_cols)
    if isinstance(op, BandedOperator):
        bands = op.bands[:, row0:row1].contiguous().to(device)
        return DiaRows(bands, op.offsets, row0, int(torch.count_nonzero(bands)))
    if isinstance(op, DenseOperator):
        return DenseOperator(op.A[row0:row1].contiguous().to(device))
    if isinstance(op, EllOperator):
        data = op.data[row0:row1].contiguous().to(device)
        cols = op.cols[row0:row1].to(device)
        if col_map is not None:
            cols = col_map(cols.long()).int()
        return EllOperator(data, cols.contiguous(), int(torch.count_nonzero(data)),
                           n_cols=0 if n_cols == row1 - row0 else n_cols)
    if isinstance(op, BsrOperator):
        r, c = op.blockshape
        if row0 % r or row1 % r:
            raise ValueError(f"rows [{row0}, {row1}) do not fall on the block "
                             f"height {r}")
        blocks = op.blocks[row0 // r:row1 // r].contiguous()
        bcols = op.block_cols[row0 // r:row1 // r]
        if col_map is not None:
            bcols = col_map(bcols.long()).int()
        bcols = bcols.contiguous()
        nnz = int(torch.count_nonzero(blocks))
        window = bsr_window(blocks.cpu().numpy(), bcols.cpu().numpy(),
                            device=device)
        return BsrOperator(blocks.to(device), bcols.to(device), nnz,
                           n_cols=n_cols, n_rows=row1 - row0, window=window)
    raise TypeError(f"Cannot shard operator of type {type(op).__name__}")


class ShardedOperator:
    """This rank's row block of a format operator, applied by an
    all-gather of ``x`` over the mesh and the format's kernel on the block
    (the GSPMD path of the JAX package).  Built by :func:`shard_operator`."""

    sharded = True

    def __init__(self, local, mesh, n_global, nnz):
        self.local, self.mesh, self.n_global, self._nnz = (local, mesh,
                                                           n_global, nnz)
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
        """The kernel the block runs (for reports)."""
        return _kernel_name(self.local)

    def exchange_bytes(self, nb=1):
        """Bytes this rank receives in one product of ``nb`` columns."""
        return (self.mesh.size - 1) * self.n_local * nb * self.dtype.itemsize

    def matvec(self, x):
        return self.local.matvec(self.mesh.all_gather(x))

    def matmat_rows(self, Xt):
        return self.local.matmat_rows(self.mesh.all_gather(Xt))

    def matmat(self, X):
        return self.matmat_rows(X.T.contiguous()).T.contiguous()

    def cast(self, dtype):
        if self.dtype == dtype:
            return self
        return ShardedOperator(cast_operator(self.local, dtype), self.mesh,
                               self.n_global, self._nnz)


def _kernel_name(local):
    if isinstance(local, DiaRows):
        return "spmv_dia_ext"
    if isinstance(local, EllOperator):
        return "spmv_ell"
    if isinstance(local, BsrOperator):
        return "spmv_bsr_window" if local.uses_window else "spmv_bsr"
    return "torch.matmul"


def shard_operator(op, mesh):
    """This rank's row block of a square format operator (DIA, ELL, BSR or
    dense) whose row count the mesh divides, built once on the mesh's
    device; its products all-gather ``x``.  A sharded operator comes back
    as it is."""
    if getattr(op, "sharded", False):
        return op
    if isinstance(op, CallableOperator):
        raise TypeError(
            "a CallableOperator cannot be sharded: its closure maps the whole "
            "vector; give a format operator, or a HaloOperator")
    n = op.shape[0]
    if op.shape[1] != n:
        raise ValueError(f"need a square operator, got {op.shape}")
    row0, row1 = local_rows(n, mesh)
    gran = row_granularity(op)
    if (row1 - row0) % gran:
        raise ValueError(f"shards of {row1 - row0} rows do not fall on the "
                         f"block height {gran}; pad to a multiple of "
                         f"{mesh.size * gran}")
    local = row_block(op, row0, row1, device=mesh.device)
    return ShardedOperator(local, mesh, n, op.nnz)


def shard_workspace(Vt, H, mesh):
    """This rank's columns of the transposed basis ``Vt: (m+b, n)``, and
    ``H`` replicated (every rank holds it whole)."""
    row0, row1 = local_rows(Vt.shape[1], mesh)
    return Vt[:, row0:row1].contiguous().to(mesh.device), H.to(mesh.device)


def sharded_partial_schur(A, nev, *, mesh=None, n_devices=None, **kwargs):
    """:func:`arnoldi_tpu_torch.partial_schur` with the operator and the
    basis row-partitioned over ``mesh`` (default: :func:`make_mesh` over
    ``n_devices``, every rank of the default group).  Every rank calls it
    with the same arguments; each gets its rows of Q and the whole T."""
    from ..solvers.krylov_schur import partial_schur

    if mesh is None:
        mesh = make_mesh(n_devices)
    return partial_schur(A, nev, mesh=mesh, **kwargs)


def mesh_operator(A, mesh, device=None, dtype=None):
    """``(op, n, n_solve)`` of a solve of ``A`` under ``mesh``: ``A``
    built on the mesh's device (``device`` overrides it), padded to a
    multiple of ``size * row_granularity`` and sharded (:func:`shard_operator`,
    the all-gather path), or a sharded operator of this mesh as it is.
    ``n`` is the unpadded row count, ``n_solve`` the padded one.  ``dtype``
    is the dtype an integer ``A`` is built in."""
    from ..linop import as_operator, pad_operator

    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes an arnoldi_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    if getattr(A, "sharded", False):
        if (A.mesh.group, A.mesh.rank, A.mesh.size) != (mesh.group, mesh.rank,
                                                         mesh.size):
            raise ValueError("the operator is sharded over another mesh")
        return A, A.n_global, A.n_global
    op = as_operator(A, dtype=dtype, device=mesh.device if device is None
                     else device)
    n = op.shape[0]
    if op.shape[1] != n:
        raise ValueError(f"need a square operator, got {op.shape}")
    gran = mesh.size * row_granularity(op)
    n_solve = -(-n // gran) * gran
    return shard_operator(pad_operator(op, n_solve), mesh), n, n_solve


def valid_rows(Q, n, n_solve, mesh):
    """This rank's rows of the unpadded result: ``Q``'s block less the
    rows past ``n`` (the padding, all on the last ranks)."""
    row0, _ = local_rows(n_solve, mesh)
    return Q[:max(0, min(Q.shape[0], n - row0))]


def start_rows(v0, extra, n_solve, mesh):
    """The rank's columns of a start block: ``v0`` (n,) normalized over the
    whole vector, zero-padded to ``n_solve``, and the ``extra`` rows (b - 1,
    n_solve) or None; returns ``(b, n_local)``."""
    row0, row1 = local_rows(n_solve, mesh)
    v = torch.zeros(n_solve, dtype=v0.dtype, device=v0.device)
    v[:v0.shape[0]] = v0
    W = v[None, :] if extra is None else torch.cat([v[None, :], extra])
    return W[:, row0:row1].contiguous().to(mesh.device)


__all__ = ["DiaRows", "ShardedOperator", "mesh_operator", "row_block",
           "row_granularity", "shard_operator", "shard_workspace",
           "sharded_partial_schur", "start_rows", "valid_rows"]
