"""Linear operators on one torch device.

Counterpart of ``arnoldi_tpu/linop.py`` for the formats the Krylov-Schur
drivers use:

* :class:`DenseOperator` -- ``torch.matmul``;
* :class:`BandedOperator` -- DIA storage for stencils, products through the
  DIA kernel (``ops/kernels/spmv_banded.py``);
* :class:`EllOperator` -- ELLPACK rows padded to the largest row degree,
  products through the ELL kernel (``ops/kernels/spmv_ell.py``);
* :class:`BsrOperator` -- dense r x c blocks stored ELL-style, products
  through the BSR gather or window kernel (``ops/kernels/spmv_bsr.py``).

Every operator has ``matvec(x)`` for x (n_cols,), ``matmat(X)`` for X
(n_cols, b) as in the JAX package, and ``matmat_rows(Xt)``, the same
product with the b columns given and returned as rows, (b, n_cols) ->
(b, n_rows): the layout of the block expansion's basis rows, which the
kernels' b-column forms read and write without a transpose.

Operators are frozen dataclasses holding tensors on one explicit device.
There is no ``backend=`` field: a CUDA tensor always goes through the
kernel, a CPU tensor through its plain PyTorch version.  The array layouts
are the JAX package's, built by the same NumPy code, so the same SciPy
matrix gives bit-identical operator arrays in both packages.
"""

import dataclasses

import numpy as np
import torch

from .device import numpy_dtype, torch_dtype
from .ops.kernels.spmv_banded import banded_matmat, banded_matvec
from .ops.kernels.spmv_bsr import (BsrWindow, bsr_matmat, bsr_matvec,
                                   bsr_window, bsr_window_matmat,
                                   bsr_window_matvec)
from .ops.kernels.spmv_ell import ell_matmat, ell_matvec

#: Routing rule of ``as_operator``: at most this many distinct diagonals
#: make a square sparse matrix banded (DIA), more make it ELL.
MAX_BANDED_DIAGONALS = 16


def _check_padded_layout(kind, padded_elems, stored_elems, L, degrees):
    """Refuse a padded layout whose zero-fill would dwarf the data (ELL
    pads every row to the largest row degree, so a few dense rows blow it
    up); same rule and message as the JAX package."""
    if padded_elems <= max(8 * max(stored_elems, 1), 1 << 24):
        return
    mean_deg = float(np.mean(degrees)) if len(degrees) else 0.0
    raise ValueError(
        f"{kind} layout would allocate {padded_elems:,} elements "
        f"({padded_elems * 4 / 1e9:.1f}+ GB) for {stored_elems:,} stored — "
        f"max row degree {L} vs mean {mean_deg:.1f}.  The padded "
        f"static-shape layout is built for bounded-degree sparsity; "
        "rebalance the matrix (e.g. random_scattered(edge='reflect')) or "
        "use a host/CSR path for this operator")


def _require_device(device, what):
    if device is None:
        raise ValueError(
            f"{what}: pass device= (e.g. 'cuda' or 'cpu'); host input has "
            "no device of its own")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class DenseOperator:
    """Dense matrix operator: ``matvec`` is one ``torch.matmul``."""

    A: torch.Tensor

    @property
    def shape(self):
        return tuple(self.A.shape)

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    @property
    def nnz(self):
        return self.A.shape[0] * self.A.shape[1]

    def matvec(self, x):
        return torch.matmul(self.A, x)

    def matmat(self, X):
        return torch.matmul(self.A, X)

    def matmat_rows(self, Xt):
        return torch.matmul(Xt, self.A.T)

    def to(self, device):
        return dataclasses.replace(self, A=self.A.to(device))


@dataclasses.dataclass(frozen=True)
class EllOperator:
    """ELLPACK operator: ``y[r] = sum_l data[r, l] * x[cols[r, l]]``.

    Rows are padded to the largest row degree with zero weights pointing at
    column 0.  ``nnz_stored`` counts true nonzeros; ``n_cols`` is the column
    count, 0 meaning square.
    """

    data: torch.Tensor  # (n_rows, L)
    cols: torch.Tensor  # (n_rows, L) int32
    nnz_stored: int
    n_cols: int = 0

    @property
    def shape(self):
        n = self.data.shape[0]
        return (n, self.n_cols or n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nnz(self):
        return self.nnz_stored

    def matvec(self, x):
        return ell_matvec(self.data, self.cols, x)

    def matmat(self, X):
        return _matmat_by_rows(self, X)

    def matmat_rows(self, Xt):
        return ell_matmat(self.data, self.cols, Xt)

    def to(self, device):
        return dataclasses.replace(self, data=self.data.to(device),
                                   cols=self.cols.to(device))

    @classmethod
    def from_scipy(cls, A, dtype=None, *, device):
        """Build from any SciPy sparse matrix (rectangular included)."""
        import scipy.sparse as sp

        device = _require_device(device, "EllOperator.from_scipy")
        A = sp.csr_matrix(A)
        if dtype is not None:
            A = A.astype(numpy_dtype(torch_dtype(dtype)))
        A.sum_duplicates()
        n = A.shape[0]
        degrees = np.diff(A.indptr)
        L = max(int(degrees.max(initial=0)), 1)
        _check_padded_layout("ELL", n * L, A.nnz, L, degrees)
        data = np.zeros((n, L), dtype=A.dtype)
        cols = np.zeros((n, L), dtype=np.int32)
        row_ids = np.repeat(np.arange(n), degrees)
        slot_ids = np.arange(A.nnz) - np.repeat(A.indptr[:-1], degrees)
        data[row_ids, slot_ids] = A.data
        cols[row_ids, slot_ids] = A.indices
        n_cols = 0 if A.shape[1] == n else int(A.shape[1])
        return cls(torch.from_numpy(data).to(device),
                   torch.from_numpy(cols).to(device), int(A.nnz),
                   n_cols=n_cols)


@dataclasses.dataclass(frozen=True)
class BandedOperator:
    """DIA operator for banded/stencil matrices.

    Convention: ``y[i] += bands[d][i] * x[i + offsets[d]]``; ``bands`` is
    zero where ``i + offsets[d]`` leaves the matrix.
    """

    bands: torch.Tensor  # (k, n)
    offsets: tuple
    nnz_stored: int

    @property
    def shape(self):
        n = self.bands.shape[1]
        return (n, n)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def device(self):
        return self.bands.device

    @property
    def nnz(self):
        return self.nnz_stored

    def matvec(self, x):
        return banded_matvec(self.bands, x, self.offsets)

    def matmat(self, X):
        return _matmat_by_rows(self, X)

    def matmat_rows(self, Xt):
        return banded_matmat(self.bands, Xt, self.offsets)

    def to(self, device):
        return dataclasses.replace(self, bands=self.bands.to(device))

    @classmethod
    def from_scipy(cls, A, dtype=None, *, device):
        import scipy.sparse as sp

        device = _require_device(device, "BandedOperator.from_scipy")
        if A.shape[0] != A.shape[1]:
            raise ValueError(
                "BandedOperator requires a square matrix; use the ELL "
                "format for rectangular sparse inputs")
        d = sp.dia_matrix(A)
        if dtype is not None:
            d = d.astype(numpy_dtype(torch_dtype(dtype)))
        n = d.shape[0]
        offsets = tuple(int(o) for o in d.offsets)
        bands = np.zeros((len(offsets), n), dtype=d.data.dtype)
        W = d.data.shape[1]
        for k, off in enumerate(offsets):
            # scipy DIA stores data[k, i] as the entry at column i of that
            # diagonal (A[i - off, i]); bands[k][r] = A[r, r + off].  scipy
            # may trim trailing all-zero columns, so clamp to its width.
            if off >= 0:
                m = min(n - off, max(W - off, 0))
                bands[k, :m] = d.data[k, off : off + m]
            else:
                m = min(n + off, W)
                bands[k, -off : -off + m] = d.data[k, :m]
        nnz = int(np.count_nonzero(bands))
        return cls(torch.from_numpy(bands).to(device), offsets, nnz)


@dataclasses.dataclass(frozen=True)
class BsrOperator:
    """Block-sparse-row operator: dense ``r x c`` blocks at sparse block
    positions, ``y_blk[i] = sum_l blocks[i, l] @ x_blk[block_cols[i, l]]``.

    Stored ELL-style with a fixed block budget per block-row (padding slots
    hold all-zero blocks at block-column 0); ``n_rows``/``n_cols`` are the
    true sizes before block padding.  ``window`` is the window kernel's
    layout (:func:`~arnoldi_tpu_torch.ops.kernels.spmv_bsr.bsr_window`),
    computed once from the host arrays when the operator is built
    (``from_scipy``, ``convert.operator_from_reference``).  The products
    take the window kernel when one column's window fits its shared-memory
    budget (``uses_window``) and the gather kernel otherwise.
    """

    blocks: torch.Tensor      # (n_brow, L, r, c)
    block_cols: torch.Tensor  # (n_brow, L) int32
    nnz_stored: int
    n_cols: int = 0
    n_rows: int = 0
    window: BsrWindow = dataclasses.field(kw_only=True)

    @property
    def shape(self):
        return (self.n_rows, self.n_cols)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def device(self):
        return self.blocks.device

    @property
    def nnz(self):
        return self.nnz_stored

    @property
    def blockshape(self):
        return tuple(self.blocks.shape[2:])

    @property
    def uses_window(self):
        """True when the products run the window kernel, False for the
        gather kernel: a fixed function of the window width, the block
        width and the dtype."""
        return self.window.fits(self.blocks.shape[3], self.dtype)

    def matvec(self, x):
        if self.uses_window:
            return bsr_window_matvec(self.blocks, self.window, x, self.n_rows)
        return bsr_matvec(self.blocks, self.block_cols, x, self.n_rows)

    def matmat(self, X):
        return _matmat_by_rows(self, X)

    def matmat_rows(self, Xt):
        if self.uses_window:
            return bsr_window_matmat(self.blocks, self.window, Xt, self.n_rows)
        return bsr_matmat(self.blocks, self.block_cols, Xt, self.n_rows)

    def to(self, device):
        return dataclasses.replace(self, blocks=self.blocks.to(device),
                                   block_cols=self.block_cols.to(device),
                                   window=self.window.to(device))

    @classmethod
    def from_scipy(cls, A, blocksize=(8, 8), dtype=None, *, device):
        """Build from any SciPy sparse matrix; rows and columns are padded
        to whole blocks."""
        import scipy.sparse as sp

        device = _require_device(device, "BsrOperator.from_scipy")
        r, c = blocksize
        n_rows, n_cols_true = A.shape
        pad_r = -(-n_rows // r) * r
        pad_c = -(-n_cols_true // c) * c
        coo = sp.coo_matrix(A)
        B = sp.coo_matrix(
            (coo.data, (coo.row, coo.col)), shape=(pad_r, pad_c)
        ).tobsr(blocksize=(r, c))
        if dtype is not None:
            B = B.astype(numpy_dtype(torch_dtype(dtype)))
        B.sum_duplicates()
        n_brow = B.indptr.shape[0] - 1
        degrees = np.diff(B.indptr)
        L = max(int(degrees.max(initial=0)), 1)
        _check_padded_layout("BSR", n_brow * L * r * c, B.data.size, L, degrees)
        blocks = np.zeros((n_brow, L, r, c), dtype=B.data.dtype)
        cols = np.zeros((n_brow, L), dtype=np.int32)
        row_ids = np.repeat(np.arange(n_brow), degrees)
        slot_ids = np.arange(B.indices.shape[0]) - np.repeat(B.indptr[:-1], degrees)
        blocks[row_ids, slot_ids] = B.data
        cols[row_ids, slot_ids] = B.indices
        nnz_true = int(np.count_nonzero(coo.data))
        return cls(torch.from_numpy(blocks).to(device),
                   torch.from_numpy(cols).to(device), nnz_true,
                   n_cols=int(A.shape[1]), n_rows=int(A.shape[0]),
                   window=bsr_window(blocks, cols, device=device))


def _matmat_by_rows(op, X):
    """``op @ X`` for X (n_cols, b), the JAX package's ``matmat``, through
    the rows form (one transpose copy each way)."""
    return op.matmat_rows(X.T.contiguous()).T.contiguous()


LinearOperator = (DenseOperator, EllOperator, BandedOperator, BsrOperator)


def cast_operator(op, dtype):
    """Cast an operator's value arrays to ``dtype`` (torch or NumPy dtype);
    the identity when already there."""
    dt = torch_dtype(dtype)
    if op.dtype == dt:
        return op
    if isinstance(op, BandedOperator):
        return dataclasses.replace(op, bands=op.bands.to(dt))
    if isinstance(op, EllOperator):
        return dataclasses.replace(op, data=op.data.to(dt))
    if isinstance(op, DenseOperator):
        return dataclasses.replace(op, A=op.A.to(dt))
    if isinstance(op, BsrOperator):
        return dataclasses.replace(op, blocks=op.blocks.to(dt))
    raise TypeError(f"cannot cast a {type(op).__name__} to {dtype}")


def as_operator(A, dtype=None, format=None, *, device=None):
    """Coerce ``A`` to an operator on one device.

    Accepts an operator of this package, a torch tensor, a NumPy array or
    any SciPy sparse matrix.  ``device=None`` keeps an operator's or
    tensor's own device; NumPy and SciPy input has none, so it needs
    ``device=`` and raises ``ValueError`` without it.  ``format`` forces
    'dense', 'ell', 'banded', 'bsr' (8 x 8 blocks) or ``("bsr", (r, c))``;
    by default a square sparse matrix with at most 16 distinct diagonals
    becomes DIA and any other sparse matrix ELL, the JAX package's routing
    off the TPU.
    """
    import scipy.sparse as sp

    if isinstance(A, LinearOperator):
        if format is not None:
            fmt = format[0] if isinstance(format, tuple) else format
            have = {DenseOperator: "dense", BandedOperator: "banded",
                    EllOperator: "ell", BsrOperator: "bsr"}[type(A)]
            if have != fmt:
                raise ValueError(
                    f"as_operator(format={format!r}) on an existing "
                    f"{type(A).__name__}: operators are not re-formatted — "
                    "build from the scipy/dense source instead")
        if device is not None and torch.device(device) != A.device:
            A = A.to(device)
        return A if dtype is None else cast_operator(A, dtype)
    if isinstance(A, torch.Tensor):
        if format not in (None, "dense"):
            raise ValueError(f"format={format!r} is not available for dense "
                             "input; convert to scipy.sparse first")
        A = A if device is None else A.to(device)
        return DenseOperator(A if dtype is None else A.to(torch_dtype(dtype)))
    if isinstance(A, np.ndarray):
        if format not in (None, "dense"):
            raise ValueError(f"format={format!r} is not available for dense "
                             "input; convert to scipy.sparse first")
        device = _require_device(device, "as_operator")
        arr = torch.from_numpy(np.ascontiguousarray(A))
        return DenseOperator(arr.to(device=device, dtype=(
            arr.dtype if dtype is None else torch_dtype(dtype))))
    if sp.issparse(A):
        device = _require_device(device, "as_operator")
        if format == "dense":
            return as_operator(np.asarray(A.todense()), dtype, device=device)
        if format == "banded":
            return BandedOperator.from_scipy(A, dtype, device=device)
        if format == "ell":
            return EllOperator.from_scipy(A, dtype, device=device)
        if format == "bsr" or (isinstance(format, tuple) and format[0] == "bsr"):
            bs = format[1] if isinstance(format, tuple) else (8, 8)
            return BsrOperator.from_scipy(A, blocksize=bs, dtype=dtype,
                                          device=device)
        if format is not None:
            raise ValueError(f"Unknown operator format {format!r}")
        if A.shape[0] != A.shape[1]:
            return EllOperator.from_scipy(A, dtype, device=device)
        coo = A.tocoo()
        n_diags = np.unique(coo.col.astype(np.int64) - coo.row).size
        if n_diags <= MAX_BANDED_DIAGONALS:
            return BandedOperator.from_scipy(A, dtype, device=device)
        return EllOperator.from_scipy(A, dtype, device=device)
    if callable(getattr(A, "matvec", None)):
        raise NotImplementedError(
            "callable and scipy LinearOperator inputs (CallableOperator) are "
            "not ported yet (ROADMAP.md, Queue 1 item 2)")
    raise TypeError(f"Cannot convert {type(A)} to a linear operator")
