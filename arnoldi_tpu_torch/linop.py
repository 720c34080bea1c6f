"""Linear operators on one torch device.

Counterpart of ``arnoldi_tpu/linop.py`` for the formats the Krylov-Schur
drivers use:

* :class:`DenseOperator` -- ``torch.matmul``;
* :class:`BandedOperator` -- DIA storage for stencils, products through the
  DIA kernel (``ops/kernels/spmv_banded.py``);
* :class:`EllOperator` -- ELLPACK rows padded to the largest row degree,
  products through the ELL kernel (``ops/kernels/spmv_ell.py``);
* :class:`BsrOperator` -- dense r x c blocks stored ELL-style, products
  through the BSR gather or window kernel (``ops/kernels/spmv_bsr.py``);
* :class:`CallableOperator` -- a user matvec closure (and SciPy
  ``LinearOperator`` input, wrapped by :func:`as_operator`);
* :class:`GramOperator` -- ``A^H A`` or ``A A^H`` over a format operator,
  applied as two products.

Every operator has ``matvec(x)`` for x (n_cols,), ``matmat(X)`` for X
(n_cols, b) as in the JAX package, and ``matmat_rows(Xt)``, the same
product with the b columns given and returned as rows, (b, n_cols) ->
(b, n_rows): the layout of the block expansion's basis rows, which the
kernels' b-column forms read and write without a transpose.
:func:`rmatvec` and :func:`rmatmat` apply the adjoint of a format
operator; :func:`pad_operator` pads one to ``diag(A, 0)``.

Values may be float32, float64, complex64 or complex128, in every format.
The format operators are frozen
dataclasses holding tensors on one explicit device.  There is no
``backend=`` field: a CUDA tensor always goes through the kernel, a CPU
tensor through its plain PyTorch version.  The
array layouts are the JAX package's, built by the same NumPy code, so the
same SciPy matrix gives bit-identical operator arrays in both packages.
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


#: The padded layouts' budget, the JAX package's rule: at most
#: ``_PADDED_FILL`` times the stored elements, or ``_PADDED_FLOOR``
#: elements, whichever is larger.
_PADDED_FILL = 8
_PADDED_FLOOR = 1 << 24


def _padded_budget(stored_elems):
    return max(_PADDED_FILL * max(stored_elems, 1), _PADDED_FLOOR)


def _check_padded_layout(kind, padded_elems, stored_elems, L, degrees):
    """Refuse a padded layout whose zero-fill would dwarf the data (ELL
    pads every row to the largest row degree, so a few dense rows blow it
    up); same rule and message as the JAX package."""
    if padded_elems <= _padded_budget(stored_elems):
        return
    mean_deg = float(np.mean(degrees)) if len(degrees) else 0.0
    raise ValueError(
        f"{kind} layout would allocate {padded_elems:,} elements "
        f"({padded_elems * 4 / 1e9:.1f}+ GB) for {stored_elems:,} stored — "
        f"max row degree {L} vs mean {mean_deg:.1f}.  The padded "
        f"static-shape layout is built for bounded-degree sparsity; "
        "rebalance the matrix (e.g. random_scattered(edge='reflect')) or "
        "use a host/CSR path for this operator")


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to arnoldi_tpu_torch yet (ROADMAP.md, {item})")


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
    #: the materialized adjoint (:func:`adjoint_operator`), built on first
    #: use; a cast or a move starts empty
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

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
    #: the materialized adjoint (:func:`adjoint_operator`), built on first
    #: use; a cast or a move starts empty
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

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
    #: the materialized adjoint (:func:`adjoint_operator`), built on first
    #: use; a cast or a move starts empty
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False, compare=False)

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


#: The operators that store their matrix: casts, pads, adjoints and the
#: float64 continuation of a refined solve take their values as they are.
FORMAT_OPERATORS = (DenseOperator, EllOperator, BandedOperator, BsrOperator)
_SPARSE_OPERATORS = (EllOperator, BandedOperator, BsrOperator)


class CallableOperator:
    """An operator given by its matvec closure ``fn``: a (n_cols,) tensor on
    the operator's device to a (n_rows,) tensor there, in ``dtype``.

    ``fn_f64``, when given, is the same product in float64: the port's
    counterpart of the JAX package's double-word ``fn_dw``
    (``arnoldi_tpu/linop.py:379-407``).  A refined float32 solve
    (``partial_schur``/``partial_eigh``, ``refine=``) continues on it, and
    ``refine="auto"`` refines a callable only when it has one.

    ``matmat`` and ``matmat_rows`` call ``fn`` once a column (no
    ``torch.vmap``: a closure that launches kernels through ctypes cannot be
    vmapped), so the block driver calls it b times a step: correct, and
    slow.  ``device`` defaults to the card.
    """

    def __init__(self, fn, shape, dtype, nnz=None, fn_f64=None, *,
                 device="cuda"):
        self.fn = fn
        self.fn_f64 = fn_f64
        self._shape = tuple(int(s) for s in shape)
        self._dtype = torch_dtype(dtype)
        self._nnz = int(nnz) if nnz is not None else self._shape[0] * self._shape[1]
        self._device = torch.device(device)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    @property
    def device(self):
        return self._device

    @property
    def nnz(self):
        return self._nnz

    def matvec(self, x):
        return self.fn(x)

    def matmat(self, X):
        return torch.stack([self.fn(X[:, i].contiguous())
                            for i in range(X.shape[1])], dim=1)

    def matmat_rows(self, Xt):
        return torch.stack([self.fn(x) for x in Xt])

    def to(self, device):
        """This operator, when ``device`` is its own: a closure cannot be
        moved."""
        if torch.device(device) != self.device:
            raise ValueError(f"a CallableOperator on {self.device} cannot move "
                             f"to {device}; wrap a closure for that device")
        return self


def _scipy_operator(A, dtype, device):
    """A SciPy ``LinearOperator`` as a :class:`CallableOperator` whose
    matvec copies x to the host, calls ``A.matvec`` and copies the result
    back to x's device in x's dtype."""
    device = _require_device(device, "as_operator")
    op_dtype = torch_dtype(dtype if dtype is not None else (
        A.dtype if A.dtype is not None else np.float64))

    def fn(x):
        y = np.asarray(A.matvec(x.cpu().numpy())).reshape(-1)
        return torch.from_numpy(y).to(device=x.device, dtype=x.dtype)

    return CallableOperator(fn, A.shape, op_dtype, device=device)


# -- adjoint products ------------------------------------------------------

def _adjoint_scatter(op, Y):
    """``A^H Y`` for Y (n_rows, b) by scatter-adds (``index_add_``), as the
    JAX package's ``rmatvec`` computes it (``arnoldi_tpu/linop.py:427-461``):
    the plain version of the adjoint products."""
    b = Y.shape[1]
    n_rows, n_cols = op.shape
    if isinstance(op, EllOperator):
        contrib = op.data.conj()[:, :, None] * Y[:, None, :]
        out = contrib.new_zeros((n_cols, b))
        return out.index_add_(0, op.cols.reshape(-1).long(),
                              contrib.reshape(-1, b))
    if isinstance(op, BsrOperator):
        r, c = op.blockshape
        n_brow = op.blocks.shape[0]
        Yp = Y.new_zeros((n_brow * r, b))
        Yp[:n_rows] = Y
        contrib = torch.einsum("blrc,brk->blck", op.blocks.conj(),
                               Yp.reshape(n_brow, r, b))
        out = contrib.new_zeros((-(-n_cols // c), c, b))
        out.index_add_(0, op.block_cols.reshape(-1).long(),
                       contrib.reshape(-1, c, b))
        return out.reshape(-1, b)[:n_cols]
    if isinstance(op, BandedOperator):
        out = Y.new_zeros((n_rows, b))
        for d, off in enumerate(op.offsets):
            prod = op.bands[d].conj()[:, None] * Y
            if off == 0:
                out += prod
            elif off > 0:
                out[off:] += prod[:-off]
            else:
                out[:off] += prod[-off:]
        return out
    raise TypeError(f"no adjoint for {type(op).__name__}")


def _ell_slots(keys, n_keys):
    """ELL placement of entries with row ids ``keys`` (already in the order
    each row should sum them): ``(order, row, slot, degrees, L)``."""
    order = torch.sort(keys, stable=True).indices
    keys = keys[order]
    degrees = torch.bincount(keys, minlength=n_keys)
    L = max(int(degrees.max()) if n_keys else 0, 1)
    starts = torch.cumsum(degrees, 0) - degrees
    slot = torch.arange(keys.numel(), device=keys.device) - starts[keys]
    return order, keys, slot, degrees, L


def _split_cap(degrees, n_keys, unit, stored_elems):
    """The largest slot count ``L_cap`` for which the rows longer than it,
    each split into ``ceil(d / L_cap)`` virtual rows of ``L_cap`` slots,
    give a padded layout (``(n_keys + extra rows) * L_cap * unit``
    elements) within the budget of :func:`_check_padded_layout`; 0 when
    none does.  Every ``L_cap`` up to ``(budget - stored) / (n_keys *
    unit)`` fits (the split adds fewer slots than the rows hold), and none
    above ``budget / (n_keys * unit)``, so only the range between is
    searched."""
    budget = _padded_budget(stored_elems)
    deg = np.sort(np.asarray(degrees, dtype=np.int64))      # ascending
    per_slot = max(n_keys, 1) * unit
    sure = max((budget - stored_elems) // per_slot, 0)
    for cap in range(min(int(deg[-1]) if deg.size else 0, budget // per_slot),
                     sure, -1):
        long = deg[np.searchsorted(deg, cap, side="right"):]
        extra = int((-(-long // cap) - 1).sum())
        if (n_keys + extra) * cap * unit <= budget:
            return cap
    return sure


def _split_rows(keys, slot, degrees, n_keys, cap):
    """Split each row of more than ``cap`` slots into virtual rows of
    ``cap``: the first ``cap`` entries keep their row, each further ``cap``
    go to a virtual row ``n_keys + e`` (a row's extra rows consecutive, the
    rows in order).  Returns ``(vrow, vslot, n_virtual, hub, extra_idx)``:
    ``hub`` the split rows and ``extra_idx`` (n_hub, k_max) their extra
    rows' ids less ``n_keys``, padded with ``n_virtual - n_keys`` (the id
    of an appended zero row)."""
    extra = torch.clamp(-(-degrees // cap) - 1, min=0)
    base = torch.cumsum(extra, 0) - extra
    n_extra = int(extra.sum())
    vrow = torch.where(slot < cap, keys, n_keys + base[keys] + slot // cap - 1)
    hub = torch.nonzero(extra).reshape(-1)
    k_max = int(extra.max()) if hub.numel() else 0
    k = torch.arange(k_max, device=keys.device)
    extra_idx = torch.where(k[None, :] < extra[hub][:, None],
                            base[hub][:, None] + k[None, :], n_extra)
    return vrow, slot % cap, n_keys + n_extra, hub, extra_idx


class SplitRowsOperator:
    """A format operator whose overlong rows were split into virtual rows,
    folded back after each product: the materialized adjoint of a matrix
    with a few much fuller columns (hub columns), which have no padded
    layout as rows of ``A^H``.

    ``inner`` holds ``n_keys + extra`` (block) rows of at most ``L_cap``
    slots; a product runs the format's kernel over all of them, then each
    split row adds the sum of its extra rows, gathered into an ``(n_hub,
    k_max)`` zero-padded view and summed along it: a fixed order and no
    atomic adds, so two calls give equal bits.  ``unit`` is the rows a key
    stands for (the block height of a BSR ``inner``, 1 for ELL) and
    ``n_rows`` the true row count.
    """

    def __init__(self, inner, n_keys, unit, n_rows, hub, extra_idx):
        self.inner, self.n_keys, self.unit, self.n_rows = (
            inner, n_keys, unit, n_rows)
        self.hub, self.extra_idx = hub, extra_idx

    @property
    def shape(self):
        return (self.n_rows, self.inner.shape[1])

    @property
    def dtype(self):
        return self.inner.dtype

    @property
    def device(self):
        return self.inner.device

    @property
    def nnz(self):
        return self.inner.nnz

    def _fold(self, Yv):
        b, u, nk = Yv.shape[0], self.unit, self.n_keys
        Yv = Yv.reshape(b, -1, u)
        Y = Yv[:, :nk].clone()
        ext = torch.cat([Yv[:, nk:], Yv.new_zeros((b, 1, u))], dim=1)
        Y[:, self.hub] += ext[:, self.extra_idx].sum(dim=2)
        return Y.reshape(b, nk * u)[:, :self.n_rows]

    def matvec(self, x):
        return self._fold(self.inner.matvec(x)[None])[0]

    def matmat(self, X):
        return _matmat_by_rows(self, X)

    def matmat_rows(self, Xt):
        return self._fold(self.inner.matmat_rows(Xt)).contiguous()


def _transpose_ell(op):
    n_rows, L = op.data.shape
    n_cols = op.shape[1]
    data = op.data.reshape(-1)
    keep = data != 0                     # padding slots point at column 0
    rows = torch.arange(n_rows, device=op.device).repeat_interleave(L)[keep]
    order, cols, slot, degrees, LT = _ell_slots(
        op.cols.reshape(-1)[keep].long(), n_cols)
    stored = int(keep.sum())
    deg_host = degrees.cpu().numpy()
    if n_cols * LT <= _padded_budget(stored):
        dataT = op.data.new_zeros((n_cols, LT))
        colsT = torch.zeros((n_cols, LT), dtype=torch.int32, device=op.device)
        dataT[cols, slot] = data[keep][order].conj()
        colsT[cols, slot] = rows[order].int()
        return EllOperator(dataT, colsT, op.nnz_stored,
                           n_cols=0 if n_cols == n_rows else n_rows)
    cap = _split_cap(deg_host, n_cols, 1, stored)
    if cap == 0:
        _check_padded_layout("ELL", n_cols * LT, stored, LT, deg_host)
    vrow, vslot, n_virtual, hub, extra_idx = _split_rows(cols, slot, degrees,
                                                         n_cols, cap)
    dataT = op.data.new_zeros((n_virtual, cap))
    colsT = torch.zeros((n_virtual, cap), dtype=torch.int32, device=op.device)
    dataT[vrow, vslot] = data[keep][order].conj()
    colsT[vrow, vslot] = rows[order].int()
    return SplitRowsOperator(EllOperator(dataT, colsT, op.nnz_stored,
                                         n_cols=n_rows),
                             n_cols, 1, n_cols, hub, extra_idx)


def _transpose_banded(op):
    # A[r, r + off] = bands[d][r], so A^H[c, c - off] = bands[d][c - off].
    n = op.shape[0]
    bandsT = torch.zeros_like(op.bands)
    for d, off in enumerate(op.offsets):
        if off >= 0:
            bandsT[d, off:] = op.bands[d, :n - off].conj()
        else:
            bandsT[d, :n + off] = op.bands[d, -off:].conj()
    return BandedOperator(bandsT, tuple(-o for o in op.offsets),
                          op.nnz_stored)


def _transpose_bsr(op):
    n_brow, L, r, c = op.blocks.shape
    n_bcol = -(-op.shape[1] // c)
    blocks = op.blocks.reshape(n_brow * L, r, c)
    keep = blocks.reshape(n_brow * L, -1).ne(0).any(dim=1)   # drops padding
    brows = torch.arange(n_brow, device=op.device).repeat_interleave(L)[keep]
    order, bcols, slot, degrees, LT = _ell_slots(
        op.block_cols.reshape(-1)[keep].long(), n_bcol)
    stored = int(keep.sum()) * r * c
    deg_host = degrees.cpu().numpy()
    split = n_bcol * LT * r * c > _padded_budget(stored)
    if split:
        cap = _split_cap(deg_host, n_bcol, r * c, stored)
        if cap == 0:
            _check_padded_layout("BSR", n_bcol * LT * r * c, stored, LT, deg_host)
        bcols, slot, n_virtual, hub, extra_idx = _split_rows(
            bcols, slot, degrees, n_bcol, cap)
        LT = cap
    else:
        n_virtual = n_bcol
    blocksT = op.blocks.new_zeros((n_virtual, LT, c, r))
    colsT = torch.zeros((n_virtual, LT), dtype=torch.int32, device=op.device)
    blocksT[bcols, slot] = blocks[keep][order].mT.conj()
    colsT[bcols, slot] = brows[order].int()
    window = bsr_window(blocksT.cpu().numpy(), colsT.cpu().numpy(),
                        device=op.device)
    if not split:
        return BsrOperator(blocksT, colsT, op.nnz_stored, n_cols=op.n_rows,
                           n_rows=op.n_cols, window=window)
    inner = BsrOperator(blocksT, colsT, op.nnz_stored, n_cols=op.n_rows,
                        n_rows=n_virtual * c, window=window)
    return SplitRowsOperator(inner, n_bcol, c, op.n_cols, hub, extra_idx)


def adjoint_operator(op):
    """``A^H`` of a sparse format operator as an operator of the same format,
    built on ``op``'s device from its own arrays (padding slots dropped,
    each row's entries in ascending column order) and cached on ``op``.

    Its products are the format's kernels, with their fixed reduction
    order: no atomic adds, so two calls give equal bits.  When a few much
    fuller columns of A (dense rows of A^H) would break the padded layout's
    budget, the overlong rows are split and folded back
    (:class:`SplitRowsOperator`); a matrix whose transpose fits keeps its
    plain layout.  Raises ``ValueError`` only when no split fits either."""
    if not isinstance(op, _SPARSE_OPERATORS):
        raise TypeError(f"no materialized adjoint for {type(op).__name__}")
    adj = op._cache.get("adjoint")
    if adj is None:
        transpose = {EllOperator: _transpose_ell, BandedOperator:
                     _transpose_banded, BsrOperator: _transpose_bsr}[type(op)]
        adj = op._cache["adjoint"] = transpose(op)
    return adj


def _adjoint_route(op, x, transposed):
    """True when an adjoint product of a sparse ``op`` runs on its
    materialized transpose: on a CUDA tensor (the kernels), or when
    ``transposed`` asks for it; False for the scatter-adds of the plain
    version, and for a dense ``op`` (one matmul either way)."""
    if isinstance(op, DenseOperator):
        return False
    if not isinstance(op, _SPARSE_OPERATORS):
        raise TypeError(
            f"adjoint matvec not implemented for {type(op).__name__}; wrap A "
            "with a CallableOperator providing the Gram matvec directly")
    return x.is_cuda if transposed is None else bool(transposed)


def rmatvec(op, y, *, _transposed=None):
    """``A^H y`` for a format operator.  Dense: one ``torch.matmul``.
    Sparse: on a CUDA tensor the materialized transpose
    (:func:`adjoint_operator`) through the format's kernel, on a CPU tensor
    the scatter-adds of the JAX package.  ``_transposed`` (private, for
    tests) forces one route."""
    if _adjoint_route(op, y, _transposed):
        return adjoint_operator(op).matvec(y)
    if isinstance(op, DenseOperator):
        return torch.matmul(op.A.mH, y)
    return _adjoint_scatter(op, y[:, None])[:, 0]


def rmatmat(op, Y, *, _transposed=None):
    """``A^H Y`` for Y (n_rows, b), by the route :func:`rmatvec` takes."""
    if _adjoint_route(op, Y, _transposed):
        return adjoint_operator(op).matmat(Y)
    if isinstance(op, DenseOperator):
        return torch.matmul(op.A.mH, Y)
    return _adjoint_scatter(op, Y)


def _rmatmat_rows(op, Zt):
    """``A^H`` applied to the b rows of ``Zt`` (b, n_rows) -> (b, n_cols)."""
    if _adjoint_route(op, Zt, None):
        return adjoint_operator(op).matmat_rows(Zt)
    return rmatmat(op, Zt.T).T.contiguous()


class GramOperator:
    """``A^H A`` (or ``A A^H`` when ``transposed``) over a format operator
    ``op``, applied as two products and never formed.

    ``opT``, when given, is a materialized ``A^H`` operator (built by
    ``solvers.svd.gram_companions`` from the host source); without it the
    adjoint leg is :func:`rmatvec` (on the card: ``op``'s cached transpose).
    ``matmat``/``matmat_rows`` run the legs' b-column kernels.
    """

    def __init__(self, op, opT=None, *, transposed=False, nnz=None):
        self.op = op
        self.opT = opT
        self.transposed = bool(transposed)
        self._nnz = int(nnz) if nnz is not None else op.nnz

    @property
    def shape(self):
        d = self.op.shape[0] if self.transposed else self.op.shape[1]
        return (d, d)

    @property
    def dtype(self):
        return self.op.dtype

    @property
    def device(self):
        return self.op.device

    @property
    def nnz(self):
        return self._nnz

    @property
    def has_dw(self):
        """True when both legs are format operators, so a refined solve can
        continue on them in float64 (named as the JAX package's property
        for its double-word legs)."""
        return isinstance(self.op, FORMAT_OPERATORS) and (
            self.opT is None or isinstance(self.opT, FORMAT_OPERATORS))

    def _adjoint(self, z):
        return self.opT.matvec(z) if self.opT is not None else rmatvec(self.op, z)

    def _adjoint_rows(self, Zt):
        return (self.opT.matmat_rows(Zt) if self.opT is not None
                else _rmatmat_rows(self.op, Zt))

    def matvec(self, x):
        if self.transposed:          # A A^H
            return self.op.matvec(self._adjoint(x))
        return self._adjoint(self.op.matvec(x))

    def matmat(self, X):
        return _matmat_by_rows(self, X)

    def matmat_rows(self, Xt):
        if self.transposed:
            return self.op.matmat_rows(self._adjoint_rows(Xt))
        return self._adjoint_rows(self.op.matmat_rows(Xt))

    def to(self, device):
        return GramOperator(self.op.to(device),
                            None if self.opT is None else self.opT.to(device),
                            transposed=self.transposed, nnz=self._nnz)


LinearOperator = FORMAT_OPERATORS + (CallableOperator, GramOperator)


def pad_operator(op, n_pad):
    """Zero-pad a square format operator to ``n_pad`` rows and columns.

    The padded operator acts as ``diag(A, 0)``: a Krylov process started
    from a vector with zero padding keeps the padding zero and builds the
    same H as the unpadded problem.  BSR pads whole block-rows (``n_pad`` a
    multiple of the block height) and rebuilds its window layout."""
    n = op.shape[0]
    if n_pad == n:
        return op
    if n_pad < n:
        raise ValueError(f"pad_operator: n_pad={n_pad} < n={n}")
    extra = n_pad - n
    if isinstance(op, EllOperator):
        if op.shape[0] != op.shape[1]:
            raise ValueError("pad_operator expects a square operator")
        pad = torch.nn.functional.pad
        return EllOperator(pad(op.data, (0, 0, 0, extra)),
                           pad(op.cols, (0, 0, 0, extra)), op.nnz_stored)
    if isinstance(op, DenseOperator):
        return DenseOperator(torch.nn.functional.pad(op.A, (0, extra, 0, extra)))
    if isinstance(op, BandedOperator):
        return BandedOperator(torch.nn.functional.pad(op.bands, (0, extra)),
                              op.offsets, op.nnz_stored)
    if isinstance(op, BsrOperator):
        r, _ = op.blockshape
        if n_pad % r:
            raise ValueError(f"pad_operator: n_pad={n_pad} is not a multiple "
                             f"of the block height {r}")
        extra_brows = n_pad // r - op.blocks.shape[0]
        blocks = torch.nn.functional.pad(op.blocks,
                                         (0, 0, 0, 0, 0, 0, 0, extra_brows))
        cols = torch.nn.functional.pad(op.block_cols, (0, 0, 0, extra_brows))
        return BsrOperator(blocks, cols, op.nnz_stored, n_cols=n_pad,
                           n_rows=n_pad,
                           window=bsr_window(blocks.cpu().numpy(),
                                             cols.cpu().numpy(),
                                             device=op.device))
    raise TypeError(f"Cannot pad operator of type {type(op)}")


def cast_operator(op, dtype):
    """Cast an operator's value arrays to ``dtype`` (torch or NumPy dtype);
    the identity when already there.  A Gram casts both legs, an operator
    with a ``cast(dtype)`` method casts itself; a
    :class:`CallableOperator` cannot be cast (its closure owns the dtype)."""
    dt = torch_dtype(dtype)
    if op.dtype == dt:
        return op
    if hasattr(op, "cast"):
        return op.cast(dt)
    if isinstance(op, BandedOperator):
        return dataclasses.replace(op, bands=op.bands.to(dt))
    if isinstance(op, EllOperator):
        return dataclasses.replace(op, data=op.data.to(dt))
    if isinstance(op, DenseOperator):
        return dataclasses.replace(op, A=op.A.to(dt))
    if isinstance(op, BsrOperator):
        return dataclasses.replace(op, blocks=op.blocks.to(dt))
    if isinstance(op, GramOperator):
        return GramOperator(cast_operator(op.op, dt),
                            None if op.opT is None else cast_operator(op.opT, dt),
                            transposed=op.transposed, nnz=op.nnz)
    raise TypeError(
        f"cannot cast a {type(op).__name__} (dtype {op.dtype}) to {dtype}; "
        "wrap a new closure at the wanted dtype instead")


def as_operator(A, dtype=None, format=None, *, device=None):
    """Coerce ``A`` to an operator on one device.

    Accepts an operator of this package, a torch tensor, a NumPy array,
    any SciPy sparse matrix or a SciPy ``LinearOperator`` (wrapped as a
    :class:`CallableOperator` whose matvec runs on the host).
    ``device=None`` keeps an operator's or tensor's own device; NumPy and
    SciPy input has none, so it needs ``device=`` and raises ``ValueError``
    without it.  ``format`` forces
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
                    EllOperator: "ell", BsrOperator: "bsr"}.get(type(A))
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
    from scipy.sparse.linalg import LinearOperator as ScipyLinearOperator

    if isinstance(A, ScipyLinearOperator):
        return _scipy_operator(A, dtype, device)
    raise TypeError(f"Cannot convert {type(A)} to a linear operator")
