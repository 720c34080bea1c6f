"""The BSR window kernel's b-column form on the card (``csrc/spmv_bsr.cu``):
the walk against the staged gather kernel, the single-column (staged
window) kernel and the plain version, in every dtype.  Marked ``cuda``: each skips
without a card (the ``cuda_device`` fixture decides).  No JAX here, so the
file also runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_bsr_card.py
"""

import numpy as np
import pytest
import torch

from arnoldi_tpu_torch import as_operator, matrices
from arnoldi_tpu_torch.ops.kernels import spmv_bsr
from torch_parity import cuda_device  # noqa: F401 (fixture)

DTYPES = [torch.float64, torch.float32, torch.complex128, torch.complex64]
LIMIT = {torch.float64: 1e-12, torch.complex128: 1e-12, torch.float32: 1e-5,
         torch.complex64: 1e-5}


def _window_operator(dtype, device):
    """A banded matrix of 2^13 - 5 rows as BSR-8: 1024 block-rows, the last
    one cut short, 8 tiles of 128; complex dtypes get every off-diagonal
    value times e^{i phi} (seed 7)."""
    n = 2**13 - 5
    A = matrices.random_scattered(2**13, 24, seed=3, bandwidth=1024,
                                  block=8)[:n, :n].tocoo()
    if dtype.is_complex:
        rng = np.random.default_rng(7)
        A = A.astype(np.complex128)
        off = A.row != A.col
        A.data[off] *= np.exp(1j * rng.uniform(0, 2 * np.pi, int(off.sum())))
    op = as_operator(A.tocsr(), dtype=dtype, format=("bsr", (8, 8)), device=device)
    assert op.uses_window
    return op


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [2, 3, 4, 5, 8, 11])
def test_window_walk_bit_equal_on_the_card(b, dtype, cuda_device):
    """The window walk and the staged gather give the same bits, every
    column the single-column (staged window) kernel's, within the plain
    version's limit (1e-12, 1e-5 in single precision); X aligned and as a
    view one element in (value-by-value copies)."""
    op = _window_operator(dtype, cuda_device)
    blk, ids, win, nr = op.blocks, op.block_cols, op.window, op.n_rows
    gen = torch.Generator(device=cuda_device).manual_seed(b)
    for view in (False, True):
        buf = torch.randn(b * op.n_cols + view, generator=gen, device=cuda_device,
                          dtype=dtype)
        X = buf[int(view):].view(b, op.n_cols)
        walks = spmv_bsr.bsr_window_matmat.walk_launches
        Y = spmv_bsr.bsr_window_matmat(blk, win, X, nr)
        assert spmv_bsr.bsr_window_matmat.walk_launches == walks + 1
        want = spmv_bsr.bsr_window_matvec_plain(blk, win, X, nr)
        torch.cuda.synchronize()
        assert float((Y - want).norm() / want.norm()) <= LIMIT[dtype]
        assert torch.equal(Y, spmv_bsr.bsr_matmat(blk, ids, X, nr))
        for j in range(b):
            assert torch.equal(Y[j], spmv_bsr.bsr_window_matvec(
                blk, win, X[j].contiguous(), nr))
