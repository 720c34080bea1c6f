"""The DIA kernel on the card (``csrc/spmv_banded.cu``): bit-equalities
between its forms, and its agreement with the plain version where the
offsets lie far apart.  Marked ``cuda``: each skips without a card (the
``cuda_device`` fixture decides).  No JAX here, so the file also runs on
a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_spmv_card.py
"""

import pytest
import torch

from arnoldi_tpu_torch.ops.kernels import spmv_banded
from torch_parity import cuda_device  # noqa: F401 (fixture)


def _random_dia(n, offsets, b, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    bands = torch.randn(len(offsets), n, generator=gen, device=device, dtype=dtype)
    X = torch.randn((b, n) if b > 1 else n, generator=gen, device=device, dtype=dtype)
    return bands, X


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.complex128,
                                   torch.complex64])
@pytest.mark.parametrize("b", [2, 3, 8, 9, 297])
def test_dia_columns_bit_equal_single_on_the_card(b, dtype, cuda_device):
    """Each column of the b-column kernel is the single-column kernel's
    result bit for bit, on a row count that is no multiple of a tile or of
    a 16-byte vector (ragged ends, scalar band loads)."""
    offsets = (-201, -1, 0, 1, 201)
    for n in (40_000, 40_003):
        bands, X = _random_dia(n, offsets, b, dtype, cuda_device, seed=b)
        Y = spmv_banded.banded_matmat(bands, X, offsets)
        single = torch.stack([spmv_banded.banded_matvec(bands, X[j].contiguous(), offsets)
                              for j in range(b)])
        torch.cuda.synchronize()
        assert torch.equal(Y, single)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("b", [1, 8])
def test_dia_ext_base0_bit_equal_square_on_the_card(b, dtype, cuda_device):
    offsets = (-201, -1, 0, 1, 201)
    bands, X = _random_dia(40_003, offsets, b, dtype, cuda_device, seed=10 + b)
    square = (spmv_banded.banded_matmat if b > 1 else spmv_banded.banded_matvec)(
        bands, X, offsets)
    shard = (spmv_banded.banded_matmat_ext if b > 1 else spmv_banded.banded_matvec_ext)(
        bands, X, offsets, x_base=0)
    torch.cuda.synchronize()
    assert torch.equal(square, shard)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
@pytest.mark.parametrize("b", [1, 3])
def test_dia_wide_span_matches_plain_on_the_card(b, dtype, cuda_device):
    """Offsets far apart (+-n/2): the x reads of one row tile fall in three
    distant windows."""
    n = 40_000
    offsets = (-n // 2, -1, 0, 1, n // 2)
    bands, X = _random_dia(n, offsets, b, dtype, cuda_device, seed=20 + b)
    got = (spmv_banded.banded_matmat if b > 1 else spmv_banded.banded_matvec)(
        bands, X, offsets)
    want = spmv_banded.banded_matvec_plain(bands.cpu(), X.cpu(), offsets)
    assert float((got.cpu() - want).norm() / want.norm()) <= 1e-12


@pytest.mark.cuda
def test_dia_rejects_more_than_16_offsets_on_the_card(cuda_device):
    bands = torch.ones(17, 100, dtype=torch.float64, device=cuda_device)
    x = torch.ones(100, dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError, match="at most 16"):
        spmv_banded.banded_matvec(bands, x, tuple(range(-8, 9)))
