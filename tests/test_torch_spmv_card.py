"""The DIA and ELL kernels on the card (``csrc/spmv_banded.cu``,
``csrc/spmv_ell.cu``): bit-equalities between their forms, and their
agreement with the plain versions.  Marked ``cuda``: each skips without a card (the
``cuda_device`` fixture decides).  No JAX here, so the file also runs on
a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_spmv_card.py
"""

import pytest
import torch

from arnoldi_tpu_torch.ops.kernels import spmv_banded, spmv_ell
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


ELL_DTYPES = [torch.float64, torch.float32, torch.complex128, torch.complex64]
ELL_WIDTHS = [2, 3, 8, 9, 64, 67, 327]


def _ell_columns_bit_equal(data, cols, n_cols, b, dtype, seed):
    """Every column of ``ell_matmat`` against ``ell_matvec`` bit for bit,
    and the product against the plain version."""
    gen = torch.Generator(device=data.device).manual_seed(seed)
    X = torch.randn(b, n_cols, generator=gen, device=data.device, dtype=dtype)
    Y = spmv_ell.ell_matmat(data, cols, X)
    single = torch.stack([spmv_ell.ell_matvec(data, cols, X[j].contiguous())
                          for j in range(b)])
    want = torch.cat([spmv_ell.ell_matvec_plain(data, cols, X[j:j + 16])
                      for j in range(0, b, 16)])
    torch.cuda.synchronize()
    assert torch.equal(Y, single)
    limit = 1e-12 if dtype in (torch.float64, torch.complex128) else 1e-5
    assert float((Y - want).norm() / want.norm()) <= limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ELL_DTYPES)
@pytest.mark.parametrize("L", [7, 25, 33, 129])   # staged paths, then a warp a row
@pytest.mark.parametrize("b", ELL_WIDTHS)
def test_ell_columns_bit_equal_single_on_the_card(b, L, dtype, cuda_device):
    """Each column of the b-column kernel is the single-column kernel's
    result bit for bit on a rectangular operator whose row count is no
    multiple of a tile (ragged tail tile, ragged column group)."""
    n_rows, n_cols = 20_003, 30_001
    gen = torch.Generator(device=cuda_device).manual_seed(L)
    data = torch.randn(n_rows, L, generator=gen, device=cuda_device, dtype=dtype)
    cols = torch.randint(0, n_cols, (n_rows, L), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    _ell_columns_bit_equal(data, cols, n_cols, b, dtype, seed=b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ELL_DTYPES)
@pytest.mark.parametrize("b", ELL_WIDTHS)
def test_ell_halo_shard_columns_bit_equal_single_on_the_card(b, dtype, cuda_device):
    """The same on the rectangular ELL shard of the ring halo: rank 1 of 2
    of laplace_3d(24) (6,912 rows, L = 7, against its 8,064-entry window)."""
    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.linop import EllOperator, cast_operator
    from arnoldi_tpu_torch.parallel import Mesh, halo_matvec_closure

    halo = halo_matvec_closure(
        EllOperator.from_scipy(matrices.laplace_3d(24), device=cuda_device),
        Mesh(None, 1, 2, cuda_device))
    local = cast_operator(halo.local, dtype)
    assert local.shape == (6912, 8064) and local.data.shape[1] == 7
    _ell_columns_bit_equal(local.data, local.cols, local.shape[1], b, dtype, seed=b)
