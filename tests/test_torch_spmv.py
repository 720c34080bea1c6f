"""The port's SpMV (plain PyTorch versions of the DIA and ELL kernels) and
operators against the JAX package's Pallas kernels in interpret mode and
its operators.  The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace, laplace_2d, mark, random_scattered
from arnoldi_tpu.ops.pallas.spmv_banded import banded_matvec_pallas
from arnoldi_tpu.ops.pallas.spmv_ell import ell_matvec_pallas
from arnoldi_tpu_torch import BandedOperator, DenseOperator, EllOperator, as_operator
from arnoldi_tpu_torch.ops.kernels.spmv_banded import banded_matvec
from arnoldi_tpu_torch.ops.kernels.spmv_ell import ell_matvec
from torch_parity import port_operator

torch.set_num_threads(1)

#: float32: a few ulps of sums of O(1) terms; float64 likewise.
ATOL = {np.float32: 1e-5, np.float64: 1e-12}


def _rect():
    return sp.random(120, 80, density=0.15, random_state=0, format="csr")


BANDED_CASES = {
    "laplace777": (lambda: laplace(777).tocsr(), 256),
    "laplace_2d_40": (lambda: laplace_2d(40), 512),
    "laplace_2d_33x20": (lambda: laplace_2d(33, 20), 256),
    "laplace300": (lambda: laplace(300).tocsr(), 128),
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(BANDED_CASES))
def test_banded_matches_pallas(case, dtype):
    gen, cols = BANDED_CASES[case]
    op = jax_as_operator(gen(), dtype=dtype)
    n = op.shape[0]
    x = np.random.default_rng(0).standard_normal(n).astype(dtype)
    y_ref = np.asarray(banded_matvec_pallas(op.bands, jnp.asarray(x),
                                            op.offsets, interpret=True,
                                            cols=cols))
    y = banded_matvec(torch.from_numpy(np.array(op.bands)),
                      torch.from_numpy(x), op.offsets)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=ATOL[dtype])


ELL_CASES = {
    "rectangular": _rect,
    "mark15": lambda: mark(15),
    "scattered": lambda: random_scattered(512, 24, seed=1, bandwidth=64,
                                          block=8),
    "wide_rows": lambda: sp.random(64, 64, density=0.7, random_state=3,
                                   format="csr"),      # L > 32
}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", sorted(ELL_CASES))
def test_ell_matches_pallas(case, dtype):
    A = ELL_CASES[case]()
    op = jax_as_operator(A, dtype=dtype, format="ell")
    x = np.random.default_rng(2).standard_normal(A.shape[1]).astype(dtype)
    y_ref = np.asarray(ell_matvec_pallas(op.data, op.cols, jnp.asarray(x),
                                         interpret=True, block_rows=64))
    y = ell_matvec(torch.from_numpy(np.array(op.data)),
                   torch.from_numpy(np.array(op.cols)), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, atol=ATOL[dtype])
    np.testing.assert_allclose(y.numpy(), A @ x.astype(np.float64),
                               atol=10 * ATOL[dtype])


FROM_SCIPY_CASES = {
    "laplace_2d_33x20": lambda: laplace_2d(33, 20),
    "laplace9": lambda: laplace(9),
    "mark20": lambda: mark(20),
    "rectangular": _rect,
    "scattered": lambda: random_scattered(512, 24, seed=1, bandwidth=64,
                                          block=8),
}


@pytest.mark.parametrize("dtype", [None, np.float32])
@pytest.mark.parametrize("case", sorted(FROM_SCIPY_CASES))
def test_routing_and_arrays_match_jax(case, dtype):
    A = FROM_SCIPY_CASES[case]()
    ref = jax_as_operator(A, dtype=dtype)
    op = as_operator(A, dtype=dtype, device="cpu")
    assert type(op).__name__ == type(ref).__name__
    assert op.shape == tuple(ref.shape) and op.nnz == ref.nnz
    assert op.dtype == {np.dtype(np.float32): torch.float32,
                        np.dtype(np.float64): torch.float64}[np.dtype(ref.dtype)]
    if isinstance(op, BandedOperator):
        assert op.offsets == ref.offsets
        assert np.array_equal(op.bands.numpy(), np.asarray(ref.bands))
    else:
        assert op.n_cols == ref.n_cols
        assert np.array_equal(op.data.numpy(), np.asarray(ref.data))
        assert np.array_equal(op.cols.numpy(), np.asarray(ref.cols))
        assert op.cols.dtype == torch.int32
    # the converted JAX operator is the same operator
    conv = port_operator(ref)
    assert type(conv) is type(op)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        op.shape[1]).astype(np.dtype(ref.dtype)))
    assert torch.equal(conv.matvec(x), op.matvec(x))


@pytest.mark.parametrize("n_diags,kind", [(16, "BandedOperator"),
                                          (17, "EllOperator")])
def test_banded_routing_threshold(n_diags, kind):
    A = sp.diags_array([np.ones(64)] * n_diags,
                       offsets=list(range(n_diags))).tocsr()
    assert type(jax_as_operator(A)).__name__ == kind
    assert type(as_operator(A, device="cpu")).__name__ == kind


def test_dense_operator_matches_jax():
    A = np.random.default_rng(5).standard_normal((30, 30))
    x = np.random.default_rng(6).standard_normal(30)
    op = as_operator(A, device="cpu")
    assert isinstance(op, DenseOperator)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_as_operator(A).matvec(x)),
                               atol=1e-12)
    # a tensor keeps its own device; no device argument needed
    assert as_operator(torch.from_numpy(A)).device == torch.device("cpu")


def test_host_input_needs_a_device():
    with pytest.raises(ValueError, match="device="):
        as_operator(mark(5))
    with pytest.raises(ValueError, match="device="):
        as_operator(np.eye(3))
    with pytest.raises(ValueError, match="device="):
        EllOperator.from_scipy(mark(5), device=None)


def test_outside_the_slice_raises():
    from scipy.sparse.linalg import aslinearoperator

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        as_operator(aslinearoperator(mark(5)), device="cpu")
    op = as_operator(mark(20), device="cpu")
    with pytest.raises(ValueError, match="re-formatted"):
        as_operator(op, format="banded")


def test_cast_and_move_keep_the_operator():
    op = as_operator(laplace_2d(6), device="cpu")
    op32 = as_operator(op, dtype=np.float32)
    assert op32.dtype == torch.float32 and op32.offsets == op.offsets
    assert as_operator(op32, dtype=torch.float32) is op32
    assert as_operator(op, device="cpu") is op


def test_wrappers_reject_bad_operands():
    bands = torch.ones(3, 10, dtype=torch.float64)
    with pytest.raises(TypeError, match="mixed dtypes"):
        banded_matvec(bands, torch.ones(10, dtype=torch.float32), (0, 1, -1))
    with pytest.raises(ValueError, match="offsets"):
        banded_matvec(bands, torch.ones(10, dtype=torch.float64), (0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        banded_matvec(bands, torch.ones(20, dtype=torch.float64)[::2],
                      (0, 1, -1))
    with pytest.raises(TypeError, match="float32 or float64"):
        banded_matvec(bands.to(torch.float16), torch.ones(10).half(), (0, 1, -1))
    data = torch.ones(4, 2, dtype=torch.float64)
    with pytest.raises(TypeError, match="int32"):
        ell_matvec(data, torch.zeros(4, 2, dtype=torch.int64),
                   torch.ones(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ell_matvec(data.to("meta"), torch.zeros(4, 2, dtype=torch.int32,
                                                device="meta"),
                   torch.ones(4, dtype=torch.float64, device="meta"))
