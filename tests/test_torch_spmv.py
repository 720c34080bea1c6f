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
from arnoldi_tpu_torch.ops.kernels.spmv_ell import ell_matmat, ell_matvec
from torch_parity import cuda_device, port_operator  # noqa: F401 (fixture)

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


def _random_ell(n_rows, n_cols, L, dtype, seed):
    """A random ELL operator: ``n_rows`` rows of ``L`` slots, ids below
    ``n_cols``."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n_rows, L)).astype(dtype)
    cols = rng.integers(0, n_cols, size=(n_rows, L)).astype(np.int32)
    return data, cols


#: (n_rows, n_cols): neither row count a multiple of the kernel's 32- or
#: 64-row tile; wider and narrower than tall.
ELL_EDGE_SHAPES = {"wide": (301, 517), "narrow": (300, 97)}


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", sorted(ELL_EDGE_SHAPES))
@pytest.mark.parametrize("L", [1, 25, 33, 129])   # both sides of the 32-slot rule
def test_ell_edge_shapes_match_pallas(L, shape, dtype):
    n_rows, n_cols = ELL_EDGE_SHAPES[shape]
    data, cols = _random_ell(n_rows, n_cols, L, dtype, seed=L)
    x = np.random.default_rng(7).standard_normal(n_cols).astype(dtype)
    y_ref = np.asarray(ell_matvec_pallas(jnp.asarray(data), jnp.asarray(cols),
                                         jnp.asarray(x), interpret=True,
                                         block_rows=64))
    y = ell_matvec(torch.from_numpy(data), torch.from_numpy(cols), torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, atol=ATOL[dtype] * np.sqrt(L))


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("L", [1, 25, 33, 129])
def test_ell_columns_match_pallas_per_column(L, b):
    n_rows, n_cols = ELL_EDGE_SHAPES["wide"]
    data, cols = _random_ell(n_rows, n_cols, L, np.float64, seed=100 + L)
    X = np.random.default_rng(b).standard_normal((b, n_cols))
    Y = ell_matmat(torch.from_numpy(data), torch.from_numpy(cols), torch.from_numpy(X))
    assert Y.shape == (b, n_rows)
    for j in range(b):
        y_ref = np.asarray(ell_matvec_pallas(jnp.asarray(data), jnp.asarray(cols),
                                             jnp.asarray(X[j]), interpret=True,
                                             block_rows=64))
        np.testing.assert_allclose(Y[j].numpy(), y_ref, atol=ATOL[np.float64] * np.sqrt(L))


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

    from arnoldi_tpu_torch import CallableOperator

    # a SciPy LinearOperator is wrapped (its matvec runs on the host) ...
    A = mark(5)
    lin = as_operator(aslinearoperator(A), device="cpu")
    assert isinstance(lin, CallableOperator) and lin.dtype == torch.float64
    x = np.random.default_rng(0).standard_normal(A.shape[0])
    np.testing.assert_allclose(lin.matvec(torch.from_numpy(x)).numpy(), A @ x,
                               rtol=1e-14)
    with pytest.raises(ValueError, match="device="):
        as_operator(aslinearoperator(A))
    # ... and anything else that is no operator still raises
    with pytest.raises(TypeError, match="Cannot convert"):
        as_operator(object(), device="cpu")
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("L", [25, 129])     # the staged and warp paths
@pytest.mark.parametrize("b", [1, 3])
def test_complex_kernels_match_plain_on_the_card(b, L, dtype, cuda_device):
    """The complex forms of the DIA and ELL kernels against their plain
    versions on the card: normwise 1e-12 (complex128), 1e-5 (complex64)."""
    from arnoldi_tpu_torch.ops.kernels.spmv_banded import (banded_matmat,
                                                           banded_matvec_plain)
    from arnoldi_tpu_torch.ops.kernels.spmv_ell import ell_matvec_plain

    limit = 1e-12 if dtype == torch.complex128 else 1e-5
    gen = torch.Generator(device=cuda_device).manual_seed(L + b)
    n, offs = 40_000, (-200, -1, 0, 1, 200)
    bands = torch.randn(5, n, generator=gen, device=cuda_device, dtype=dtype)
    X = torch.randn(b, n, generator=gen, device=cuda_device, dtype=dtype)
    data = torch.randn(n, L, generator=gen, device=cuda_device, dtype=dtype)
    cols = torch.randint(0, n, (n, L), generator=gen, device=cuda_device,
                         dtype=torch.int32)
    for got, want in (
            (banded_matmat(bands, X, offs) if b > 1
             else banded_matvec(bands, X[0], offs),
             banded_matvec_plain(bands, X if b > 1 else X[0], offs)),
            (ell_matmat(data, cols, X) if b > 1 else ell_matvec(data, cols, X[0]),
             ell_matvec_plain(data, cols, X if b > 1 else X[0]))):
        torch.cuda.synchronize()
        assert got.dtype == dtype
        assert float((got - want).norm() / want.norm()) <= limit


# -- the DIA wrappers' lean launch path -------------------------------------

from arnoldi_tpu_torch.ops.kernels import _build, spmv_banded  # noqa: E402

def _two_columns(x):
    """Two columns like ``x`` as a (2, n) array, strided where ``x`` is."""
    if x.is_contiguous():
        return torch.stack([x, x])
    return torch.ones(2, 2 * x.shape[0], dtype=x.dtype, device=x.device)[:, ::2]


DIA_FORMS = {
    "spmv_dia": lambda bands, x, offsets, **kw: spmv_banded.banded_matvec(
        bands, x, offsets),
    "spmv_dia_cols": lambda bands, x, offsets, **kw: spmv_banded.banded_matmat(
        bands, _two_columns(x), offsets),
    "spmv_dia_ext": lambda bands, x, offsets, **kw: spmv_banded.banded_matvec_ext(
        bands, x, offsets, x_base=0, **kw),
    "spmv_dia_ext_cols": lambda bands, x, offsets, **kw: spmv_banded.banded_matmat_ext(
        bands, _two_columns(x), offsets, x_base=0, **kw),
}
OFFS3 = (0, 1, -1)


def _bad_dtype():
    return torch.ones(3, 10).half(), torch.ones(10).half(), OFFS3


def _mixed_dtypes():
    return torch.ones(3, 10, dtype=torch.float64), torch.ones(10), OFFS3


def _mixed_devices():
    return (torch.ones(3, 10, dtype=torch.float64),
            torch.ones(10, dtype=torch.float64, device="meta"), OFFS3)


def _other_device():
    return (torch.ones(3, 10, dtype=torch.float64, device="meta"),
            torch.ones(10, dtype=torch.float64, device="meta"), OFFS3)


def _strided_x():
    return (torch.ones(3, 10, dtype=torch.float64),
            torch.ones(20, dtype=torch.float64)[::2], OFFS3)


def _strided_bands():
    return (torch.ones(10, 3, dtype=torch.float64).T,
            torch.ones(10, dtype=torch.float64), OFFS3)


def _short_x():
    return torch.ones(3, 10, dtype=torch.float64), torch.ones(9, dtype=torch.float64), OFFS3


def _offsets_count():
    return torch.ones(3, 10, dtype=torch.float64), torch.ones(10, dtype=torch.float64), (0, 1)


def _flat_bands():
    return torch.ones(30, dtype=torch.float64), torch.ones(30, dtype=torch.float64), OFFS3


#: bad operands -> (exception, message); the x-length case is the square
#: forms' (a shard form's window may be any length)
BAD_DIA_OPERANDS = {
    "dtype": (_bad_dtype, TypeError, "float32 or float64"),
    "mixed_dtypes": (_mixed_dtypes, TypeError, "mixed dtypes"),
    "mixed_devices": (_mixed_devices, ValueError, "operands on cpu and meta"),
    "other_device": (_other_device, ValueError, "CPU or CUDA"),
    "strided_x": (_strided_x, ValueError, "contiguous"),
    "strided_bands": (_strided_bands, ValueError, "contiguous"),
    "x_length": (_short_x, ValueError, "bands"),
    "offsets_count": (_offsets_count, ValueError, "offsets"),
    "bands_1d": (_flat_bands, ValueError, "bands"),
}


@pytest.mark.parametrize("form,bad", [
    (form, bad) for form in sorted(DIA_FORMS) for bad in sorted(BAD_DIA_OPERANDS)
    if not (bad == "x_length" and "ext" in form)])
def test_dia_wrappers_reject_bad_operands(form, bad):
    make, exc, match = BAD_DIA_OPERANDS[bad]
    bands, x, offsets = make()
    with pytest.raises(exc, match=match):
        DIA_FORMS[form](bands, x, offsets)


@pytest.mark.parametrize("form", sorted(DIA_FORMS))
def test_dia_wrappers_reject_more_than_16_offsets(form, monkeypatch):
    """The kernel takes 16 offsets; the check runs before any allocation
    or launch (a CUDA device is faked: the plain version on the CPU takes
    any number)."""
    bands = torch.ones(17, 40, dtype=torch.float64)
    x = torch.ones(40, dtype=torch.float64)
    offsets = tuple(range(-8, 9))
    # the plain version on the CPU takes them
    assert DIA_FORMS[form](bands, x, offsets).shape[-1] == 40
    monkeypatch.setattr(_build, "operand_device", lambda kernel, a, b: 0)
    with pytest.raises(ValueError, match="at most 16 diagonals, got 17"):
        DIA_FORMS[form](bands, x, offsets)


@pytest.mark.parametrize("row0,rows", [(-1, 5), (0, 41), (30, 11), (40, 1), (0, -1)])
@pytest.mark.parametrize("form", ["spmv_dia_ext", "spmv_dia_ext_cols"])
def test_dia_shard_rejects_rows_out_of_bounds(form, row0, rows):
    bands = torch.ones(3, 40, dtype=torch.float64)
    x = torch.ones(44, dtype=torch.float64)
    with pytest.raises(ValueError, match="rows"):
        DIA_FORMS[form](bands, x, OFFS3, row0=row0, rows=rows)


#: hand-worked offsets: what the kernel is given
LAUNCH_PLANS = {
    "laplace_2d(724)": (-724, -1, 0, 1, 724),
    "laplace_3d(64)": (-4096, -64, -1, 0, 1, 64, 4096),
    "one band": (0,),
    "sixteen": tuple(range(-8, 8)),
    "one-sided": (3, 900, 2000),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_PLANS))
def test_launch_plan(case):
    import ctypes

    offsets = LAUNCH_PLANS[case]
    got, k, array = spmv_banded.launch_plan(offsets)
    assert got == offsets and k == len(offsets)
    assert array._type_ is ctypes.c_longlong and list(array) == list(offsets)
    assert spmv_banded.launch_plan(offsets)[2] is array   # built once


def test_launch_plan_converts_and_handles_no_offsets():
    got, k, array = spmv_banded.launch_plan((np.int64(-3), np.int32(5)))
    assert got == (-3, 5) and all(type(o) is int for o in got)
    assert (k, list(array)) == (2, [-3, 5])
    got, k, array = spmv_banded.launch_plan(())
    assert (got, k, len(array)) == ((), 0, 1)


@pytest.mark.parametrize("b", [1, 2, 9])
def test_dia_shard_base0_equals_square(b):
    """The shard form with x_base = 0 over the whole vector is the square
    form (the kernel runs both through one entry point)."""
    rng = np.random.default_rng(b)
    n, offsets = 301, (-17, -1, 0, 1, 17)
    bands = torch.from_numpy(rng.standard_normal((5, n)))
    X = torch.from_numpy(rng.standard_normal((b, n) if b > 1 else n))
    square = (spmv_banded.banded_matmat if b > 1 else spmv_banded.banded_matvec)(
        bands, X, offsets)
    shard = (spmv_banded.banded_matmat_ext if b > 1 else spmv_banded.banded_matvec_ext)(
        bands, X, offsets, x_base=0)
    assert torch.equal(square, shard)


# -- the ELL kernel's launch plan and its wrappers' lean launch path --------

from arnoldi_tpu_torch.ops.kernels import spmv_ell  # noqa: E402

#: hand-worked launches: (n_rows, L, b, dtype) -> (path, tile rows, group
#: columns, columns a thread keeps, threads, grid)
ELL_PLANS = {
    (100_003, 25, 1, torch.float64): ("tiles", 32, 1, 1, 32, (3126, 1)),
    (100_003, 1, 1, torch.complex128): ("tiles", 32, 1, 1, 32, (3126, 1)),
    (100_003, 32, 1, torch.float32): ("tiles", 32, 1, 1, 32, (3126, 1)),
    (100_003, 25, 8, torch.float64): ("groups", 64, 64, 2, 256, (1563, 1)),
    (100_003, 25, 8, torch.complex128): ("groups", 64, 64, 2, 256, (1563, 1)),
    (100_003, 7, 2, torch.float32): ("groups", 64, 64, 2, 64, (1563, 1)),
    (100_003, 25, 5, torch.complex64): ("groups", 64, 64, 2, 192, (1563, 1)),
    (100_003, 7, 3, torch.complex128): ("groups", 64, 64, 2, 128, (1563, 1)),
    (100_003, 7, 9, torch.float32): ("groups", 64, 64, 4, 192, (1563, 1)),
    (55_296, 7, 327, torch.float32): ("groups", 64, 64, 4, 256, (864, 6)),
    (110_592, 7, 327, torch.float64): ("groups", 64, 64, 4, 256, (1728, 6)),
    (110_591, 7, 64, torch.complex128): ("groups", 64, 64, 2, 256, (1728, 1)),
    (1000, 1, 67, torch.float32): ("groups", 64, 64, 4, 256, (16, 2)),
    (1000, 25, 67, torch.complex64): ("groups", 64, 64, 4, 256, (16, 2)),
    (1000, 32, 327, torch.complex128): ("groups", 64, 64, 2, 256, (16, 6)),
    (1000, 33, 1, torch.float64): ("warp", 8, 1, 1, 256, (125, 1)),
    (1000, 33, 9, torch.float64): ("warp", 8, 8, 1, 256, (125, 1)),
    (1001, 129, 3, torch.float64): ("warp", 8, 3, 1, 256, (126, 1)),
    (1001, 129, 327, torch.complex64): ("warp", 8, 8, 1, 256, (126, 1)),
}


@pytest.mark.parametrize("shape", list(ELL_PLANS), ids=str)
def test_ell_plan(shape):
    plan = spmv_ell.ell_plan(*shape)
    assert (plan.path, plan.tile_rows, plan.group_cols, plan.thread_cols,
            plan.threads, plan.grid) == ELL_PLANS[shape]


@pytest.mark.parametrize("L", [1, 7, 25, 32, 33, 129])
@pytest.mark.parametrize("b", [1, 8, 9, 64, 67, 327])
@pytest.mark.parametrize("n_rows", [1, 31, 1000, 55_297])
def test_ell_plan_covers_every_row_and_column_once(n_rows, L, b):
    """Walk the launch the plan describes as the kernel walks it (block
    (tile, group), thread t: row t % tile_rows; in the group path the
    columns of its passes, in the warp path the chunks of its row) and
    count every (row, column) it writes: each exactly once."""
    for dtype in (torch.float32, torch.complex128):
        plan = spmv_ell.ell_plan(n_rows, L, b, dtype)
        hits = np.zeros((n_rows, b), dtype=np.int64)
        R, G, NC = plan.tile_rows, plan.group_cols, plan.thread_cols
        if plan.path == "warp":
            assert plan.grid[0] * R >= n_rows > (plan.grid[0] - 1) * R
            for j0 in range(0, b, G):        # one warp a row walks the chunks
                hits[:, j0:j0 + G] += 1
        elif plan.path == "tiles":
            assert plan.grid[0] * R >= n_rows > (plan.grid[0] - 1) * R
            assert b == 1 and plan.threads == R
            for t in range(plan.threads):     # every tile, by the persistent grid
                hits[t::R, 0] += 1
        else:
            lanes = plan.threads // R
            for ty in range(plan.grid[1]):
                j_end = min(b, (ty + 1) * G)
                for t in range(plan.threads):
                    for j in range(ty * G + t // R * NC, j_end, lanes * NC):
                        hits[t % R::R, j:min(j + NC, j_end)] += 1
            assert plan.grid[0] * R >= n_rows > (plan.grid[0] - 1) * R
        assert (hits == 1).all(), (plan, np.unique(hits))
        assert plan.grid[1] == (-(-b // G) if plan.path == "groups" else 1)


def test_ell_plan_rejects_empty_shapes():
    for shape in ((0, 7, 1), (10, 0, 1), (10, 7, 0)):
        with pytest.raises(ValueError, match="ell_plan"):
            spmv_ell.ell_plan(*shape, torch.float32)


ELL_FORMS = {
    "spmv_ell": lambda data, cols, x: spmv_ell.ell_matvec(data, cols, x),
    "spmv_ell_cols": lambda data, cols, x: spmv_ell.ell_matmat(data, cols,
                                                               _two_columns(x)),
}


def _ell_ok(dtype=torch.float64, device="cpu"):
    data = torch.ones(4, 3, dtype=dtype, device=device)
    cols = torch.zeros(4, 3, dtype=torch.int32, device=device)
    return data, cols, torch.ones(6, dtype=dtype, device=device)


def _ell_bad(change):
    def make():
        data, cols, x = _ell_ok()
        return change(data, cols, x)
    return make


#: bad operands -> (maker, exception, message)
BAD_ELL_OPERANDS = {
    "dtype": (lambda: tuple(t.half() if t.is_floating_point() else t
                            for t in _ell_ok()), TypeError, "float32 or float64"),
    "mixed_dtypes": (_ell_bad(lambda d, c, x: (d, c, x.float())), TypeError,
                     "mixed dtypes"),
    "mixed_devices": (_ell_bad(lambda d, c, x: (d, c, x.to("meta"))), ValueError,
                      "operands on cpu and meta"),
    "other_device": (lambda: _ell_ok(device="meta"), ValueError, "CPU or CUDA"),
    "strided_x": (_ell_bad(lambda d, c, x: (d, c, torch.ones(12, dtype=x.dtype)[::2])),
                  ValueError, "operands must be contiguous"),
    "strided_data": (_ell_bad(lambda d, c, x: (torch.ones(3, 4, dtype=d.dtype).T, c, x)),
                     ValueError, "operands must be contiguous"),
    "cols_int64": (_ell_bad(lambda d, c, x: (d, c.long(), x)), TypeError,
                   "cols must be int32"),
    "cols_device": (_ell_bad(lambda d, c, x: (d, c.to("meta"), x)), ValueError,
                    "cols on meta, operands on cpu"),
    "cols_strided": (_ell_bad(lambda d, c, x: (
        d, torch.zeros(3, 4, dtype=torch.int32).T, x)), ValueError,
        "cols must be contiguous"),
    "cols_shape": (_ell_bad(lambda d, c, x: (d, c[:, :2].contiguous(), x)),
                   ValueError, "data"),
    "data_1d": (_ell_bad(lambda d, c, x: (d.reshape(-1), c.reshape(-1), x)),
                ValueError, "data"),
}


@pytest.mark.parametrize("form,bad", [(form, bad) for form in sorted(ELL_FORMS)
                                      for bad in sorted(BAD_ELL_OPERANDS)])
def test_ell_wrappers_reject_bad_operands(form, bad):
    make, exc, match = BAD_ELL_OPERANDS[bad]
    with pytest.raises(exc, match=match):
        ELL_FORMS[form](*make())


@pytest.mark.parametrize("form", sorted(ELL_FORMS))
def test_ell_wrappers_run_the_plain_version_on_the_cpu(form):
    data, cols, x = _ell_ok()
    got = ELL_FORMS[form](data, cols, x)
    assert got.shape == ((4,) if form == "spmv_ell" else (2, 4))
    assert torch.equal(got, torch.full_like(got, 3.0))


def test_ell_wrappers_reject_x_of_the_wrong_rank():
    data, cols, x = _ell_ok()
    with pytest.raises(ValueError, match="x must be"):
        spmv_ell.ell_matvec(data, cols, torch.stack([x, x]))
    with pytest.raises(ValueError, match="X must be"):
        spmv_ell.ell_matmat(data, cols, x)


@pytest.mark.parametrize("form", sorted(ELL_FORMS))
def test_ell_wrappers_check_cols_on_a_cuda_device(form, monkeypatch):
    """On a (faked) CUDA device the cols must lie on that device: CPU ids
    raise before any allocation or launch."""
    monkeypatch.setattr(_build, "operand_device", lambda kernel, a, b: 0)
    monkeypatch.setattr(_build, "_entries", {})
    with pytest.raises(ValueError, match="cols on cpu"):
        ELL_FORMS[form](*_ell_ok())
    assert _build._entries == {}     # nothing was resolved or built
