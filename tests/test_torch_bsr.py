"""The port's BsrOperator and BSR SpMV (plain PyTorch versions of the gather
and window kernels) against the JAX package's BsrOperator, its Pallas BSR
kernels in interpret mode (``tests/test_pallas.py::TestBsrPallas``'s cases)
and ``pack_bsr16``.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``.

Tolerances: float32 1e-4 absolute (``TestBsrPallas``'s own, for sums of a
few hundred O(1) products), float64 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from arnoldi_tpu.linop import BsrOperator as JaxBsrOperator
from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace_2d, mark, random_scattered
from arnoldi_tpu.ops.pallas.spmv_bsr import (bsr_matvec_pallas,
                                             bsr_matvec_pallas16, pack_bsr16)
from arnoldi_tpu_torch import BsrOperator, as_operator
from arnoldi_tpu_torch.linop import cast_operator
from arnoldi_tpu_torch.ops.kernels import spmv_bsr
from torch_parity import port_operator

torch.set_num_threads(1)

ATOL = {np.float32: 1e-4, np.float64: 1e-12}


def _pair(n_side, dtype):
    A = mark(n_side)
    return (JaxBsrOperator.from_scipy(A, blocksize=(8, 8), dtype=dtype),
            BsrOperator.from_scipy(A, blocksize=(8, 8), dtype=dtype,
                                   device="cpu"))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_side", [60, 20])
def test_arrays_bit_equal_to_jax(n_side, dtype):
    ref, op = _pair(n_side, dtype)
    assert np.array_equal(op.blocks.numpy(), np.asarray(ref.blocks))
    assert np.array_equal(op.block_cols.numpy(), np.asarray(ref.block_cols))
    assert op.block_cols.dtype == torch.int32
    assert (op.nnz_stored, op.n_cols, op.n_rows) == (ref.nnz_stored, ref.n_cols,
                                                    ref.n_rows)
    assert op.shape == tuple(ref.shape) and op.blockshape == ref.blockshape


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_side,row_tile", [(60, 32), (20, 64)])
def test_matvec_matches_jax_and_pallas(n_side, row_tile, dtype):
    ref, op = _pair(n_side, dtype)
    x = np.random.default_rng(0).standard_normal(op.n_cols).astype(dtype)
    y_ref = np.asarray(ref.matvec(jnp.asarray(x)))
    y_pallas = np.asarray(bsr_matvec_pallas(
        ref.blocks, ref.block_cols, jnp.asarray(x), n_rows=ref.n_rows,
        interpret=True, row_tile=row_tile))
    xt = torch.from_numpy(x)
    for y in (op.matvec(xt),
              spmv_bsr.bsr_matvec(op.blocks, op.block_cols, xt, op.n_rows),
              spmv_bsr.bsr_window_matvec(op.blocks, op.window, xt, op.n_rows)):
        assert y.shape == (op.n_rows,) and y.dtype == op.dtype
        np.testing.assert_allclose(y.numpy(), y_ref, atol=ATOL[dtype])
        np.testing.assert_allclose(y.numpy(), y_pallas, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_window_matvec_matches_pallas16(dtype):
    ref, op = _pair(60, dtype)
    x = np.random.default_rng(2).standard_normal(op.n_cols).astype(dtype)
    b16, c16, tb, Wt = pack_bsr16(ref, row_tile16=4)
    y16 = np.asarray(bsr_matvec_pallas16(
        jnp.asarray(b16), jnp.asarray(c16), jnp.asarray(tb), jnp.asarray(x),
        Wt=Wt, n_rows=ref.n_rows, interpret=True, row_tile16=4))
    win = spmv_bsr.bsr_window(op.blocks.numpy(), op.block_cols.numpy(),
                              device="cpu", tile_brows=16 * 4)
    y = spmv_bsr.bsr_window_matvec(op.blocks, win, torch.from_numpy(x), op.n_rows)
    np.testing.assert_allclose(y.numpy(), y16, atol=ATOL[dtype])


@pytest.mark.parametrize("row_tile16", [1, 4, 16])
@pytest.mark.parametrize("case", ["mark60", "mark20", "scattered"])
def test_pack_bsr_window_matches_pack_bsr16(case, row_tile16):
    A = {"mark60": lambda: mark(60), "mark20": lambda: mark(20),
         "scattered": lambda: random_scattered(4096, 24, seed=1, bandwidth=256,
                                               block=8)}[case]()
    ref = JaxBsrOperator.from_scipy(A, blocksize=(8, 8))
    _, _, tb16, Wt16 = pack_bsr16(ref, row_tile16=row_tile16)
    cols, tile_base, Wt = spmv_bsr.pack_bsr_window(
        np.asarray(ref.blocks), np.asarray(ref.block_cols), 16 * row_tile16)
    np.testing.assert_array_equal(tile_base, tb16)
    assert Wt == Wt16
    # every id of a tile lies inside its window, and only padding slots moved
    tiles = np.arange(cols.shape[0]) // (16 * row_tile16)
    rel = cols - tile_base[tiles][:, None]
    assert rel.min() >= 0 and rel.max() < Wt
    valid = np.asarray(ref.blocks).reshape(*cols.shape, -1).any(axis=2)
    np.testing.assert_array_equal(cols[valid], np.asarray(ref.block_cols)[valid])


def test_window_repoints_padding_slots():
    # Rows of unequal degree: padding slots would stretch the window to
    # column 0; repointed, each tile's window covers its own band only.
    n = 8 * 512
    A = sp.diags_array([np.ones(n), np.ones(n - 8)], offsets=[0, 8]).tolil()
    A[n - 1, n - 200] = A[n - 1, n - 100] = 1.0   # one longer block-row
    op = BsrOperator.from_scipy(A.tocsr(), device="cpu")
    assert op.block_cols.shape[1] == 3
    # a tile of 128 block-rows spans 129 block-columns; unrepointed
    # padding would stretch every window to all 512
    assert op.window.width == 136
    assert int(op.window.tile_base[-1]) == 384
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n))
    np.testing.assert_allclose(op.matvec(x).numpy(), A.tocsr() @ x.numpy(),
                               atol=1e-12)


def test_window_plain_reads_zero_outside_the_window():
    _, op = _pair(20, np.float64)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(op.n_cols))
    narrow = spmv_bsr.BsrWindow(op.window.cols, op.window.tile_base, 8,
                                op.window.tile_brows)
    y_full = spmv_bsr.bsr_window_matvec_plain(op.blocks, op.window, x, op.n_rows)
    y_narrow = spmv_bsr.bsr_window_matvec_plain(op.blocks, narrow, x, op.n_rows)
    assert not torch.allclose(y_full, y_narrow)


@pytest.mark.parametrize("b", [1, 3, 8, 11])
def test_matmat_rows_match_jax_matmat(b):
    ref, op = _pair(20, np.float64)
    X = np.random.default_rng(5).standard_normal((op.n_cols, b))
    want = np.asarray(ref.matmat(jnp.asarray(X)))
    got = op.matmat(torch.from_numpy(X))
    assert got.shape == (op.n_rows, b) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    rows = op.matmat_rows(torch.from_numpy(np.ascontiguousarray(X.T)))
    np.testing.assert_allclose(rows.numpy(), want.T, atol=1e-12)
    for fn, ids in ((spmv_bsr.bsr_matmat, op.block_cols),
                    (spmv_bsr.bsr_window_matmat, op.window)):
        y = fn(op.blocks, ids, torch.from_numpy(np.ascontiguousarray(X.T)),
               op.n_rows)
        np.testing.assert_allclose(y.numpy(), want.T, atol=1e-12)


@pytest.mark.parametrize("blocksize", [(8, 8), (4, 4), (2, 8), (3, 3)])
def test_as_operator_bsr_format(blocksize):
    A = laplace_2d(13, 11)            # n = 143, not a multiple of 8
    fmt = ("bsr", blocksize)
    ref = jax_as_operator(A, format=fmt)
    op = as_operator(A, format=fmt, device="cpu")
    assert isinstance(op, BsrOperator) and op.blockshape == blocksize
    assert np.array_equal(op.blocks.numpy(), np.asarray(ref.blocks))
    x = np.random.default_rng(6).standard_normal(A.shape[1])
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(x))), atol=1e-12)
    assert isinstance(as_operator(A, format="bsr", device="cpu"), BsrOperator)
    assert as_operator(op, format="bsr") is op
    with pytest.raises(ValueError, match="re-formatted"):
        as_operator(op, format="ell")


def test_rectangular_bsr():
    A = sp.random(100, 70, density=0.1, random_state=0, format="csr")
    ref = jax_as_operator(A, format=("bsr", (8, 8)))
    op = as_operator(A, format=("bsr", (8, 8)), device="cpu")
    assert op.shape == (100, 70)
    x = np.random.default_rng(7).standard_normal(70)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(ref.matvec(jnp.asarray(x))), atol=1e-12)


def test_operator_from_reference():
    A = random_scattered(1024, 24, seed=1, bandwidth=64, block=8)
    ref = jax_as_operator(A, format=("bsr", (8, 8)))
    conv = port_operator(ref)
    op = as_operator(A, format=("bsr", (8, 8)), device="cpu")
    assert isinstance(conv, BsrOperator)
    assert torch.equal(conv.blocks, op.blocks)
    assert torch.equal(conv.block_cols, op.block_cols)
    assert torch.equal(conv.window.cols, op.window.cols)
    assert torch.equal(conv.window.tile_base, op.window.tile_base)
    assert conv.shape == op.shape and conv.nnz == op.nnz == ref.nnz
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(1024))
    assert torch.equal(conv.matvec(x), op.matvec(x))


def test_kernel_choice_follows_the_window_budget():
    near = as_operator(random_scattered(8192, 24, seed=1, bandwidth=64, block=8),
                       format="bsr", device="cpu")
    far = as_operator(random_scattered(2**16, 24, seed=1, bandwidth=2**14,
                                       block=8), format="bsr", device="cpu")
    for op in (near, far):
        col_bytes = op.window.width * 8 * op.dtype.itemsize
        assert op.uses_window == (col_bytes <= spmv_bsr.WINDOW_BUDGET_BYTES)
    assert near.uses_window and not far.uses_window
    # a narrower dtype can only widen the choice; the window is kept
    far32 = cast_operator(far, np.float32)
    assert far32.window is far.window and far32.dtype == torch.float32
    assert far.to("cpu").window.width == far.window.width


def test_bsr_wrappers_reject_bad_operands():
    _, op = _pair(20, np.float64)
    x = torch.ones(op.n_cols, dtype=torch.float64)
    with pytest.raises(TypeError, match="int32"):
        spmv_bsr.bsr_matvec(op.blocks, op.block_cols.long(), x, op.n_rows)
    with pytest.raises(TypeError, match="mixed dtypes"):
        spmv_bsr.bsr_matvec(op.blocks, op.block_cols, x.float(), op.n_rows)
    with pytest.raises(ValueError, match="n_rows"):
        spmv_bsr.bsr_matvec(op.blocks, op.block_cols, x, 10**6)
    with pytest.raises(ValueError, match=r"\(n_cols,\)"):
        spmv_bsr.bsr_matvec(op.blocks, op.block_cols, x[None], op.n_rows)
    with pytest.raises(ValueError, match=r"\(b, n_cols\)"):
        spmv_bsr.bsr_window_matmat(op.blocks, op.window, x, op.n_rows)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        spmv_bsr.bsr_matvec(op.blocks.to("meta"), op.block_cols.to("meta"),
                            x.to("meta"), op.n_rows)


def _window_case(case):
    A = {"mark60": lambda: mark(60), "mark20": lambda: mark(20),
         "scattered": lambda: random_scattered(4096, 24, seed=1, bandwidth=256,
                                               block=8)}[case]()
    return BsrOperator.from_scipy(A, device="cpu")


@pytest.mark.parametrize("nb,n_blocks", [(1, 7), (3, 2), (8, 5), (11, 64)])
@pytest.mark.parametrize("case", ["mark60", "mark20", "scattered"])
def test_window_plan_stages_every_id(case, nb, n_blocks):
    # The window kernel's plan: one column stages each tile once, each
    # thread block walking a contiguous run of tiles; b >= 2 columns take
    # the walk (gather8_steps over the window layout), which contracts each
    # (block-row, column, slot) once.  The window a tile reads (its clamped
    # base, Wt block-columns) holds every id of the tile.
    op = _window_case(case)
    win, c = op.window, op.blockshape[1]
    plan = spmv_bsr.window_plan(8, c, nb, win.width, torch.float64)
    n_tiles = win.tile_base.shape[0]
    n_brow, L = win.cols.shape
    if nb == 1:
        assert (plan.path, plan.cols_per_pass) == ("staged", 1)
        n_blocks = min(n_blocks, n_tiles)           # the grid never exceeds the tiles
        runs = spmv_bsr.window_items(n_tiles, n_blocks)
        assert len(runs) == n_blocks and all(runs)
        assert [t for run in runs for t in run] == list(range(n_tiles))
        assert all(run == list(range(run[0], run[-1] + 1)) for run in runs)
    else:
        assert (plan.path, plan.passes) == ("walk", -(-nb // 8))
        seen = np.zeros((nb, n_brow, L), dtype=int)
        for run in spmv_bsr.gather8_steps(n_brow, L, nb, n_blocks):
            for pair, j0, cnt, l0 in run:
                for brow in range(2 * pair, min(2 * pair + 2, n_brow)):
                    seen[j0:j0 + cnt, brow, l0:l0 + 4] += 1
        assert (seen == 1).all()
    base = spmv_bsr.window_bases(win, op.n_cols, c).numpy()
    tiles = np.arange(win.cols.shape[0]) // win.tile_brows
    rel = win.cols.numpy() - base[tiles][:, None]
    assert rel.min() >= 0 and rel.max() < win.width
    assert base.min() >= 0 and base.max() + win.width <= max(-(-op.n_cols // c),
                                                              win.width)


# banded-1024 as BSR-8 has a window of 384 block-columns (24,640 B a
# float64 column staged with its zero block-column)
@pytest.mark.parametrize("dtype,nb,want", [
    (torch.float64, 1, ("staged", 1, 1, 2, 256, 16 + 2 * 24640)),   # solve H
    (torch.float64, 4, ("walk", 8, 1, 0, 512, 16 * 2 * (256 + 4) * 8)),
    (torch.float64, 8, ("walk", 8, 1, 0, 512, 16 * 2 * (256 + 4) * 8)),  # solve D
    (torch.float64, 11, ("walk", 8, 2, 0, 512, 16 * 2 * (256 + 4) * 8)),
    (torch.float32, 8, ("walk", 8, 1, 0, 512, 16 * 2 * (256 + 8) * 4))])
def test_window_passes_and_stages_at_banded_1024(dtype, nb, want):
    plan = spmv_bsr.window_plan(8, 8, nb, 384, dtype)
    assert (plan.path, plan.cols_per_pass, plan.passes, plan.stages, plan.threads,
            plan.shared_bytes) == want
    assert plan.shared_bytes <= spmv_bsr.MAX_SHARED_BYTES


def test_window_passes_at_the_budget():
    # the widest window the routing sends to the window kernel (64 KB a
    # float64 column): one column still stages it in two stages, b >= 2
    # walks as at any width, and the general kernel (4 x 4 blocks) stages
    # three columns a pass; a window wider than shared memory stages
    # nothing, and the wrapper refuses it for one column
    width = spmv_bsr.WINDOW_BUDGET_BYTES // 64
    one = spmv_bsr.window_plan(8, 8, 1, width, torch.float64)
    assert (one.path, one.cols_per_pass, one.stages) == ("staged", 1, 2)
    assert spmv_bsr.window_stages((width + 1) * 64) == 2
    assert spmv_bsr.window_plan(8, 8, 8, width, torch.float64) \
        == spmv_bsr.window_plan(8, 8, 8, 8, torch.float64)
    general = spmv_bsr.window_plan(4, 4, 8, 2 * width, torch.float64)
    assert (general.path, general.cols_per_pass) == ("general", 3)
    assert spmv_bsr.window_cols_per_pass(8, spmv_bsr.MAX_SHARED_BYTES) == 0
    too_wide = spmv_bsr.MAX_SHARED_BYTES // 64
    assert spmv_bsr.window_plan(8, 8, 1, too_wide, torch.float64).cols_per_pass == 0
    assert spmv_bsr.window_stages(spmv_bsr.MAX_SHARED_BYTES // 2) == 1


@pytest.mark.parametrize("blockshape,nb,want", [
    ((8, 8), 1, False), ((8, 8), 2, True), ((8, 8), 8, True), ((8, 8), 16, True),
    ((4, 4), 8, False), ((2, 8), 8, False)])
def test_gather8_rule(blockshape, nb, want):
    # the staged 8 x 8 gather kernel takes b >= 2 columns of 8 x 8 blocks;
    # one column and every other shape keep the first gather kernel
    assert spmv_bsr.uses_gather8(*blockshape, nb) == want


@pytest.mark.parametrize("nb,n_warps", [(2, 1), (3, 5), (8, 7), (11, 3), (16, 64)])
@pytest.mark.parametrize("case", ["mark20", "scattered", "rectangular"])
def test_gather8_walk_computes_the_product(case, nb, n_warps):
    # The staged gather kernel's walk (gather8_steps): warp w takes the
    # block-row pairs w, w + n_warps, ...; a pair's steps cover its passes
    # of at most 8 columns, each over its slots 4 at a time, and the last
    # step of a pass writes it.  Following the walk step by step gives the
    # product, and writes every (block-row, column) exactly once.
    if case == "rectangular":
        A = sp.random(203, 341, density=0.05, random_state=3, format="csr")
    else:
        A = mark(20) if case == "mark20" else random_scattered(
            4096, 40, seed=5, bandwidth=512, block=8)
    op = BsrOperator.from_scipy(A, device="cpu")
    blk, ids = op.blocks.numpy(), op.block_cols.numpy()
    n_brow, L = ids.shape
    X = np.random.default_rng(1).standard_normal((nb, op.n_cols))
    Xp = np.zeros((nb, (ids.max() + 1) * 8))
    Xp[:, :op.n_cols] = X
    plan = spmv_bsr.gather8_steps(n_brow, L, nb, n_warps)
    n_pairs = -(-n_brow // 2)
    assert len(plan) == n_warps
    for w, run in enumerate(plan):
        assert sorted({s[0] for s in run}) == list(range(w, n_pairs, n_warps))
    Y = np.zeros((nb, n_brow * 8))
    written = np.zeros((nb, n_brow), dtype=int)
    for run in plan:
        acc = {}
        for pair, j0, cnt, l0 in run:
            assert 1 <= cnt <= spmv_bsr.MAX_COLS_PER_PASS and l0 % 4 == 0
            for brow in (2 * pair, 2 * pair + 1):
                if brow >= n_brow:
                    continue
                part = acc.setdefault(brow, np.zeros((cnt, 8)))
                for l in range(l0, min(l0 + 4, L)):
                    xs = Xp[j0:j0 + cnt, ids[brow, l] * 8:ids[brow, l] * 8 + 8]
                    part += xs @ blk[brow, l].T
                if l0 + 4 >= L:                 # the pass's last chunk
                    Y[j0:j0 + cnt, brow * 8:brow * 8 + 8] = acc.pop(brow)
                    written[j0:j0 + cnt, brow] += 1
        assert not acc
    assert (written == 1).all()
    want = spmv_bsr.bsr_matvec_plain(op.blocks, op.block_cols, torch.from_numpy(X),
                                     op.n_rows).numpy()
    np.testing.assert_allclose(Y[:, :op.n_rows], want, atol=1e-12)
