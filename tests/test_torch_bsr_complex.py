"""Complex BSR operators in the port, held against the JAX package.

The JAX package runs a complex ``BsrOperator`` through XLA (the take +
einsum of ``BsrOperator.matvec`` and ``rmatvec``'s conjugated einsum); its
Pallas BSR kernels refuse complex input, even interpreted.  Those XLA
products are what the port's plain versions (the gather and the window
one) and its operator routes are held against here, on the same operator
arrays (``convert``), with (8, 8) and (4, 4) blocks and an n that is not a
multiple of 8.  The solves run JAX's device path (a JAX operator) and the
port on the same arrays from the same start vector or block.

Tolerances: normwise relative 1e-13 (complex128) and 1e-5 (complex64) for
the products (the same products summed in another order); eigenvalues and
singular values within 1e-9 of JAX's; matvec counts equal where the
complex ELL tests get them (``test_torch_complex.py``: complex128, the
same restart policy).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from arnoldi_tpu import partial_eigh as jax_partial_eigh
from arnoldi_tpu import partial_schur as jax_partial_schur
from arnoldi_tpu import svds as jax_svds
from arnoldi_tpu.harness.suite import eigenvalues_match
from arnoldi_tpu.linop import GramOperator as JaxGramOperator
from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.linop import rmatmat as jax_rmatmat
from arnoldi_tpu.linop import rmatvec as jax_rmatvec
from arnoldi_tpu.matrices import mark, random_scattered
from arnoldi_tpu_torch import (BsrOperator, as_operator, partial_eigh,
                               partial_schur, svds)
from arnoldi_tpu_torch.linop import (GramOperator, adjoint_operator,
                                     cast_operator, pad_operator, rmatmat,
                                     rmatvec)
from arnoldi_tpu_torch.ops.kernels import spmv_bsr
from torch_parity import (cuda_device, jax_start_block,  # noqa: F401 (fixture)
                          port_operator, to_numpy)

torch.set_num_threads(1)

RTOL = {np.complex128: 1e-13, np.complex64: 1e-5}
TDTYPE = {np.complex128: torch.complex128, np.complex64: torch.complex64}
TOL = 1e-10
N = 997                                  # not a multiple of 8 (or of 4)


def phased(A, seed=7):
    """A with every off-diagonal value times ``e^{i phi}``, phi uniform on
    [0, 2 pi) from ``seed``; the diagonal kept."""
    rng = np.random.default_rng(seed)
    C = sp.coo_matrix(A).astype(np.complex128)
    off = C.row != C.col
    C.data[off] *= np.exp(1j * rng.uniform(0, 2 * np.pi, int(off.sum())))
    return C.tocsr()


def _matrix(n=N, bandwidth=128):
    return phased(random_scattered(1024, 24, seed=1, bandwidth=bandwidth,
                                   block=8)[:n, :n])


def _rel(got, want):
    got, want = to_numpy(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _vectors(shape, dtype, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)


def _pair(dtype, shape, A=None):
    A = _matrix() if A is None else A
    jop = jax_as_operator(A, format=("bsr", shape), dtype=dtype)
    assert type(jop).__name__ == "BsrOperator"
    return A, jop, port_operator(jop)


# -- products ----------------------------------------------------------------

@pytest.mark.parametrize("form", ["gather", "window"])
@pytest.mark.parametrize("shape", [(8, 8), (4, 4)])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_plain_products_match_jax(dtype, shape, form):
    """matvec, matmat (three columns as rows), and the adjoint products
    through the materialized conjugate transpose, by each plain version."""
    A, jop, op = _pair(dtype, shape)
    assert op.dtype == TDTYPE[dtype] and op.blockshape == shape
    x, X = _vectors(N, dtype), _vectors((N, 3), dtype, seed=4)

    def product(o, v):
        if form == "gather":
            return spmv_bsr.bsr_matvec_plain(o.blocks, o.block_cols, v, o.n_rows)
        return spmv_bsr.bsr_window_matvec_plain(o.blocks, o.window, v, o.n_rows)

    adj = adjoint_operator(op)
    for got, want in (
            (product(op, torch.from_numpy(x)), jop.matvec(jnp.asarray(x))),
            (product(op, torch.from_numpy(np.ascontiguousarray(X.T))).T,
             jop.matmat(jnp.asarray(X))),
            (product(adj, torch.from_numpy(x)), jax_rmatvec(jop, jnp.asarray(x))),
            (product(adj, torch.from_numpy(np.ascontiguousarray(X.T))).T,
             jax_rmatmat(jop, jnp.asarray(X)))):
        assert got.dtype == TDTYPE[dtype]
        assert _rel(got, want) <= RTOL[dtype]
    # the window form reads x only from each tile's window: every id lies
    # in it, so it gives the gather form's values
    np.testing.assert_allclose(
        to_numpy(spmv_bsr.bsr_window_matvec_plain(op.blocks, op.window,
                                                  torch.from_numpy(x), N)),
        to_numpy(spmv_bsr.bsr_matvec_plain(op.blocks, op.block_cols,
                                           torch.from_numpy(x), N)),
        rtol=0, atol=10 * RTOL[dtype] * np.abs(x).max() * 24)


@pytest.mark.parametrize("shape", [(8, 8), (4, 4)])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_operator_products_and_gram_match_jax(dtype, shape):
    """The operator's own routes: matvec, matmat, rmatvec/rmatmat by the
    scatter-adds and by the transposed operator, and the Gram products."""
    A, jop, op = _pair(dtype, shape)
    x, X = _vectors(N, dtype), _vectors((N, 2), dtype, seed=5)
    xt, Xt = torch.from_numpy(x), torch.from_numpy(X)
    checks = [(op.matvec(xt), jop.matvec(jnp.asarray(x))),
              (op.matmat(Xt), jop.matmat(jnp.asarray(X)))]
    for transposed in (False, True):
        checks += [(rmatvec(op, xt, _transposed=transposed),
                    jax_rmatvec(jop, jnp.asarray(x))),
                   (rmatmat(op, Xt, _transposed=transposed),
                    jax_rmatmat(jop, jnp.asarray(X)))]
    for t in (False, True):
        jg = JaxGramOperator(jop, transposed=t)
        g = GramOperator(op, transposed=t)
        checks += [(g.matvec(xt), jg.matvec(jnp.asarray(x))),
                   (g.matmat(Xt), jg.matmat(jnp.asarray(X)))]
    for got, want in checks:
        assert got.dtype == TDTYPE[dtype]
        assert _rel(got, want) <= RTOL[dtype]
    # the conjugate transpose, materialized, is A^H: the adjoint of A
    Ad = A.astype(dtype).conj().T.toarray()
    assert _rel(adjoint_operator(op).matvec(xt), Ad @ x) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_builders_give_the_jax_arrays(dtype):
    """``from_scipy`` (complex input, or real input with a complex dtype),
    ``as_operator(format="bsr")``, ``cast_operator`` of a real operator and
    ``operator_from_reference`` all give JAX's arrays."""
    A, jop, op = _pair(dtype, (8, 8))
    built = [BsrOperator.from_scipy(A, dtype=dtype, device="cpu"),
             as_operator(A, dtype=dtype, format="bsr", device="cpu"),
             as_operator(A, dtype=dtype, format=("bsr", (8, 8)), device="cpu")]
    if dtype == np.complex128:
        built.append(BsrOperator.from_scipy(A, device="cpu"))
    for other in built:
        assert other.dtype == op.dtype
        assert torch.equal(other.blocks, op.blocks)
        assert torch.equal(other.block_cols, op.block_cols)
        assert torch.equal(other.window.cols, op.window.cols)
        assert other.window.width == op.window.width
    real = as_operator(A.real, format="bsr", device="cpu")
    cast = cast_operator(real, TDTYPE[dtype])
    jcast = port_operator(jax_as_operator(A.real, format="bsr", dtype=dtype))
    assert cast.dtype == TDTYPE[dtype]
    assert torch.equal(cast.blocks, jcast.blocks)
    assert torch.equal(cast.window.cols, jcast.window.cols)
    # a real operator read as complex: its product is the real one
    x = _vectors(N, dtype)
    assert _rel(cast.matvec(torch.from_numpy(x)),
                A.real.astype(dtype) @ x) <= RTOL[dtype]


def test_padded_operator_acts_as_diag_a_zero():
    A, _, op = _pair(np.complex128, (8, 8), A=_matrix(n=992))
    padded = pad_operator(op, 1024)
    assert padded.dtype == torch.complex128 and padded.shape == (1024, 1024)
    x = _vectors(1024, np.complex128)
    x[992:] = 0
    y = to_numpy(padded.matvec(torch.from_numpy(x)))
    np.testing.assert_allclose(y[:992], A @ x[:992], rtol=0, atol=1e-12)
    assert np.all(y[992:] == 0)


def test_bsr_wrappers_take_complex_operands():
    """The wrappers' checks admit the complex dtypes (a CPU tensor runs the
    plain version); mixed dtypes still raise."""
    _, _, op = _pair(np.complex64, (8, 8))
    x = torch.ones(op.n_cols, dtype=torch.complex64)
    assert spmv_bsr.bsr_matvec(op.blocks, op.block_cols, x, op.n_rows).dtype \
        == torch.complex64
    assert spmv_bsr.bsr_window_matmat(op.blocks, op.window, x[None].repeat(2, 1),
                                      op.n_rows).shape == (2, op.n_rows)
    with pytest.raises(TypeError, match="mixed dtypes"):
        spmv_bsr.bsr_matvec(op.blocks, op.block_cols, x.to(torch.complex128),
                            op.n_rows)


# banded-1024 as BSR-8: a window of 384 block-columns, 49,280 B a
# complex128 column staged (the window and one zero block-column)
@pytest.mark.parametrize("dtype,nb,want", [
    # solve DB (b = 1): one staged column, the next window copied meanwhile
    (torch.complex128, 1, ("staged", 1, 1, 2, 256, 16 + 2 * 49280)),
    # b >= 2: the walk, no window staged, each block read once a pass of 8
    (torch.complex128, 3, ("walk", 8, 1, 0, 256, 8 * 2 * (256 + 2) * 16)),
    (torch.complex128, 8, ("walk", 8, 1, 0, 256, 8 * 2 * (256 + 2) * 16)),
    (torch.complex128, 11, ("walk", 8, 2, 0, 256, 8 * 2 * (256 + 2) * 16)),
    (torch.complex64, 1, ("staged", 1, 1, 2, 256, 16 + 2 * 24640)),
    (torch.complex64, 3, ("walk", 8, 1, 0, 512, 16 * 2 * (256 + 4) * 8)),
    (torch.complex64, 8, ("walk", 8, 1, 0, 512, 16 * 2 * (256 + 4) * 8)),
    (torch.complex64, 11, ("walk", 8, 2, 0, 512, 16 * 2 * (256 + 4) * 8))])
def test_complex_window_plan_at_banded_1024(dtype, nb, want):
    plan = spmv_bsr.window_plan(8, 8, nb, 384, dtype)
    assert (plan.path, plan.cols_per_pass, plan.passes, plan.stages, plan.threads,
            plan.shared_bytes) == want
    assert plan.shared_bytes <= spmv_bsr.MAX_SHARED_BYTES
    assert (plan.path == "walk") == spmv_bsr.uses_gather8(8, 8, nb)
    if plan.path == "walk":
        assert plan.shared_bytes == spmv_bsr.gather8_shared_bytes(dtype)
        assert plan.threads == spmv_bsr.gather8_threads(dtype)
    # staged windows of all 8 columns would not fit a block's shared
    # memory in complex128 (the earlier design ran 2 passes of 4)
    col_bytes = (384 + 1) * 8 * dtype.itemsize
    assert (16 + 8 * col_bytes <= spmv_bsr.MAX_SHARED_BYTES) == (dtype == torch.complex64)


def test_window_budget_counts_bytes():
    # 64 KB a column: a complex128 window may span 512 block-columns of
    # c = 8, half a float64 one's
    _, _, op = _pair(np.complex128, (8, 8))
    win = op.window
    assert win.fits(8, torch.complex128) == (win.width <= 512)
    wide = type(win)(win.cols, win.tile_base, 513, win.tile_brows)
    assert not wide.fits(8, torch.complex128) and wide.fits(8, torch.float64)
    # the general kernels' columns a pass: 4 in complex128, 8 in complex64
    assert spmv_bsr.cols_per_pass(torch.complex128) == 4
    assert spmv_bsr.cols_per_pass(torch.complex64) == 8
    for dtype in (torch.complex128, torch.complex64):
        # the walk stages no window: its plan is the same at the widest
        # window the budget admits as at the narrowest
        assert spmv_bsr.window_plan(8, 8, 8, 512, dtype) \
            == spmv_bsr.window_plan(8, 8, 8, 8, dtype)
        # one column stages its window at the budget, in two stages
        one = spmv_bsr.window_plan(8, 8, 1, 512, dtype)
        assert (one.path, one.cols_per_pass, one.stages) == ("staged", 1, 2)
    # other block shapes keep the general kernel: a complex128 (4, 4)
    # window at the budget (1024 block-columns) stages 3 columns a pass
    general = spmv_bsr.window_plan(4, 4, 8, 1024, torch.complex128)
    assert (general.path, general.cols_per_pass, general.passes) == ("general", 3, 3)


def _walk_window_product(op, X, n_warps):
    """Follow the window walk (``gather8_steps`` over the window layout)
    step by step: each block's x segments read from the tile's clamped
    window, zero outside it.  Returns the product and the count of each
    (block-row, column, slot) the walk contracted."""
    blk, win = op.blocks.numpy(), op.window
    ids = win.cols.numpy()
    n_brow, L = ids.shape
    nb = X.shape[0]
    base = spmv_bsr.window_bases(win, op.n_cols, 8).numpy()
    Xp = np.zeros((nb, (max(ids.max() + 1, -(-op.n_cols // 8))) * 8), dtype=X.dtype)
    Xp[:, :op.n_cols] = X
    Y = np.zeros((nb, n_brow * 8), dtype=X.dtype)
    seen = np.zeros((nb, n_brow, L), dtype=int)
    for run in spmv_bsr.gather8_steps(n_brow, L, nb, n_warps):
        acc = {}
        for pair, j0, cnt, l0 in run:
            for brow in (2 * pair, 2 * pair + 1):
                if brow >= n_brow:
                    continue
                part = acc.setdefault(brow, np.zeros((cnt, 8), dtype=X.dtype))
                b0 = base[brow // win.tile_brows]
                for l in range(l0, min(l0 + 4, L)):
                    seen[j0:j0 + cnt, brow, l] += 1
                    if 0 <= ids[brow, l] - b0 < win.width:
                        xs = Xp[j0:j0 + cnt, ids[brow, l] * 8:ids[brow, l] * 8 + 8]
                        part += xs @ blk[brow, l].T
                if l0 + 4 >= L:
                    Y[j0:j0 + cnt, brow * 8:brow * 8 + 8] = acc.pop(brow)
        assert not acc
    return Y[:, :op.n_rows], seen


@pytest.mark.parametrize("nb", [1, 3, 8, 11])
@pytest.mark.parametrize("n,tile_brows,n_warps", [
    (N, 128, 5),          # 125 block-rows: one tile, cut short
    (2000, 128, 16),      # 250 block-rows: the second tile cut short
    (2000, 16, 7)])       # 16 tiles, the last of 10 block-rows
def test_window_walk_covers_every_slot_once(n, tile_brows, n_warps, nb):
    # The window walk: every (block-row, column, slot) is contracted
    # exactly once, and following it gives the window form's product.
    A = phased(random_scattered(2048, 24, seed=4, bandwidth=256, block=8)[:n, :n])
    op = BsrOperator.from_scipy(A, device="cpu")
    assert op.window.tile_brows == 128
    if tile_brows != 128:
        win = spmv_bsr.bsr_window(op.blocks.numpy(), op.block_cols.numpy(),
                                  device="cpu", tile_brows=tile_brows)
        op = dataclasses.replace(op, window=win)
    n_brow = op.blocks.shape[0]
    assert n_brow % op.window.tile_brows != 0
    X = _vectors((nb, n), np.complex128, seed=nb)
    Y, seen = _walk_window_product(op, X, n_warps)
    assert (seen == 1).all()
    want = spmv_bsr.bsr_window_matvec_plain(op.blocks, op.window, torch.from_numpy(X),
                                            op.n_rows).numpy()
    np.testing.assert_allclose(Y, want, rtol=0, atol=1e-12 * np.abs(want).max())


# -- the drivers ----------------------------------------------------------------

def _v0(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


SCHUR_FORCED = {   # JAX's device path on phased mark(20) (n = 210), forced
    "block2": dict(block_size=2, dtype=np.complex128),
    "complex64": dict(dtype=np.complex64, stopping_criterion=1e-5),
    "cgs": dict(ortho="cgs"),
}


@pytest.mark.parametrize("case", sorted(SCHUR_FORCED))
def test_partial_schur_on_complex_bsr_matches_jax(case):
    kw = SCHUR_FORCED[case]
    A = phased(mark(20))
    jop = jax_as_operator(A, format=("bsr", (8, 8)))
    op = port_operator(jop)
    assert op.dtype == torch.complex128
    n = A.shape[0]
    args = dict(max_dim=20, stopping_criterion=TOL, sort_function="LR",
                max_restarts=1000)
    args.update(kw)
    v0 = _v0(n)
    Qj, Tj, hj = jax_partial_schur(jop, 4, v0=v0, **args)
    extra = ({"_start_block": jax_start_block(n, 2, v0, np.complex128)}
             if case == "block2" else {"v0": v0})
    Q, T, h = partial_schur(op, 4, **args, **extra)
    T = to_numpy(T)
    np.testing.assert_array_equal(np.tril(T, -1), 0)
    lam, lam_ref = np.diag(T), np.diag(np.asarray(Tj))
    scale = np.abs(lam_ref).max()
    tol = args["stopping_criterion"]
    atol = (1e-4 if case == "complex64" else 1e-9) * scale
    assert eigenvalues_match(lam, lam_ref, which="LR", rtol=0, atol=atol)
    Qn = to_numpy(Q).astype(np.complex128)
    assert np.linalg.norm(A @ Qn - Qn @ T, axis=0).max() <= 10 * max(tol, 1e-7) * scale
    if case != "complex64":
        assert h.total_matvecs == hj.total_matvecs
        np.testing.assert_array_equal(h.matvecs, hj.matvecs)


@pytest.mark.parametrize("device_loop", [None, False])
def test_partial_eigh_on_hermitian_complex_bsr_matches_jax(device_loop):
    Af = _matrix(n=1024)
    H = ((Af + Af.conj().T) / 2).tocsr()
    jop = jax_as_operator(H, format=("bsr", (8, 8)))
    op = port_operator(jop)
    args = dict(which="LA", max_dim=20, stopping_criterion=TOL,
                v0=_v0(H.shape[0]), device_loop=device_loop)
    vals_ref, _, h_ref = jax_partial_eigh(jop, 4, **args)
    vals, V, h = partial_eigh(op, 4, **args)
    assert V.dtype == torch.complex128
    np.testing.assert_allclose(vals, np.asarray(vals_ref), rtol=0,
                               atol=1e-9 * np.abs(vals_ref).max())
    Vn = to_numpy(V)
    assert np.linalg.norm(H @ Vn - Vn * vals[None, :], axis=0).max() \
        <= 10 * TOL * np.abs(vals).max()
    assert h.total_matvecs == h_ref.total_matvecs


def test_svds_of_a_complex_bsr_operator_matches_jax():
    A = _matrix(n=1024, bandwidth=64)[:, :800]
    jop = jax_as_operator(A, format=("bsr", (8, 8)))
    op = port_operator(jop)
    U_ref, s_ref, _ = jax_svds(jop, 4, which="LM", tol=TOL, ncv=20)
    U, s, Vh = svds(op, 4, which="LM", tol=TOL, ncv=20)
    assert U.dtype == Vh.dtype == torch.complex128
    np.testing.assert_allclose(s, s_ref, rtol=1e-9, atol=0)
    Un, Vn = to_numpy(U), to_numpy(Vh).conj().T
    np.testing.assert_allclose(np.linalg.norm(A @ Vn - Un * s, axis=0), 0,
                               atol=1e-8 * s.max())
    np.testing.assert_allclose(np.linalg.norm(A.conj().T @ Un - Vn * s, axis=0),
                               0, atol=1e-8 * s.max())


# -- on the card ----------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("shape", [(8, 8), (4, 4)])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8, 11])
def test_complex_bsr_kernels_match_plain_on_the_card(b, shape, dtype,
                                                     cuda_device):
    """Both complex BSR kernels against their plain versions on the card
    (normwise 1e-12 complex128, 1e-5 complex64); every column of a
    b-column form bit for bit against the single-column kernel (8 x 8 at b
    >= 2: the window walk)."""
    limit = 1e-12 if dtype == torch.complex128 else 1e-5
    op = as_operator(_matrix(), dtype=dtype, format=("bsr", shape),
                     device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(b)
    X = torch.randn(b, N, generator=gen, device=cuda_device, dtype=dtype)
    blk, ids, win, nr = op.blocks, op.block_cols, op.window, op.n_rows
    want = spmv_bsr.bsr_matvec_plain(blk, ids, X, nr)
    for got, single in (
            (spmv_bsr.bsr_matmat(blk, ids, X, nr),
             lambda j: spmv_bsr.bsr_matvec(blk, ids, X[j], nr)),
            (spmv_bsr.bsr_window_matmat(blk, win, X, nr),
             lambda j: spmv_bsr.bsr_window_matvec(blk, win, X[j], nr))):
        torch.cuda.synchronize()
        assert float((got - want).norm() / want.norm()) <= limit
        assert all(torch.equal(got[j], single(j)) for j in range(b))
