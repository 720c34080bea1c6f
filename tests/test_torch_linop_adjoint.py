"""The rest of the port's operator layer against the JAX package's, on the
CPU: ``rmatvec``/``rmatmat`` of every format by both routes (the plain
scatter-adds and the materialized transpose the card runs, forced here by
the private ``_transposed=True``), ``GramOperator`` in both orientations,
``pad_operator``, ``operator_from_reference`` for a Gram, and SciPy
``LinearOperator`` input to both drivers.

Both packages get the same operator arrays (``torch_parity.port_operator``).
Tolerances: adjoint and Gram products within rtol 1e-12 (float64 sums in
another order); the padded operators' products equal; matvec counts of the
SciPy ``LinearOperator`` solves EQUAL to JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import aslinearoperator

from arnoldi_tpu import partial_eigh as jax_partial_eigh
from arnoldi_tpu import partial_schur as jax_partial_schur
from arnoldi_tpu.linop import GramOperator as JaxGramOperator
from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.linop import pad_operator as jax_pad_operator
from arnoldi_tpu.linop import rmatmat as jax_rmatmat
from arnoldi_tpu.linop import rmatvec as jax_rmatvec
from arnoldi_tpu.matrices import laplace_2d, mark
from arnoldi_tpu.solvers.svd import gram_companions as jax_gram_companions
from arnoldi_tpu_torch import (CallableOperator, GramOperator, as_operator,
                               partial_eigh, partial_schur, pad_operator,
                               rmatmat, rmatvec)
from arnoldi_tpu_torch.convert import operator_from_reference
from arnoldi_tpu_torch.linop import adjoint_operator, cast_operator
from arnoldi_tpu_torch.solvers.decomposition import arnoldi_expand
from torch_parity import port_operator, reference_leaves

torch.set_num_threads(1)


def _banded(n=40, seed=0):
    rng = np.random.default_rng(seed)
    offs = (-3, -1, 0, 2)
    return sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs,
                    format="csr")


def _rect(rows, cols, seed):
    return sp.random(rows, cols, density=0.15, format="csr",
                     random_state=np.random.RandomState(seed))


# name: (matrix, JAX format)
CASES = {
    "dense_rect": (lambda: np.random.default_rng(1).standard_normal((30, 20)),
                   None),
    "ell_square": (lambda: mark(20), "ell"),
    "ell_rect": (lambda: _rect(50, 70, 2), "ell"),
    "banded": (_banded, "banded"),
    "bsr_square_210": (lambda: mark(20), ("bsr", (8, 8))),   # n % 8 != 0
    "bsr_rect": (lambda: _rect(48, 30, 6), ("bsr", (8, 8))),
    "bsr_rect_4x4": (lambda: _rect(37, 50, 7), ("bsr", (4, 4))),
}


def _pair(case):
    gen, fmt = CASES[case]
    A = gen()
    jop = jax_as_operator(A, format=fmt)
    return A, jop, port_operator(jop)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_adjoint_products_match_jax(case, transposed):
    A, jop, op = _pair(case)
    rng = np.random.default_rng(3)
    y = rng.standard_normal(A.shape[0])
    Y = rng.standard_normal((A.shape[0], 3))
    got = rmatvec(op, torch.from_numpy(y), _transposed=transposed)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_rmatvec(jop, y)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), A.T @ y, rtol=1e-12, atol=1e-12)
    got = rmatmat(op, torch.from_numpy(Y), _transposed=transposed)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_rmatmat(jop, Y)),
                               rtol=1e-12, atol=1e-12)
    # two calls give equal bits: no order depends on timing
    again = rmatmat(op, torch.from_numpy(Y), _transposed=transposed)
    assert torch.equal(got, again)


@pytest.mark.parametrize("case", ["ell_rect", "banded", "bsr_rect"])
def test_materialized_adjoint_is_built_once(case):
    A, _, op = _pair(case)
    adj = adjoint_operator(op)
    assert adjoint_operator(op) is adj and type(adj) is type(op)
    assert adj.shape == (A.shape[1], A.shape[0]) and adj.nnz == op.nnz
    np.testing.assert_allclose(adj.matmat(torch.eye(A.shape[0],
                                                    dtype=torch.float64)).numpy(),
                               np.asarray(sp.csr_matrix(A).T.todense()),
                               atol=1e-15)
    # a cast is a new operator and starts without it
    assert "adjoint" not in cast_operator(op, torch.float32)._cache


def test_adjoint_refuses_hub_columns_and_closures():
    # one dense column of A is one dense row of A^H: no padded layout
    n = 5000
    A = sp.csr_matrix((np.ones(n), (np.arange(n), np.zeros(n, int))),
                      shape=(n, n)) + sp.eye(n, format="csr")
    op = as_operator(A, format="ell", device="cpu")
    with pytest.raises(ValueError, match="layout"):
        rmatvec(op, torch.ones(n, dtype=torch.float64), _transposed=True)
    fn = CallableOperator(lambda x: x, (3, 3), torch.float64, device="cpu")
    with pytest.raises(TypeError, match="adjoint"):
        rmatvec(fn, torch.ones(3, dtype=torch.float64))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("case", ["dense_rect", "ell_rect", "bsr_rect"])
def test_gram_matches_jax(case, transposed):
    A, jop, op = _pair(case)
    jgram = JaxGramOperator(jop, transposed=transposed)
    d = jgram.shape[0]
    rng = np.random.default_rng(4)
    x, X = rng.standard_normal(d), rng.standard_normal((d, 4))
    want, want_mat = np.asarray(jgram.matvec(x)), np.asarray(jgram.matmat(X))
    opT = as_operator(sp.csr_matrix(A).T.tocsr() if sp.issparse(A) else
                      np.ascontiguousarray(A.T), device="cpu")
    for gram in (GramOperator(op, transposed=transposed),
                 GramOperator(op, opT, transposed=transposed)):
        assert gram.shape == jgram.shape and gram.has_dw
        np.testing.assert_allclose(gram.matvec(torch.from_numpy(x)).numpy(),
                                   want, rtol=1e-12)
        np.testing.assert_allclose(gram.matmat(torch.from_numpy(X)).numpy(),
                                   want_mat, rtol=1e-12)
        rows = gram.matmat_rows(torch.from_numpy(np.ascontiguousarray(X.T)))
        np.testing.assert_allclose(rows.numpy().T, want_mat, rtol=1e-12)
    g32 = cast_operator(GramOperator(op, opT, transposed=transposed),
                        torch.float32)
    assert g32.op.dtype == g32.opT.dtype == torch.float32


@pytest.mark.parametrize("case", ["dense_square", "ell_square", "banded",
                                  "bsr_square_210"])
def test_pad_operator_matches_jax(case):
    A = np.random.default_rng(5).standard_normal((20, 20)) \
        if case == "dense_square" else CASES[case][0]()
    fmt = None if case == "dense_square" else CASES[case][1]
    jop = jax_as_operator(A, format=fmt)
    n = A.shape[0]
    n_pad = -(-(n + 5) // 8) * 8
    op, jpad = pad_operator(port_operator(jop), n_pad), jax_pad_operator(jop, n_pad)
    assert op.shape == jpad.shape == (n_pad, n_pad)
    x = np.random.default_rng(6).standard_normal(n_pad)
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jpad.matvec(jnp.asarray(x))),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(y[:n], A @ x[:n], rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(y[n:], 0)
    # a solve on the padded operator builds the unpadded H (diag(A, 0))
    m = 8
    v0 = np.random.default_rng(7).standard_normal(n)
    Hs = []
    for target, size in ((port_operator(jop), n), (op, n_pad)):
        Vt = torch.zeros((m + 1, size), dtype=torch.float64)
        Vt[0, :n] = torch.from_numpy(v0 / np.linalg.norm(v0))
        H = torch.zeros((m + 1, m), dtype=torch.float64)
        Hs.append(arnoldi_expand(target, Vt, H, ortho="cgs2")[1].numpy())
    np.testing.assert_allclose(Hs[1], Hs[0], rtol=1e-12, atol=1e-12)


def test_gram_from_reference_sums_the_cast_residual_legs():
    # JAX's float32 Gram carries the cast residuals lo/loT; the port's legs
    # hold op + lo and opT + loT: the float64 matrix again.
    A = (mark(20)[:, :150] * np.pi).tocsr()
    jop = jax_as_operator(A, dtype=np.float32)
    opT, lo, loT = jax_gram_companions(A, jop)
    jgram = JaxGramOperator(jop, opT, lo, loT)
    gram = operator_from_reference(*reference_leaves(jgram), device="cpu")
    assert isinstance(gram, GramOperator) and not gram.transposed
    assert gram.op.dtype == gram.opT.dtype == torch.float64
    x = np.random.default_rng(8).standard_normal(A.shape[1])
    got = gram.matvec(torch.from_numpy(x)).numpy()
    want = A.T @ (A @ x)
    np.testing.assert_allclose(got, want, rtol=1e-13 * 10, atol=1e-13)
    with pytest.raises(TypeError, match="closure"):
        operator_from_reference("CallableOperator", [], (), device="cpu")


@pytest.mark.parametrize("driver", ["partial_schur", "partial_eigh"])
def test_scipy_linear_operator_matches_jax(driver):
    # SciPy LinearOperator input: a host matvec on both sides (JAX through
    # pure_callback, the port through a CallableOperator), the device path.
    if driver == "partial_schur":
        A, kw = mark(20), dict(sort_function="LR", max_dim=20)
        jax_fn, fn = jax_partial_schur, partial_schur
    else:
        A, kw = laplace_2d(12, 11), dict(which="LA", max_dim=20)
        jax_fn, fn = jax_partial_eigh, partial_eigh
    # dtype: JAX's device path on the CPU would otherwise work in complex128
    kw.update(stopping_criterion=1e-10, max_restarts=1000, dtype=np.float64,
              v0=np.random.default_rng(0).standard_normal(A.shape[0]))
    *_, hj = jax_fn(aslinearoperator(A), 3, **kw)
    *_, h = fn(aslinearoperator(A), 3, device="cpu", **kw)
    assert h.total_matvecs == hj.total_matvecs
    np.testing.assert_array_equal(h.matvecs, hj.matvecs)
