"""The Markov random walk ``mark(m)`` on the port's ELL path, held to the
plain PyTorch reference of ``plain_markov.py`` on the CPU.

The benchmark's ``mark1000-schur-lr`` cell runs this solve at m = 1000:
``partial_schur`` LR, nev 5, max_dim 40, CGS2, on ``as_operator(mark(m),
format="ell")``.  Here it runs at m = 60 (n = 1,830) from seeded starts,
which stand in for weights.  No JAX.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import arnoldi_tpu_torch as port
from arnoldi_tpu_torch import matrices
from portbench import generators

import plain_markov as plain

pytestmark = pytest.mark.filterwarnings("ignore:Sparse:UserWarning")

#: The tolerances of the solve against the plain reference, for
#: ``stopping_criterion = 1e-8``:
#:
#: * ``value_err`` (an eigenvalue of T from its nearest dense eigenvalue,
#:   over the radius): 1e-8, the stopping criterion.  mark(m) is similar to
#:   a symmetric matrix (the walk is reversible), so a Ritz value lies
#:   within about its residual of an eigenvalue; float64 reads 4e-10 to
#:   7e-10 on the seeds below, float32 3e-8.
#: * ``residual`` (a column of ``A Q - Q T`` over the radius): twice the
#:   stopping criterion.  The solve stops on the Ritz estimate
#:   ``|h_{m+1,m} s_m| <= 1e-8 |lambda|``, which the true residual follows
#:   to rounding; float64 reads up to 9.9e-9, float32 5e-7.
#: * ``orth`` (``|Q^T Q - I|``): 1e-12, a thousand times float64's
#:   rounding at n = 1,830 (reads ~1e-14); float32 reads 1e-7.
TOL = {"value_err": 1e-8, "residual": 2e-8, "orth": 1e-12}

SEEDS = (1, 2**33 + 5, 20261018)


def _frozen_mark(m):
    return generators.build({"generator": "mark", "args": {"m": m},
                             "dtype": "float64"})


@pytest.mark.parametrize("m", [2, 3, 10, 60])
def test_the_plain_mark_equals_both_generators(m):
    A = plain.mark(m).to_dense().numpy()
    assert A.shape == (m * (m + 1) // 2,) * 2
    np.testing.assert_array_equal(A, _frozen_mark(m).toarray())
    np.testing.assert_array_equal(A, matrices.mark(m).toarray())
    # a transition matrix acting on distributions: every column sums to one
    np.testing.assert_allclose(A.sum(axis=0), 1.0, rtol=0, atol=1e-15)


def test_the_ell_matvec_equals_the_plain_product():
    """rtol 1e-14 in norm: an entry is a sum of at most four products,
    which the two products may round in another order; entries near zero
    by cancellation differ relatively more, so the test is norm-wise."""
    A = plain.mark(60)
    op = port.as_operator(matrices.mark(60), format="ell", device="cpu")
    assert type(op).__name__ == "EllOperator"
    g = torch.Generator().manual_seed(3)
    x = torch.randn(op.shape[0], dtype=torch.float64, generator=g)
    want = plain.apply(A, x)
    got = op.matvec(x)
    assert float(torch.linalg.vector_norm(got - want)) <= 1e-14 * float(
        torch.linalg.vector_norm(want))
    X = torch.randn(4, op.shape[0], dtype=torch.float64, generator=g)
    want = plain.apply(A, X.T).T
    got = op.matmat_rows(X)
    assert float(torch.linalg.vector_norm(got - want)) <= 1e-14 * float(
        torch.linalg.vector_norm(want))


def _within(numbers):
    return all(numbers[name] <= TOL[name] for name in TOL)


def _numbers(A, values, Q, T):
    value_err, residual, orth = plain.schur_numbers(A, Q, T, values)
    return {"value_err": value_err, "residual": residual, "orth": orth}


def _returned_are_the_wanted(values, T, k):
    """The eigenvalues of T are the ``k`` of largest real part (a pair cut
    at k kept whole), each within the value tolerance."""
    lam = sorted(torch.linalg.eigvals(T.to(torch.float64)).tolist(),
                 key=lambda v: (-v.real, v.imag))
    want = sorted(plain.wanted_lr(values, k), key=lambda v: (-v.real, v.imag))
    rad = plain.radius(values)
    return len(lam) == len(want) and all(
        abs(a - b) <= TOL["value_err"] * rad for a, b in zip(lam, want))


@pytest.fixture(scope="module")
def mark60():
    A = plain.mark(60)
    return A, plain.eig_dense(A), port.as_operator(matrices.mark(60), format="ell",
                                                   device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_partial_schur_lr_matches_the_plain_reference(mark60, seed):
    A, values, op = mark60
    Q, T, hist = port.partial_schur(
        op, 5, sort_function="LR", max_dim=40, stopping_criterion=1e-8,
        ortho="cgs2", max_restarts=2000, generator=torch.Generator().manual_seed(seed))
    assert Q.dtype == torch.float64 and Q.shape == (op.shape[0], 5)
    numbers = _numbers(A, values, Q, T)
    assert _within(numbers), numbers
    assert _returned_are_the_wanted(values, T, 5)
    # lambda_1 of a transition matrix is 1
    assert abs(max(torch.linalg.eigvals(T).real.tolist()) - 1.0) <= 1e-8


@pytest.mark.parametrize("seed", SEEDS)
def test_the_float32_solve_fails_the_tolerances(mark60, seed):
    """The same solve in float32 without the float64 continuation: the
    tolerances are tighter than float32 can meet."""
    A, values, op = mark60
    Q, T, _ = port.partial_schur(
        op, 5, sort_function="LR", max_dim=40, stopping_criterion=1e-8,
        ortho="cgs2", max_restarts=2000, dtype=torch.float32, refine=None,
        generator=torch.Generator().manual_seed(seed))
    assert Q.dtype == torch.float32
    numbers = _numbers(A, values, Q, T)
    assert not _within(numbers), numbers


def _pair_at_the_cut(n=40):
    """A non-symmetric ``(n, n)`` matrix whose eigenvalues of largest real
    part are 1, 0.9, 0.8, 0.7 and then the pair 0.6 +- 0.2i: a Schur form
    of five pairs has to cut the pair's 2x2 block, so the solve returns
    six."""
    B = torch.zeros((n, n), dtype=torch.float64)
    for i, v in enumerate((1.0, 0.9, 0.8, 0.7)):
        B[i, i] = v
    B[4:6, 4:6] = torch.tensor([[0.6, 0.2], [-0.2, 0.6]], dtype=torch.float64)
    for i in range(6, n):
        B[i, i] = 0.5 * (n - i) / n
    g = torch.Generator().manual_seed(0)
    S = torch.eye(n, dtype=torch.float64) + 0.2 * torch.randn(
        (n, n), dtype=torch.float64, generator=g) / n ** 0.5
    return S @ B @ torch.linalg.inv(S)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_pair_straddling_the_cut_returns_nev_plus_one(seed):
    D = _pair_at_the_cut()
    values = plain.eig_dense(D)
    A = D.to_sparse_csr()
    op = port.as_operator(sp.csr_matrix(D.numpy()), format="ell", device="cpu")
    Q, T, _ = port.partial_schur(
        op, 5, sort_function="LR", max_dim=20, stopping_criterion=1e-8,
        ortho="cgs2", generator=torch.Generator().manual_seed(seed))
    assert Q.shape == (D.shape[0], 6) and T.shape == (6, 6)
    # T is quasi-triangular: the pair is the 2x2 block in its last rows
    assert T[5, 4] != 0 and torch.all(torch.tril(T, -1)[:5] == 0)
    numbers = _numbers(A, values, Q, T)
    assert _within(numbers), numbers
    assert _returned_are_the_wanted(values, T, 5)
