"""The port's inner Krylov solvers (``arnoldi_tpu_torch/solvers/inner.py``)
against ``jax.scipy.sparse.linalg``'s ``cg``, ``bicgstab`` and ``gmres``
(``solve_method="batched"``), the solvers the JAX package's shift-invert
operators call.

Both get the same float64 or complex128 system from a seed and stop after
``maxiter`` = 1, 3 and 10 iterations (restart cycles for gmres) or at
convergence; the iterates must agree within 1e-12 relative, which pins the
recurrences, the tolerance rules and the stopping tests.  The cases add a
Jacobi preconditioner and two exact bicgstab breakdowns (codes -10 and
-11, found on small integer systems), where both stop on the same
iterate without raising.  ``SolveInfo.matvecs`` is held against the calls
the matvec really received.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.scipy.sparse import linalg as jax_linalg

from arnoldi_tpu.matrices import laplace, mark
from arnoldi_tpu_torch.solvers import inner

torch.set_num_threads(1)

RTOL = 1e-12


def _gauge(A, seed=3):
    """``G A G^H`` with ``G = diag(e^{i theta})``: complex, A's spectrum."""
    g = np.exp(1j * np.random.default_rng(seed).uniform(0, 2 * np.pi, A.shape[0]))
    return (g[:, None] * A) * g.conj()[None, :]


def _matrix(problem):
    if problem == "definite":          # laplace(60) - I: spectrum in (-5, -1)
        return laplace(60).toarray() - np.eye(60)
    if problem == "nonsymmetric":      # mark(12) - 1.5 I, n = 78
        return mark(12).toarray() - 1.5 * np.eye(78)
    if problem == "hermitian":         # complex128, Hermitian definite
        return _gauge(laplace(60).toarray() - np.eye(60))
    if problem == "complex":           # complex128, non-Hermitian
        return np.exp(0.5j) * _gauge(mark(12).toarray() - 1.5 * np.eye(78))
    raise KeyError(problem)


# problem -> the solvers that take it (cg needs a Hermitian definite matrix)
SOLVERS = {"definite": ("cg", "bicgstab", "gmres"),
           "nonsymmetric": ("bicgstab", "gmres"),
           "hermitian": ("cg", "bicgstab", "gmres"),
           "complex": ("bicgstab", "gmres")}
MAXITER = (1, 3, 10, None)   # None: to convergence (the solvers' default budget)


def _rhs(n, complex_):
    rng = np.random.default_rng(n)
    b = rng.standard_normal(n)
    return b + 1j * rng.standard_normal(n) if complex_ else b


def _keywords(solver, maxiter, restart):
    kw = dict(tol=1e-10, maxiter=maxiter)
    if solver == "gmres":
        kw["restart"] = restart
    return kw


@functools.lru_cache(maxsize=None)
def _jax_solution(problem, solver, maxiter, restart, preconditioned):
    A = _matrix(problem)
    b = _rhs(A.shape[0], np.iscomplexobj(A))
    Aj = jnp.asarray(A)
    M = None
    if preconditioned:
        d = jnp.asarray(1.0 / np.diag(A))
        M = lambda v: d * v     # noqa: E731
    x, _ = getattr(jax_linalg, solver)(lambda v: Aj @ v, jnp.asarray(b), M=M,
                                       **_keywords(solver, maxiter, restart))
    return np.asarray(x)


def _port_solution(problem, solver, maxiter, restart, preconditioned):
    A = torch.from_numpy(_matrix(problem))
    b = torch.from_numpy(_rhs(A.shape[0], A.is_complex()))
    calls = []

    def matvec(v):
        calls.append(1)
        return A @ v

    M = None
    if preconditioned:
        d = 1.0 / torch.diagonal(A)
        M = lambda v: d * v     # noqa: E731
    x, info = getattr(inner, solver)(matvec, b, M=M,
                                     **_keywords(solver, maxiter, restart))
    assert info.matvecs == len(calls)
    return x.numpy(), info, A.numpy(), b.numpy()


def _relative(x, want):
    return np.linalg.norm(x - want) / np.linalg.norm(want)


CASES = [(problem, solver, maxiter) for problem, solvers in SOLVERS.items()
         for solver in solvers for maxiter in MAXITER]


@pytest.mark.parametrize("problem,solver,maxiter", CASES,
                         ids=[f"{p}-{s}-{m or 'converged'}" for p, s, m in CASES])
def test_iterates_match_jax(problem, solver, maxiter):
    restart = 5     # gmres: several cycles before convergence
    x, info, A, b = _port_solution(problem, solver, maxiter, restart, False)
    want = _jax_solution(problem, solver, maxiter, restart, False)
    assert _relative(x, want) <= RTOL
    assert info.status == 0
    converged = np.linalg.norm(A @ x - b) <= 1e-10 * np.linalg.norm(b) * 1.01
    if maxiter is None:
        assert converged
    else:   # stopped by the budget, or converged inside it
        assert info.iterations == maxiter or (info.iterations < maxiter
                                              and converged)


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "gmres"])
@pytest.mark.parametrize("maxiter", [3, None], ids=["3", "converged"])
def test_preconditioned_iterates_match_jax(solver, maxiter):
    x, info, A, b = _port_solution("definite", solver, maxiter, 5, True)
    assert _relative(x, _jax_solution("definite", solver, maxiter, 5, True)) <= RTOL
    if maxiter is None:
        # gmres's test is on the preconditioned residual ||M r||
        assert np.linalg.norm(A @ x - b) <= 1e-9 * np.linalg.norm(b)


@pytest.mark.parametrize("problem", ["definite", "complex"])
def test_gmres_shift_invert_window(problem):
    # restart 80 (the shift-invert operators' window) exceeds n: restart = n
    x, info, _, _ = _port_solution(problem, "gmres", None, 80, False)
    assert _relative(x, _jax_solution(problem, "gmres", None, 80, False)) <= RTOL
    assert info.iterations == 1 and info.matvecs == _matrix(problem).shape[0] + 2


BREAKDOWNS = {   # status -> (A, b): rho = 0 (-10) and omega = 0 (-11) at step 2
    -10: ([[-1.0, 2.0, -1.0], [-1.0, -2.0, -2.0], [1.0, -1.0, 2.0]],
          [0.0, 2.0, 0.0]),
    -11: ([[-2.0, -2.0, -2.0], [-1.0, -2.0, -2.0], [-1.0, 1.0, 0.0]],
          [-1.0, 2.0, 1.0]),
}


@pytest.mark.parametrize("status", sorted(BREAKDOWNS))
def test_bicgstab_breakdown_stops_like_jax(status):
    A, b = (np.array(a) for a in BREAKDOWNS[status])
    Aj, At = jnp.asarray(A), torch.from_numpy(A)
    want, _ = jax_linalg.bicgstab(lambda v: Aj @ v, jnp.asarray(b), tol=1e-12,
                                  maxiter=20)
    x, info = inner.bicgstab(lambda v: At @ v, torch.from_numpy(b), tol=1e-12,
                             maxiter=20)
    assert info.status == status and info.iterations == 2
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=RTOL, atol=0)
    assert np.linalg.norm(A @ x.numpy() - b) > 1e-6     # stopped, not solved


def test_solvers_take_a_zero_rhs_and_x0():
    A = torch.from_numpy(_matrix("definite"))
    b = torch.zeros(60, dtype=torch.float64)
    for solver in ("cg", "bicgstab", "gmres"):
        x, info = getattr(inner, solver)(lambda v: A @ v, b, tol=1e-10)
        assert torch.count_nonzero(x) == 0 and info.iterations == 0
    # an exact start stops before the first iteration
    rhs = torch.from_numpy(_rhs(60, False))
    x_exact = torch.linalg.solve(A, rhs)
    x, info = inner.cg(lambda v: A @ v, rhs, x_exact, tol=1e-8)
    assert info.iterations == 0 and torch.equal(x, x_exact)


def test_sparse_operator_matvec_matches_dense():
    # the shift-invert operators hand the solvers an operator's matvec
    from arnoldi_tpu_torch import as_operator

    S = (laplace(60) - sp.eye(60)).tocsr()
    op = as_operator(S, device="cpu")
    b = torch.from_numpy(_rhs(60, False))
    x, _ = inner.cg(op.matvec, b, tol=1e-12)
    want = _jax_solution("definite", "cg", None, 5, False)
    # a 1e-10 solve and a 1e-12 solve of the same system
    assert _relative(x.numpy(), want) <= 1e-9
