"""The port's ``partial_schur`` against the JAX package's device path.

On the CPU, JAX's float64 solve would go to its host tier, so the JAX side
runs ``as_operator(A, backend="pallas")`` with ``ortho="cgs2_pallas"``: the
device path with its Pallas kernels in interpret mode.  The port runs on
the same operator arrays (carried over by ``arnoldi_tpu_torch.convert``),
the same start vector and the same ``ortho=`` value, on CPU tensors.

Tolerances: Hungarian-matched eigenvalues within 1e-9 * max|lambda|;
Schur residuals within 10 * tol * max|lambda|; T quasi-triangular; matvec
counts EQUAL (both run the same restart policy on the same data, so their
bases differ by rounding alone).
"""

import numpy as np
import pytest
import torch

from arnoldi_tpu import partial_schur as jax_partial_schur
from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import (
    laplace_2d,
    mark,
    random_scattered,
    random_scattered_complex_pairs,
)
from arnoldi_tpu_torch import (
    as_operator,
    eigenpairs_from_partial_schur,
    partial_schur,
)
from arnoldi_tpu_torch.convert import workspace_from_reference
from common import find_best_matching
from torch_parity import (
    assert_quasi_triangular,
    port_operator,
    schur_residuals,
    to_numpy,
)

torch.set_num_threads(1)

TOL = 1e-10

CASES = {
    "laplace_2d_16x15_LM": (lambda: laplace_2d(16, 15), 4, "LM"),
    "scattered_4096_LR": (lambda: random_scattered(4096, 24, seed=1,
                                                   bandwidth=256, block=8),
                          5, "LR"),
    "mark40_LR": (lambda: mark(40), 5, "LR"),
    "complex_pairs_LR": (lambda: random_scattered_complex_pairs(
        1024, 8, seed=0, bandwidth=64), 4, "LR"),
}


def _both(case, nev=None, **kw):
    gen, case_nev, which = CASES[case]
    nev = case_nev if nev is None else nev
    A = gen()
    v0 = np.random.default_rng(0).standard_normal(A.shape[0])
    jop = jax_as_operator(A, backend="pallas")
    args = dict(max_dim=20, stopping_criterion=TOL, sort_function=which,
                max_restarts=1000, dtype=np.float64, ortho="cgs2_pallas",
                v0=v0)
    args.update(kw)
    ref = jax_partial_schur(jop, nev, **args)
    got = partial_schur(port_operator(jop), nev, **args)
    return A, ref, got


def _assert_parity(A, ref, got):
    (Qj, Tj, hj), (Q, T, h) = ref, got
    assert tuple(Q.shape) == tuple(np.shape(Qj))
    assert tuple(T.shape) == tuple(np.shape(Tj))
    lam = np.linalg.eigvals(to_numpy(T))
    lam_ref = np.linalg.eigvals(np.asarray(Tj))
    scale = np.abs(lam_ref).max()
    a, b = find_best_matching(lam, lam_ref)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * scale)
    assert schur_residuals(A, Q, T).max() <= 10 * TOL * scale
    assert_quasi_triangular(T)
    assert h.total_matvecs == hj.total_matvecs
    assert len(h.residual_trace) == len(hj.residual_trace)
    np.testing.assert_array_equal(h.matvecs, hj.matvecs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_device_path(case):
    A, ref, got = _both(case)
    _assert_parity(A, ref, got)


def test_complex_pairs_use_2x2_blocks():
    A, ref, (Q, T, h) = _both("complex_pairs_LR")
    lam = np.linalg.eigvals(to_numpy(T))
    assert np.all(np.abs(lam.imag) > 0.1)       # two conjugate pairs
    assert np.count_nonzero(np.diag(to_numpy(T), -1)) == 2


def test_straddling_pair_returns_nev_plus_one():
    # nev=3 cuts the second conjugate pair: ARPACK's k+1 contract.
    A, ref, got = _both("complex_pairs_LR", nev=3)
    assert got[1].shape == (4, 4)
    _assert_parity(A, ref, got)


@pytest.mark.parametrize("lock,p", [("hard", None), ("soft", 10), ("hard", 10)])
def test_lock_and_explicit_p_match_jax(lock, p):
    A, ref, got = _both("mark40_LR", lock=lock, p=p)
    _assert_parity(A, ref, got)


@pytest.mark.parametrize("ortho", ["cgs_dgks", "cgs"])
def test_other_orthos_converge(ortho):
    A = laplace_2d(16, 15)
    Q, T, h = partial_schur(A, 4, max_dim=20, stopping_criterion=TOL,
                            ortho=ortho, device="cpu", max_restarts=1000)
    lam = np.linalg.eigvals(to_numpy(T))
    assert schur_residuals(A, Q, T).max() <= 10 * TOL * np.abs(lam).max()
    Qn = to_numpy(Q)
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(4), atol=1e-12)


def test_happy_breakdown_supported():
    # A start vector spanning an invariant subspace of dimension 4.
    D = np.diag(np.arange(1.0, 11.0))
    v0 = np.zeros(10)
    v0[:4] = 1
    Q, T, _ = partial_schur(D, 2, max_dim=8, sort_function="LR",
                            max_restarts=10, v0=v0, device="cpu")
    np.testing.assert_allclose(schur_residuals(D, Q, T), 0, atol=1e-7)
    np.testing.assert_allclose(np.sort(np.diag(to_numpy(T))), [3, 4],
                               atol=1e-7)


def test_float32_solve():
    A = mark(20)
    Q, T, _ = partial_schur(A, 3, sort_function="LR", stopping_criterion=1e-5,
                            dtype=np.float32, device="cpu", max_restarts=500)
    assert Q.dtype == torch.float32 and T.dtype == torch.float32
    lam = np.linalg.eigvals(to_numpy(T))
    assert schur_residuals(A, Q.double(), T.double()).max() < 1e-4
    np.testing.assert_allclose(np.sort(lam.real)[-1], 1.0, atol=1e-5)


def test_eigenpairs_match_jax():
    A = mark(40)
    Q, T, _ = partial_schur(A, 5, max_dim=20, stopping_criterion=TOL,
                            sort_function="LR", device="cpu")
    vals, vecs = eigenpairs_from_partial_schur(Q, T)
    from arnoldi_tpu import eigenpairs_from_partial_schur as jax_eigenpairs

    vals_ref, _ = jax_eigenpairs(to_numpy(Q), to_numpy(T))
    a, b = find_best_matching(vals, vals_ref)
    np.testing.assert_allclose(a, b, atol=1e-12)
    V = to_numpy(vecs)
    np.testing.assert_allclose(np.linalg.norm(V, axis=0), 1, atol=1e-12)
    res = np.linalg.norm(A @ V - V * vals[None, :], axis=0)
    assert res.max() < 1e-8


def test_generator_makes_the_start_vector():
    A = mark(15)
    runs = [partial_schur(A, 3, sort_function="LR", device="cpu",
                          generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2].residual_trace != runs[2][2].residual_trace


def test_workspace_from_reference():
    Vt, H, v0 = workspace_from_reference(np.eye(3, 5), np.zeros((3, 2)),
                                         np.ones(5), device="cpu")
    assert Vt.shape == (3, 5) and H.shape == (3, 2) and v0.dtype == torch.float64


def test_non_convergence_raises():
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(mark(10), 3, max_dim=5, stopping_criterion=1e-14,
                      max_restarts=2, device="cpu")


def test_host_input_needs_a_device():
    with pytest.raises(ValueError, match="device="):
        partial_schur(mark(10), 3)


@pytest.mark.parametrize("kwargs", [
    dict(dtype=np.complex128),
    dict(mesh=object()),
    dict(checkpoint_path="run.npz"),
    dict(resume=True),
    dict(refine="dw"),
    dict(dtype=np.float32, stopping_criterion=1e-8),     # JAX would refine
    dict(ortho="mgs_dgks"),
    dict(v0=np.ones(55, np.complex128)),
], ids=lambda kw: next(iter(kw)))
def test_outside_the_slice_raises(kwargs):
    op = as_operator(mark(10), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        partial_schur(op, 3, **kwargs)


def test_float32_on_cuda_refuses_tf32():
    from arnoldi_tpu_torch.device import check_matmul_precision

    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")     # allows TF32
        with pytest.raises(RuntimeError, match="TF32"):
            check_matmul_precision(torch.float32, "cuda")
        check_matmul_precision(torch.float64, "cuda")
        check_matmul_precision(torch.float32, "cpu")
    finally:
        torch.set_float32_matmul_precision(saved)
    check_matmul_precision(torch.float32, "cuda")
