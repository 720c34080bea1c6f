"""The port's shift-invert operators and ``eigs``/``eigsh`` against the JAX
package's (``arnoldi_tpu/solvers/spectral_transform.py``), on every case of
``tests/test_spectral_transform.py``.

``shift_invert_operator``: each inner solver's matvec against JAX's, and
``InnerSolveStats`` against JAX's ``count_inner`` counters.  JAX's counter
is a ``jax.debug.callback`` in the shifted matvec, and for bicgstab and
gmres it fires once per solve more than the solver applies the matvec:
``custom_linear_solve`` transposes a matvec it cannot take as symmetric,
and that trace stages the argument-free callback once more into the
computation that runs.  The port counts the products its solvers report,
so its count is JAX's less one per solve there (cg, symmetric, is equal).

The drivers: both packages solve the same case (the same matrix, shift,
tolerance and ``v0`` where the case has one; JAX's ``key`` and the port's
``generator`` draw different start vectors otherwise), and the port's
values must match JAX's with ``eigenvalues_match`` at rtol 1e-8 for the
solves to tol <= 1e-9, and the case's reference as JAX's test holds it;
vectors are held by their residuals.  JAX's results are computed once per
case and module.  Cases of JAX's slow tier (the interior gmres solve, the
realified adversarial and complex-v0 cases) are held against the dense
reference only, and the gmres one at laplace(120) rather than 400: the
restarted solves take 35,000 inner products an application there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from arnoldi_tpu.harness.suite import eigenvalues_match
from arnoldi_tpu.matrices import laplace, laplace_2d, laplace_eigen, mark
from arnoldi_tpu.solvers import spectral_transform as jst
from arnoldi_tpu_torch import (BsrOperator, as_operator, eigs, eigs_realified,
                               eigsh, shift_invert_operator)
from arnoldi_tpu_torch.solvers.spectral_transform import InnerSolveStats
from common import find_best_matching
from torch_parity import to_numpy

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _residual(A, vals, vecs):
    V = to_numpy(vecs)
    return np.linalg.norm(A @ V - V * np.asarray(vals)[None, :], axis=0)


# ---------------------------------------------------------------- operators

SI_CASES = {   # name: (solver, shift, inner tol)
    "bicgstab": ("bicgstab", 0.5, 1e-12),
    "cg": ("cg", 1.0, 1e-12),
    "gmres": ("gmres", -2.0, 1e-10),
    "gmres_complex_shift": ("gmres", 0.5 + 0.25j, 1e-10),
}
# JAX's count less the port's, a solve (see the module docstring)
JAX_EXTRA_COUNT = {"bicgstab": 1, "cg": 0, "gmres": 1}


@functools.lru_cache(maxsize=None)
def _jax_si(case):
    solver, sigma, itol = SI_CASES[case]
    A = laplace(60).tocsr()
    op = jst.shift_invert_operator(A, sigma, solver=solver, inner_tol=itol,
                                   count_inner=True)
    b = np.random.default_rng(0).standard_normal(60)
    b = b.astype(np.complex128) if np.iscomplexobj(sigma) else b
    xs = [np.asarray(op.matvec(jnp.asarray(b))),
          np.asarray(op.matvec(jnp.asarray(2.0 * b + 1.0)))]
    return b, xs, op.inner_stats.solves, op.inner_stats.inner_matvecs


@pytest.mark.parametrize("case", sorted(SI_CASES))
def test_shift_invert_matvec_and_counts_match_jax(case):
    solver, sigma, itol = SI_CASES[case]
    b, want, jax_solves, jax_matvecs = _jax_si(case)
    A = laplace(60).tocsr()
    op = shift_invert_operator(A, sigma, solver=solver, inner_tol=itol,
                               count_inner=True, device="cpu")
    assert op.dtype == (torch.complex128 if np.iscomplexobj(sigma)
                        else torch.float64)
    for rhs, x_jax in zip((b, 2.0 * b + 1.0), want):
        x = op.matvec(torch.from_numpy(rhs)).numpy()
        np.testing.assert_allclose(x, x_jax, rtol=1e-12,
                                   atol=1e-12 * np.abs(x_jax).max())
        np.testing.assert_allclose((A - sigma * sp.eye(60)) @ x, rhs,
                                   atol=1e-7 * np.abs(rhs).max())
    stats = op.inner_stats
    assert stats.solves == jax_solves == 2
    assert stats.inner_matvecs == jax_matvecs - JAX_EXTRA_COUNT[solver] * 2


def test_shift_invert_matvec_is_inverse():
    A = laplace(60).tocsr()
    op = shift_invert_operator(A, 0.5, solver="bicgstab", inner_tol=1e-12,
                               device="cpu")
    assert op.inner_stats is None
    b = np.random.default_rng(0).standard_normal(60)
    x = op.matvec(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose((A - 0.5 * sp.eye(60)) @ x, b, atol=1e-8)


def test_inner_stats_splu():
    L = laplace(100).tocsr()
    op = shift_invert_operator(L, -2.0, solver="splu", device="cpu")
    jop = jst.shift_invert_operator(L, -2.0, solver="splu")
    x = np.random.default_rng(0).standard_normal(100)
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose((L + 2.0 * sp.identity(100)) @ y, x, atol=1e-10)
    np.testing.assert_allclose(y, np.asarray(jop.matvec(jnp.asarray(x))),
                               rtol=1e-13, atol=0)
    assert op.inner_stats.solves == jop.inner_stats.solves == 1
    assert op.inner_stats.inner_matvecs == 0
    # each application counts, as JAX's host callback does
    for _ in range(3):
        op.matvec(torch.from_numpy(x))
    assert op.inner_stats.solves == 4
    assert repr(op.inner_stats) == "InnerSolveStats(solves=4, inner_matvecs=0)"


def test_inner_stats_iterative_counts_applications():
    L = laplace(60).tocsr()
    op = shift_invert_operator(L, 1.0, solver="cg", count_inner=True,
                               inner_tol=1e-12, device="cpu")
    counts = []
    for k in range(1, 4):
        op.matvec(torch.ones(60, dtype=torch.float64))
        assert op.inner_stats.solves == k
        counts.append(op.inner_stats.inner_matvecs)
    # the same solve three times: equal increments of more than one product
    assert np.diff([0] + counts).tolist() == [counts[0]] * 3 and counts[0] > 1


def test_splu_needs_a_host_matrix():
    op = as_operator(laplace(20).tocsr(), device="cpu")
    with pytest.raises(ValueError, match="splu"):
        shift_invert_operator(op, 0.5, solver="splu", device="cpu")
    with pytest.raises(ValueError, match="device"):
        shift_invert_operator(laplace(20).tocsr(), 0.5, solver="splu")
    with pytest.raises(ValueError, match="inner solver"):
        shift_invert_operator(laplace(20).tocsr(), 0.5, solver="minres",
                              device="cpu")


@pytest.mark.parametrize("driver", ["eigs", "eigsh"])
def test_splu_drivers_build_no_device_operator(driver, monkeypatch):
    # The host LU factorizes the SciPy matrix itself: the drivers must not
    # copy A to the device as an operator no product would use.
    from arnoldi_tpu_torch.solvers import spectral_transform as st

    def refuse(*args, **kwargs):
        raise AssertionError("splu built a device operator")

    monkeypatch.setattr(st, "as_operator", refuse)
    L = laplace(100).tocsr()
    run = eigs if driver == "eigs" else eigsh
    vals, vecs = run(L, 3, sigma=0.01, inner_solver="splu", tol=1e-10,
                     generator=_gen(0), device="cpu")
    want = np.sort(laplace_eigen(100))
    want = want[np.argsort(np.abs(want - 0.01), kind="stable")[:3]]
    assert np.allclose(np.sort(np.real(vals)), np.sort(want), rtol=1e-8,
                       atol=0)
    assert _residual(L, vals, vecs).max() < 1e-7


@pytest.mark.parametrize("inner_solver", ["cg", "splu"])
def test_accounting_counts_the_drivers_inner_solves(inner_solver):
    # Inside accounting(), eigsh's transformed operator counts as one
    # built with count_inner=True, and its outer History is kept.
    from arnoldi_tpu_torch.solvers import spectral_transform as st

    L = laplace(60).tocsr()
    kw = dict(sigma=0.01, inner_solver=inner_solver, tol=1e-10, device="cpu")
    with st.accounting() as seen:
        vals, _ = eigsh(L, 3, generator=_gen(0), **kw)
    assert len(seen["stats"]) == len(seen["hist"]) == 1
    stats, hist = seen["stats"][0], seen["hist"][0]
    assert stats.solves == hist.total_matvecs > 0
    if inner_solver == "cg":
        assert stats.inner_matvecs > stats.solves
    # Outside the block nothing is kept, and the same solve gives the same
    # values (counting changes no arithmetic).
    with st.accounting() as outer:
        pass
    vals2, _ = eigsh(L, 3, generator=_gen(0), **kw)
    assert outer == {"stats": [], "hist": []} and not st._ACCOUNTS
    np.testing.assert_array_equal(vals, vals2)
    op = shift_invert_operator(as_operator(L, device="cpu"), 0.01,
                               solver="cg")
    assert op.inner_stats is None


def test_splu_complex_rhs_on_a_real_factorization():
    # a complex solve over a real splu factorization solves the parts apart
    L = laplace(50).tocsr()
    op = shift_invert_operator(L, -1.1, solver="splu", device="cpu")
    rng = np.random.default_rng(1)
    b = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    x = op.matvec(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose((L + 1.1 * sp.identity(50)) @ x, b, atol=1e-12)


def test_real_bsr_operator_with_a_complex_shift():
    # A complex shift makes the transformed operator complex; the real BSR
    # operator is applied to the real and imaginary parts as two columns
    # (its b-column kernel), never cast to a complex BSR operator: its real
    # values are read once for both parts, half a complex cast's bytes.
    A = sp.csr_matrix(_normal_interior()[0])
    op = BsrOperator.from_scipy(A, blocksize=(8, 8), device="cpu")
    sigma = 0.5 + 0.1j
    si = shift_invert_operator(op, sigma, solver="gmres", inner_tol=1e-12,
                               count_inner=True)
    assert si.dtype == torch.complex128 and op.dtype == torch.float64
    vals, vecs = eigs(op, 3, sigma=sigma, inner_solver="gmres", tol=1e-10,
                      maxiter=3000, generator=_gen(1))
    dense = np.linalg.eigvals(A.toarray())
    want = dense[np.argsort(np.abs(dense - sigma))[:3]]
    assert eigenvalues_match(vals, want, which="LM", rtol=1e-8)
    assert _residual(A, vals, vecs).max() < 1e-8


# ------------------------------------------------------------------ drivers

def _mark12():
    return mark(12)


def _normal_interior():
    rng = np.random.default_rng(2)
    D = sla.block_diag(np.diag([0.1, 0.35, 0.52, 0.61, 0.9, 1.4]),
                       np.array([[0.48, 0.2], [-0.2, 0.48]]),
                       np.diag(rng.uniform(2, 3, 40)))
    Qo, _ = np.linalg.qr(rng.standard_normal(D.shape))
    return Qo.T @ D @ Qo, np.linalg.eigvals(D)


# name: (driver, matrix, k, keywords for both, JAX-only, port-only, which key)
DRIVER_CASES = {
    "eigs_plain": ("eigs", _mark12, 4, dict(which="LR", tol=1e-9, maxiter=5000),
                   dict(key=0), dict(generator=0), "LR"),
    "eigs_values_only": ("eigs", lambda: mark(10), 3,
                         dict(which="LM", tol=1e-8, maxiter=5000,
                              return_eigenvectors=False),
                         dict(key=1), dict(generator=1), "LM"),
    "eigs_shift_invert_interior": ("eigs", lambda: laplace(80).tocsr(), 3,
                                   dict(sigma=-1.7, tol=1e-9, maxiter=5000),
                                   dict(key=2), dict(generator=2), "LM"),
    "eigsh_plain": ("eigsh", lambda: laplace_2d(12, 11), 4,
                    dict(which="SA", tol=1e-9, maxiter=5000), dict(key=3),
                    dict(generator=3), "SR"),
    "eigsh_shift_invert_smallest": ("eigsh", lambda: laplace(100).tocsr(), 3,
                                    dict(sigma=-4.1, tol=1e-8,
                                         inner_solver="bicgstab", maxiter=5000),
                                    dict(key=4), dict(generator=4), "SR"),
    "eigsh_interior_splu": ("eigsh", lambda: laplace(400).tocsr(), 6,
                            dict(sigma=-2.0, inner_solver="splu", tol=1e-10,
                                 maxiter=3000), dict(key=0), dict(generator=0),
                            "LR"),
    "eigs_interior_splu_nonsymmetric": ("eigs", lambda: _normal_interior()[0], 3,
                                        dict(sigma=0.5, inner_solver="splu",
                                             tol=1e-10, maxiter=3000),
                                        dict(key=1), dict(generator=1), "LR"),
    "eigs_v0": ("eigs", _mark12, 4,
                dict(which="LR", tol=1e-9, maxiter=5000,
                     v0=np.sin(np.arange(78) + 1.0)), {}, {}, "LR"),
    "eigsh_v0": ("eigsh", lambda: laplace(64).tocsr(), 3,
                 dict(which="SA", tol=1e-9, maxiter=5000,
                      v0=np.cos(0.1 * np.arange(64))), {}, {}, "SR"),
    "eigs_sigma_v0": ("eigs", lambda: laplace(80).tocsr(), 3,
                      dict(sigma=-1.7, tol=1e-9, maxiter=5000, v0=np.ones(80)),
                      {}, {}, "LR"),
}


@functools.lru_cache(maxsize=None)
def _jax_driver(case):
    driver, matrix, k, kw, jax_kw, _, _ = DRIVER_CASES[case]
    jax_kw = {"key": jax.random.key(v) for v in jax_kw.values()}
    out = getattr(jst, driver)(matrix(), k, **kw, **jax_kw)
    return np.asarray(out[0] if isinstance(out, tuple) else out)


def _port_driver(case):
    driver, matrix, k, kw, _, port_kw, _ = DRIVER_CASES[case]
    port_kw = {"generator": _gen(v) for v in port_kw.values()}
    return {"eigs": eigs, "eigsh": eigsh}[driver](matrix(), k, **kw, **port_kw,
                                                   device="cpu")


def _reference(case, A, k):
    """The reference JAX's test holds the case against."""
    dense = A.toarray() if sp.issparse(A) else A
    if case in ("eigs_plain", "eigs_v0"):
        return spla.eigs(A, k, which="LR")[0]
    if case == "eigs_values_only":
        ev = np.linalg.eigvals(dense)
        return ev[np.argsort(-np.abs(ev))[:k]]
    if case in ("eigs_shift_invert_interior", "eigs_sigma_v0"):
        full = np.sort(laplace_eigen(80))
        return full[np.argsort(np.abs(full + 1.7))[:k]]
    if case == "eigsh_plain":
        return spla.eigsh(A.astype(float), k, which="SA")[0]
    if case in ("eigsh_shift_invert_smallest", "eigsh_v0"):
        return np.sort(laplace_eigen(A.shape[0]))[:k]
    if case == "eigsh_interior_splu":
        return spla.eigsh(A.astype(np.float64), 6, sigma=-2.0)[0]
    full = _normal_interior()[1]
    return full[np.argsort(np.abs(full - 0.5))[:k]]


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_driver_matches_jax_and_reference(case):
    driver, matrix, k, kw, _, _, which = DRIVER_CASES[case]
    A = matrix()
    out = _port_driver(case)
    vals = out[0] if isinstance(out, tuple) else out
    assert isinstance(vals, np.ndarray) and vals.shape == (k,)
    rtol = 1e-8 if kw["tol"] <= 1e-9 else 1e-6
    assert eigenvalues_match(vals, _jax_driver(case), which=which, rtol=rtol)
    assert eigenvalues_match(vals, _reference(case, A, k), which=which,
                             rtol=rtol)
    if driver == "eigsh":
        assert np.all(np.diff(vals) >= 0)           # SciPy's ascending order
    if isinstance(out, tuple):
        vecs = out[1]
        assert torch.is_tensor(vecs) and vecs.shape == (A.shape[0], k)
        assert _residual(A, vals, vecs).max() < 1e-6


def test_eigs_v0_is_deterministic():
    A = mark(12)
    v0 = np.sin(np.arange(A.shape[0]) + 1.0)
    first = eigs(A, 4, which="LR", tol=1e-9, v0=v0, maxiter=5000, device="cpu")
    second = eigs(A, 4, which="LR", tol=1e-9, v0=v0, maxiter=5000, device="cpu")
    np.testing.assert_array_equal(first[0], second[0])
    assert torch.equal(first[1], second[1])


def test_eigsh_interior_shift_gmres():
    # JAX's case at laplace(400) is in its slow tier; the same interior,
    # indefinite shift at laplace(120), against ARPACK's shift-invert.
    L = laplace(120).tocsr()
    ref = spla.eigsh(L.astype(np.float64), 6, sigma=-2.0)[0]
    vals, vecs = eigsh(L, 6, sigma=-2.0, inner_solver="gmres", tol=1e-8,
                       inner_tol=1e-11, maxiter=3000, generator=_gen(0),
                       device="cpu")
    np.testing.assert_allclose(np.sort(vals), np.sort(ref), atol=1e-7)
    assert _residual(L, vals, vecs).max() < 1e-6


# ------------------------------------------------------------ realified route

def _unitary_similar(lams, seed):
    rng = np.random.default_rng(seed)
    n = len(lams)
    Qc, _ = np.linalg.qr(rng.standard_normal((n, n))
                         + 1j * rng.standard_normal((n, n)))
    return Qc @ np.diag(lams) @ Qc.conj().T


def test_realified_near_conjugate_distinct_pair():
    lams = np.array([0.9 + 1e-4j, 0.9 - 1.3e-4j, 0.5 + 0.2j,
                     0.1 - 0.3j, -0.4 + 0.05j, 0.02 + 0.6j])
    A = _unitary_similar(lams, 11)
    vals, vecs = eigs_realified(A, 2, which="LM", tol=1e-11, maxiter=4000,
                                generator=_gen(3), device="cpu")
    got, want = find_best_matching(vals, lams[:2])
    np.testing.assert_allclose(got, want, atol=1e-8)
    assert _residual(A, vals, vecs).max() < 1e-8


def test_realified_tight_cluster():
    lams = np.array([1.0 + 1e-7j, 1.0 - 2e-7j, 1.0 + 3e-7j,
                     0.3 + 0.1j, -0.2 - 0.5j])
    A = _unitary_similar(lams, 12)
    vals, vecs = eigs_realified(A, 3, which="LM", tol=1e-12, ncv=5,
                                maxiter=6000, generator=_gen(4), device="cpu")
    a, b = find_best_matching(vals, lams[:3])
    np.testing.assert_allclose(a, b, atol=1e-8)
    assert _residual(A, vals, vecs).max() < 1e-8


def test_realified_v0_complex():
    rng = np.random.default_rng(6)
    lams = np.array([2.0 + 1.0j, -1.5 + 0.5j, 0.3 - 0.8j,
                     0.1 + 0.2j, -0.05 - 0.4j, 0.6 + 0.0j])
    A = _unitary_similar(lams, 6)
    v0 = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    vals, vecs = eigs_realified(A, 2, which="LM", tol=1e-11, v0=v0,
                                maxiter=4000, device="cpu")
    a, b = find_best_matching(vals, lams[:2])
    np.testing.assert_allclose(a, b, atol=1e-8)
    with pytest.raises(ValueError, match="v0"):
        eigs_realified(A, 2, v0=np.ones(5), device="cpu")


def test_svds_v0():
    from arnoldi_tpu_torch import svds

    rng = np.random.default_rng(5)
    A = rng.standard_normal((40, 90))
    v0 = rng.standard_normal(40)
    U, s, Vh = svds(A, 3, tol=1e-10, v0=v0, maxiter=4000, device="cpu")
    want = np.linalg.svd(A, compute_uv=False)[:3][::-1]
    np.testing.assert_allclose(s, want, rtol=1e-8)
    np.testing.assert_allclose(A @ to_numpy(Vh).T, to_numpy(U) * s, atol=1e-7)


def test_inner_solve_stats_repr():
    stats = InnerSolveStats()
    stats.solves, stats.inner_matvecs = 2, 7
    assert repr(stats) == "InnerSolveStats(solves=2, inner_matvecs=7)"
