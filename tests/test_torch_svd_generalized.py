"""The port's generalized problems (``eigs``/``eigsh`` with ``M``,
``Minv``, ``OPinv`` and ``mode``), ``svds(sigma=)``, the realified route
and the review regressions, on the cases of
``tests/test_svd_generalized.py`` from ``TestGeneralized`` on.

Each case runs the port on the CPU, and, where JAX's own test is not in
its slow tier, the JAX package on the same input (JAX's ``key`` and the
port's ``generator`` draw different start vectors), once per case and
module.  Eigenvalue and singular-value sets match JAX's with
``eigenvalues_match`` at rtol 1e-8 for tol <= 1e-9 solves, and the
case's dense reference as JAX's test holds it; vectors are held by their
(pencil) residuals, M- or A-orthonormality and the triplets.
"""

import functools

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import arnoldi_tpu as jax_pkg
from arnoldi_tpu.harness.suite import eigenvalues_match
from arnoldi_tpu.matrices import laplace
from arnoldi_tpu_torch import (CallableOperator, eigs, eigs_realified, eigsh,
                               realify_operator, svds)
from arnoldi_tpu_torch.solvers.spectral_transform import accounting
from arnoldi_tpu_torch.utils.sorting import sort_function_for
from torch_parity import to_numpy

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _pencil_residual(A, B, vals, vecs):
    V = to_numpy(vecs)
    return np.linalg.norm(A @ V - (B @ V) * np.asarray(vals)[None, :], axis=0)


def _lap(n):
    return laplace(n).tocsr()


def _diag(lo, hi, n):
    return sp.diags_array(np.linspace(lo, hi, n)).tocsr()


def _generalized_values(A, B):
    return np.sort(sla.eigh(A.todense(), B.todense(), eigvals_only=True))


def _nearest(full, sigma, k):
    return full[np.argsort(np.abs(full - sigma))[:k]]


# ------------------------------------------------- cases held against JAX too

def _spd_pencil(n=60):
    return (-laplace(n)).tocsr(), _diag(1, 2, n)


# name: (driver, (A, B) builder, k, shared keywords, JAX seed, which key,
#        reference (A, B, k) -> values)
JAX_CASES = {
    "eigs_M_largest_real": (
        "eigs", lambda: (_lap(80), _diag(1, 2, 80)), 3,
        dict(which="LR", tol=1e-9, maxiter=5000), 0, "LR",
        lambda A, B, k: _generalized_values(A, B)[::-1][:k]),
    "eigs_M_shift_invert": (
        "eigs", lambda: (_lap(60), _diag(0.5, 1.5, 60)), 3,
        dict(sigma=-1.0, tol=1e-9, maxiter=5000), 5, "LM",
        lambda A, B, k: _nearest(_generalized_values(A, B), -1.0, k)),
    "eigsh_M_shift_invert": (
        "eigsh", lambda: (_lap(60), _diag(0.5, 1.5, 60)), 3,
        dict(sigma=-1.0, tol=1e-9, maxiter=5000), 7, "LM",
        lambda A, B, k: _nearest(_generalized_values(A, B), -1.0, k)),
    "eigsh_buckling": (
        "eigsh", _spd_pencil, 4,
        dict(sigma=1.5, mode="buckling", which="LM", tol=1e-9, maxiter=5000,
             inner_solver="gmres"), 1, "LM",
        lambda A, B, k: _scipy_mode(A, B, k, "buckling")),
    "eigsh_cayley": (
        "eigsh", _spd_pencil, 4,
        dict(sigma=1.5, mode="cayley", which="LM", tol=1e-9, maxiter=5000,
             inner_solver="gmres"), 1, "LM",
        lambda A, B, k: _scipy_mode(A, B, k, "cayley")),
}


def _scipy_mode(A, B, k, mode):
    import scipy.sparse.linalg as spla

    return spla.eigsh(A, k, M=B, sigma=1.5, mode=mode, which="LM")[0]


@functools.lru_cache(maxsize=None)
def _jax_values(case):
    driver, build, k, kw, seed, _, _ = JAX_CASES[case]
    A, B = build()
    vals, _ = getattr(jax_pkg, driver)(A, k, M=B, key=jax.random.key(seed), **kw)
    return np.asarray(vals)


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_pencil_matches_jax_and_reference(case):
    driver, build, k, kw, seed, which, reference = JAX_CASES[case]
    A, B = build()
    vals, vecs = {"eigs": eigs, "eigsh": eigsh}[driver](
        A, k, M=B, generator=_gen(seed), device="cpu", **kw)
    assert eigenvalues_match(vals, _jax_values(case), which=which, rtol=1e-8)
    assert eigenvalues_match(vals, reference(A, B, k), which=which, rtol=1e-8)
    assert _pencil_residual(A, B, vals, vecs).max() < 1e-6
    if driver == "eigsh":
        assert np.all(np.diff(vals) >= 0) and not np.iscomplexobj(vals)
        assert not vecs.is_complex()
        # B-orthonormal: B = A in buckling mode, M otherwise
        Bn = A if kw.get("mode") == "buckling" else B
        V = to_numpy(vecs)
        np.testing.assert_allclose(V.T @ (Bn @ V), np.eye(k), atol=1e-8)


# -------------------------------------------- JAX's slow tier: reference only

def test_eigsh_generalized_la_sa():
    n = 80
    A, B = _lap(n), _diag(1, 2, n)
    full = _generalized_values(A, B)
    for which, want in (("LA", full[-3:]), ("SA", full[:3])):
        vals, vecs = eigsh(A, 3, which=which, M=B, tol=1e-9, maxiter=5000,
                           generator=_gen(2), device="cpu")
        assert not np.iscomplexobj(vals) and not vecs.is_complex()
        np.testing.assert_allclose(vals, want, rtol=1e-7, atol=1e-9)
        assert np.all(np.diff(vals) >= 0)
        assert _pencil_residual(A, B, vals, vecs).max() < 1e-6
        V = to_numpy(vecs)
        np.testing.assert_allclose(V.T @ (B @ V), np.eye(3), atol=1e-6)


def test_eigsh_be_standard_and_generalized():
    n = 80
    A = _lap(n)
    full = np.sort(np.linalg.eigvalsh(A.todense()))
    vals, vecs = eigsh(A, 5, which="BE", tol=1e-9, maxiter=5000,
                       generator=_gen(3), device="cpu")
    np.testing.assert_allclose(vals, np.sort(np.r_[full[:2], full[-3:]]),
                               rtol=1e-7, atol=1e-9)
    V = to_numpy(vecs)
    np.testing.assert_allclose(np.linalg.norm(A @ V - V * vals, axis=0), 0,
                               atol=1e-6)
    B = _diag(1, 2, n)
    gfull = _generalized_values(A, B)
    gvals = eigsh(A, 4, which="BE", M=B, tol=1e-9, maxiter=5000,
                  generator=_gen(4), device="cpu", return_eigenvectors=False)
    np.testing.assert_allclose(gvals, np.sort(np.r_[gfull[:2], gfull[-2:]]),
                               rtol=1e-7, atol=1e-9)
    # odd k sends the extra pair to the top; k = 1 is the top alone
    top = eigsh(A, 1, which="BE", tol=1e-9, maxiter=5000, device="cpu",
                return_eigenvectors=False)
    np.testing.assert_allclose(top, full[-1:], rtol=1e-8)


def _host_inverse(lu, n):
    """A CallableOperator applying a SciPy LU solve on the host."""
    def mv(x):
        return torch.from_numpy(lu.solve(x.numpy().astype(np.float64))).to(x)

    return CallableOperator(mv, (n, n), np.float64, device="cpu")


def test_minv_opinv_explicit_inverses():
    from scipy.sparse.linalg import splu

    n = 60
    A = _lap(n)
    d = np.linspace(1, 2, n)
    B = sp.diags_array(d).tocsr()
    full = _generalized_values(A, B)
    Minv = sp.diags_array(1.0 / d).tocsr()
    vals, _ = eigsh(A, 3, which="SA", M=B, Minv=Minv, tol=1e-9, maxiter=5000,
                    generator=_gen(1), device="cpu")
    np.testing.assert_allclose(vals, full[:3], rtol=1e-7, atol=1e-9)

    sigma = -1.0
    opinv = _host_inverse(splu((A - sigma * B).tocsc()), n)
    gvals, gvecs = eigsh(A, 3, sigma=sigma, M=B, OPinv=opinv, tol=1e-9,
                         maxiter=5000, generator=_gen(2), device="cpu")
    np.testing.assert_allclose(gvals, np.sort(_nearest(full, sigma, 3)),
                               rtol=1e-7, atol=1e-8)
    assert _pencil_residual(A, B, gvals, gvecs).max() < 1e-6

    opinv2 = _host_inverse(splu((A - sigma * sp.eye_array(n)).tocsc()), n)
    evals, _ = eigs(A, 3, sigma=sigma, OPinv=opinv2, tol=1e-9, maxiter=5000,
                    generator=_gen(3), device="cpu")
    sfull = np.sort(np.linalg.eigvalsh(A.todense()))
    np.testing.assert_allclose(np.sort(np.real(evals)),
                               np.sort(_nearest(sfull, sigma, 3)), rtol=1e-7,
                               atol=1e-8)

    # SciPy's validation errors
    with pytest.raises(ValueError, match="OPinv"):
        eigs(A, 2, OPinv=opinv2, device="cpu")
    with pytest.raises(ValueError, match="Minv"):
        eigs(A, 2, sigma=sigma, M=B, Minv=Minv, device="cpu")
    with pytest.raises(ValueError, match="Minv"):
        eigsh(A, 2, Minv=Minv, device="cpu")


@pytest.mark.parametrize("mode", ["buckling", "cayley"])
def test_mode_opinv_explicit(mode):
    from scipy.sparse.linalg import LinearOperator, splu

    A, M = _spd_pencil()
    sigma = 1.5
    lu = splu((A - sigma * M).tocsc())
    OPinv = LinearOperator(A.shape, matvec=lambda b: lu.solve(np.asarray(b)),
                           dtype=np.float64)
    vals, vecs = eigsh(A, 3, M=M, sigma=sigma, mode=mode, which="LM",
                       tol=1e-9, maxiter=5000, generator=_gen(2), OPinv=OPinv,
                       device="cpu")
    assert _pencil_residual(A, M, vals, vecs).max() < 1e-8


def test_mode_and_which_validation():
    A, M = _spd_pencil(30)
    with pytest.raises(ValueError, match="requires sigma"):
        eigsh(A, 2, M=M, mode="buckling", device="cpu")
    with pytest.raises(ValueError, match="requires M"):
        eigsh(A, 2, sigma=1.0, mode="cayley", device="cpu")
    with pytest.raises(ValueError, match="expected 'normal'"):
        eigsh(A, 2, M=M, sigma=1.0, mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="not supported with M"):
        eigsh(A, 2, M=M, which="XX", device="cpu")
    with pytest.raises(ValueError, match="not supported with sigma"):
        eigsh(A, 2, sigma=1.0, which="LR", device="cpu")


# ------------------------------------------------------- review regressions

def test_rectangular_sparse_svds():
    A = sp.random(24, 12, density=0.4,
                  random_state=np.random.RandomState(1)).tocsr()
    U, s, Vh = svds(A, 3, tol=1e-10, maxiter=3000, generator=_gen(0),
                    device="cpu")
    ref = np.linalg.svd(A.todense(), compute_uv=False)[:3]
    np.testing.assert_allclose(s[::-1], ref, rtol=1e-8)
    assert U.shape == (24, 3) and Vh.shape == (3, 12)


def test_shift_invert_trim_keeps_nearest_sigma():
    rng = np.random.default_rng(3)
    D = sla.block_diag(np.diag([0.05, 2.0, 3.0, 4.0, 5.0]),
                       np.array([[0.1, -0.1], [0.1, 0.1]]))
    Qo, _ = np.linalg.qr(rng.standard_normal(D.shape))
    A = Qo.T @ D @ Qo
    vals, _ = eigs(A, 2, sigma=0.0, tol=1e-9, maxiter=3000, generator=_gen(1),
                   device="cpu")
    jvals, _ = jax_pkg.eigs(A, 2, sigma=0.0, tol=1e-9, maxiter=3000,
                            key=jax.random.key(1))
    assert np.min(np.abs(vals - 0.05)) < 1e-6
    assert np.min(np.abs(np.asarray(jvals) - 0.05)) < 1e-6


def test_eigsh_scipy_contracts():
    from arnoldi_tpu.matrices import laplace_eigen

    v = eigsh(_lap(64), 4, which="LA", tol=1e-9, maxiter=3000, device="cpu",
              return_eigenvectors=False)
    assert np.all(np.diff(v) >= 0)
    np.testing.assert_allclose(v, np.sort(laplace_eigen(64))[-4:], rtol=1e-8)


def test_complex_sigma_accepted():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((30, 30)) + 1j * rng.standard_normal((30, 30))
    ref = np.linalg.eigvals(A)
    sigma = ref[5] + 0.01 + 0.01j
    vals, vecs = eigs(A, 1, sigma=sigma, tol=1e-9, maxiter=3000,
                      generator=_gen(2), device="cpu")
    jvals, _ = jax_pkg.eigs(A, 1, sigma=sigma, tol=1e-9, maxiter=3000,
                            key=jax.random.key(2))
    assert np.min(np.abs(ref - vals[0])) < 1e-6
    assert eigenvalues_match(vals, np.asarray(jvals), rtol=1e-8)
    assert vecs.dtype == torch.complex128


def test_real_matrix_with_a_complex_sigma():
    # The JAX package's CPU backend solves this in complex128; the port's
    # shift-invert operator is complex128 and so is its outer solve.
    A = _lap(60)
    sigma = -1.3 + 0.2j
    vals, vecs = eigs(A, 3, sigma=sigma, tol=1e-10, maxiter=3000,
                      inner_solver="gmres", generator=_gen(0), device="cpu")
    jvals, _ = jax_pkg.eigs(A, 3, sigma=sigma, tol=1e-10, maxiter=3000,
                            inner_solver="gmres", key=jax.random.key(0))
    full = np.sort(np.linalg.eigvalsh(A.todense()))
    assert eigenvalues_match(vals, _nearest(full, sigma, 3), rtol=1e-8)
    assert eigenvalues_match(vals, np.asarray(jvals), rtol=1e-8)
    assert vecs.is_complex()
    V = to_numpy(vecs)
    assert np.linalg.norm(A @ V - V * vals, axis=0).max() < 1e-8


# --------------------------------------------------------- the realified route

def test_realified_dense_complex_matches_lapack():
    rng = np.random.default_rng(0)
    n = 60
    A = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    vals, vecs = eigs_realified(A, 4, which="LM", tol=1e-9, maxiter=5000,
                                generator=_gen(0), device="cpu")
    ref = np.linalg.eigvals(A)
    ref = ref[np.argsort(-np.abs(ref))][:4]
    np.testing.assert_allclose(np.sort_complex(vals), np.sort_complex(ref),
                               rtol=1e-7, atol=1e-8)
    V = to_numpy(vecs)
    np.testing.assert_allclose(np.linalg.norm(A @ V - vals * V, axis=0), 0,
                               atol=1e-7)


def test_realified_sparse_complex():
    import scipy.sparse.linalg as spla

    S = (sp.random(200, 200, density=0.05, random_state=np.random.RandomState(1))
         + 1j * sp.random(200, 200, density=0.05,
                          random_state=np.random.RandomState(2))
         + sp.diags_array(np.ones(200))).tocsr()
    vals, vecs = eigs_realified(S, 3, which="LM", tol=1e-9, maxiter=5000,
                                generator=_gen(1), device="cpu")
    rv = spla.eigs(S, 3, which="LM")[0]
    np.testing.assert_allclose(np.sort_complex(vals), np.sort_complex(rv),
                               rtol=1e-6, atol=1e-8)
    V = to_numpy(vecs)
    np.testing.assert_allclose(np.linalg.norm(S @ V - vals * V, axis=0), 0,
                               atol=1e-7)


def test_realify_operator():
    with pytest.raises(TypeError):
        realify_operator(np.eye(5), device="cpu")
    rng = np.random.default_rng(2)
    A = rng.standard_normal((7, 7)) + 1j * rng.standard_normal((7, 7))
    z = rng.standard_normal(7) + 1j * rng.standard_normal(7)
    for src in (A, sp.csr_matrix(A), torch.from_numpy(A)):
        R = realify_operator(src, device="cpu")
        assert R.shape == (14, 14) and R.dtype == torch.float64
        u = R.matvec(torch.from_numpy(np.r_[z.real, z.imag]))
        np.testing.assert_allclose(u[:7].numpy() + 1j * u[7:].numpy(), A @ z,
                                   atol=1e-13)
    assert realify_operator(A, dtype=np.complex64, device="cpu").dtype == \
        torch.float32


def test_eigsh_sigma_which_la_scipy_semantics():
    import scipy.sparse.linalg as spla

    A = sp.diags_array(np.array([1.0, 2, 3, 4, 7, 9, 11])).tocsr()
    ours = eigsh(A, 2, sigma=5.0, which="LA", tol=1e-10, maxiter=2000,
                 device="cpu", return_eigenvectors=False)
    ref = spla.eigsh(A.astype(float), 2, sigma=5.0, which="LA")[0]
    jax_vals = jax_pkg.eigsh(A, 2, sigma=5.0, which="LA", tol=1e-10,
                             maxiter=2000, return_eigenvectors=False)
    np.testing.assert_allclose(np.sort(ours), np.sort(ref), rtol=1e-8)
    np.testing.assert_allclose(np.sort(ours), np.sort(jax_vals), rtol=1e-8)


def test_realified_li_raises():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((12, 12)) + 1j * rng.standard_normal((12, 12))
    with pytest.raises(NotImplementedError, match="conjugation"):
        eigs_realified(A, 2, which="LI", device="cpu")


def test_realified_multiplicity_and_ncv():
    rng = np.random.default_rng(1)
    Z = np.diag([3 + 2j, 3 + 2j, 1 - 1j, 0.5 + 0.1j, -2 + 0j, 0.3 - 0.4j])
    Qc, _ = np.linalg.qr(rng.standard_normal((6, 6))
                         + 1j * rng.standard_normal((6, 6)))
    A = Qc @ Z @ Qc.conj().T
    vals, _ = eigs_realified(A, 2, which="LM", tol=1e-10, maxiter=3000,
                             generator=_gen(0), device="cpu")
    np.testing.assert_allclose(np.sort_complex(vals), [3 + 2j, 3 + 2j],
                               rtol=1e-8)
    # SciPy's ncv forwards (max_dim = 2 ncv).  At the default block size 2
    # the real block driver finds no cut of the 20-dim space that keeps
    # every conjugate pair whole and raises, as the JAX package's real
    # block driver does on this R (its CPU test passes because its CPU
    # backend solves R in complex128): the scalar driver takes it.
    B = rng.standard_normal((20, 20)) + 1j * rng.standard_normal((20, 20))
    v = eigs_realified(B, 6, which="LM", ncv=10, tol=1e-8, maxiter=3000,
                       block_size=1, return_eigenvectors=False, device="cpu")
    assert len(v) == 6
    ref = np.linalg.eigvals(B)
    np.testing.assert_allclose(np.sort_complex(v),
                               np.sort_complex(ref[np.argsort(-np.abs(ref))][:6]),
                               rtol=1e-7)
    with pytest.raises(ValueError, match="conjugate pair"):
        eigs_realified(B, 6, which="LM", ncv=10, tol=1e-8, maxiter=3000,
                       return_eigenvectors=False, device="cpu")


# ------------------------------------------------------------- svds(sigma=)

SVDS_CASES = {   # name: (A builder, k, sigma builder, keywords)
    "interior": (lambda: np.random.default_rng(5).standard_normal((120, 80)),
                 4, lambda sv: float(np.median(sv)), {}),
    "linear_vs_squared_domain": (
        lambda: _designed_singular_values(), 1, lambda sv: 1.0, {}),
    "sigma_zero_is_smallest": (
        lambda: np.random.default_rng(6).standard_normal((90, 60)), 3,
        lambda sv: 0.0, {}),
}


def _designed_singular_values():
    # |s - sigma| and |s^2 - sigma^2| orderings disagree: for sigma = 1,
    # 1.45 is linear-nearest but 0.5 squared-nearest.
    sv = np.array([0.5, 1.45, 2.1, 3.0, 4.2, 5.5])
    rng = np.random.default_rng(11)
    U0, _ = np.linalg.qr(rng.standard_normal((10, 6)))
    V0, _ = np.linalg.qr(rng.standard_normal((6, 6)))
    return (U0 * sv[None, :]) @ V0.T


@functools.lru_cache(maxsize=None)
def _jax_svds(case):
    build, k, sigma_of, kw = SVDS_CASES[case]
    A = build()
    sigma = sigma_of(np.linalg.svd(A, compute_uv=False))
    return np.asarray(jax_pkg.svds(A, k, sigma=sigma, tol=1e-10, maxiter=3000,
                                   key=jax.random.key(0),
                                   return_singular_vectors=False))


@pytest.mark.parametrize("case", sorted(SVDS_CASES))
def test_svds_sigma_matches_jax_and_lapack(case):
    build, k, sigma_of, kw = SVDS_CASES[case]
    A = build()
    sv = np.linalg.svd(A, compute_uv=False)
    sigma = sigma_of(sv)
    U, s, Vh = svds(A, k, sigma=sigma, tol=1e-10, maxiter=3000,
                    generator=_gen(0), device="cpu", **kw)
    want = np.sort(_nearest(sv, sigma, k))
    np.testing.assert_allclose(np.sort(s), want, atol=1e-8)
    assert eigenvalues_match(s, _jax_svds(case), rtol=1e-8)
    U, V = to_numpy(U), to_numpy(Vh).T
    np.testing.assert_allclose(A @ V, U * s[None, :], atol=1e-7)
    np.testing.assert_allclose(U.T @ U, np.eye(k), atol=1e-8)
    np.testing.assert_allclose(V.T @ V, np.eye(k), atol=1e-8)


def test_svds_sigma_inner_solver_and_history():
    A = np.random.default_rng(5).standard_normal((60, 40))
    sv = np.linalg.svd(A, compute_uv=False)
    with accounting() as seen:
        s, hist = svds(A, 2, sigma=1.1 * sv[0], inner_solver="cg",
                       inner_tol=1e-12, tol=1e-10,
                       return_singular_vectors=False, return_history=True,
                       device="cpu")
    np.testing.assert_allclose(s, sv[:2][::-1], rtol=1e-9)
    assert hist.total_matvecs > 0
    # accounting() keeps the returned History and counts the Gram's solves
    assert seen["hist"] == [hist]
    assert seen["stats"][0].solves == hist.total_matvecs


def test_si_end_to_end():
    rng = np.random.default_rng(7)
    n = 40
    S = rng.standard_normal((n, n))
    A = S - S.T + 0.1 * np.eye(n)
    vals = eigs(A, 4, which="SI", tol=1e-9, maxiter=2000, generator=_gen(3),
                return_eigenvectors=False, device="cpu")
    full = np.linalg.eigvals(A)
    want = np.sort(full[np.argsort(np.imag(full))[:4]].imag)
    np.testing.assert_allclose(np.sort(np.imag(vals)), want, atol=1e-7)
    np.testing.assert_array_equal(sort_function_for("SI")(
        np.array([1 + 2j, 1 - 3j, 0.5 + 0j, -2 - 1j])), [1, 3, 2, 0])
