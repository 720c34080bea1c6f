"""The port's Chebyshev-filtered interior solver against the JAX package's
(``arnoldi_tpu/solvers/filtered.py``), on the CPU.

The NumPy pieces (coefficients, degree ladder, soft-locking rows, host
whitening, ghost gate) must be bit for bit equal; the kernels' paths
(``cheby_filter`` over DIA and ELL, the KPM moments, ``spectrum_bounds``)
within 1e-12 relative from the same inputs; ``eigsh_filtered`` from the
same bounds, subspace and start block (nev mode) or the same probe blocks
and start block (all-inside mode) must take JAX's matvecs and sweeps and
give its values within 1e-10.  Equal counts are asserted on 1-D
Laplacians only: their spectra have no multiple eigenvalue, so no lock
depends on how rounding splits an eigenspace.  The float32 solves refined
in float64 are held to the gates of JAX's double-word tests (not to its
counts: the continuations differ in arithmetic).
"""

import jax
import numpy as np
import pytest
import torch

from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace, laplace_eigen
from arnoldi_tpu.solvers import filtered as jf
from arnoldi_tpu.utils.random import rand_normalized_vector
from arnoldi_tpu_torch import as_operator, eigsh_filtered
from arnoldi_tpu_torch.matrices import random_scattered
from arnoldi_tpu_torch.solvers import filtered as pf
from torch_parity import to_numpy

torch.set_num_threads(1)

BOUNDS_200 = (-4.05, 0.05)


def _residual(A, vals, vecs):
    V = to_numpy(vecs)
    return np.linalg.norm(A @ V - V * np.asarray(vals)[None, :], axis=0)


def _rel(got, want):
    got, want = to_numpy(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _scattered_symmetric(n=400):
    A = random_scattered(n, 12, seed=3, bandwidth=64)
    return ((A + A.T) / 2).tocsr()


# ------------------------------------------------------------------ pieces

@pytest.mark.parametrize("window, bounds, degree", [
    ((-2.2, -1.8), (-4.0, 0.0), 200),
    ((-3.99, -3.9), (-4.05, 0.05), 17),
    ((-11.93, -11.89), (-12.2, 0.2), 1200),
])
def test_coefficients_bit_for_bit(window, bounds, degree):
    np.testing.assert_array_equal(
        pf.jackson_cheby_coeffs(*window, *bounds, degree),
        jf.jackson_cheby_coeffs(*window, *bounds, degree))
    assert pf._edge_sine(*window, *bounds) == jf._edge_sine(*window, *bounds)


def test_degree_ladder_bit_for_bit():
    for N in (1, 15, 16, 17, 21, 100, 1234, 40001):
        assert pf._degree_rung(N) == jf._degree_rung(N)
    for args in [(-4.05, 0.05, 0.3, 0.1), (-12.2, 0.2, 0.05, 1e-4),
                 (-4.05, 0.05, 1.0, 1e-9), (-1.0, 1.0, 0.01, 0.5)]:
        assert pf._auto_degree(*args) == jf._auto_degree(*args)
        assert pf._auto_degree(*args, cap=8000) == jf._auto_degree(*args, cap=8000)


def test_active_rows_bit_for_bit():
    assert pf._active_rows(None, 1e-8, 100) is None
    rng = np.random.default_rng(4)
    for s, n_active in [(100, 0), (100, 3), (100, 100), (40, 30), (504, 60),
                        (504, 200), (96, 33), (64, 32)]:
        res = np.full(s, 1e-12)
        res[rng.choice(s, n_active, replace=False)] = 1.0
        got, want = pf._active_rows(res, 1e-8, s), jf._active_rows(res, 1e-8, s)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)


def test_host_whiten_bit_for_bit():
    rng = np.random.default_rng(5)
    W = rng.standard_normal((12, 200))
    gains = np.logspace(0, -9, 12)       # a filtered Gram: rank below s
    for G in (W @ W.T, (gains[:, None] * W) @ (gains[:, None] * W).T,
              np.ones((6, 6))):
        np.testing.assert_array_equal(pf._host_whiten(torch.from_numpy(G)),
                                      jf._host_whiten(G))


@pytest.mark.parametrize("case", ["quiet", "stall_true", "stall_ghost",
                                  "slice_mode_ghost", "too_many_pending"])
def test_ghost_gate_bit_for_bit(case):
    theta = np.linspace(-2.3, -1.7, 12)
    res = np.full(12, 1e-12)
    trace = [1e-3, 9e-4, 8e-4]
    inside = np.arange(2, 10)
    nev = 4
    gains = np.full(12, 0.95)
    if case == "quiet":
        trace = [1e-3, 5e-4, 1e-4]
    if case in ("stall_true", "stall_ghost", "slice_mode_ghost"):
        res[[4, 6]] = 1e-3
    if case in ("stall_ghost", "slice_mode_ghost"):
        gains[6] = 0.05
    if case == "slice_mode_ghost":
        nev = None
    if case == "too_many_pending":
        res[2:10] = 1e-3
    center = -2.0
    pick = inside if nev is None else \
        inside[np.argsort(np.abs(theta[inside] - center))[:nev]]
    outs = []
    for mod in (pf, jf):
        tr = list(trace)
        out = mod._ghost_gate(tr, 5, pick, inside, res, theta, 1e-8, nev,
                              center, 4.05, lambda p: gains[p])
        outs.append((out, tr))
    (p_out, p_tr), (j_out, j_tr) = outs
    np.testing.assert_array_equal(p_out[0], j_out[0])
    np.testing.assert_array_equal(p_out[1], j_out[1])
    assert p_out[2:] == j_out[2:] and p_tr == j_tr
    if case == "stall_ghost":
        assert p_out[2] == 1 and p_out[3] == 8


# ---------------------------------------------------------- kernels' paths

def _operators(kind):
    if kind == "dia":
        A = laplace(200).tocsr()
        return A, jax_as_operator(A, dtype=np.float64), as_operator(A, device="cpu")
    A = _scattered_symmetric()
    return (A, jax_as_operator(A, dtype=np.float64, format="ell"),
            as_operator(A, format="ell", device="cpu"))


@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_cheby_filter_matches_jax(kind):
    A, jop, op = _operators(kind)
    assert type(op).__name__ == type(jop).__name__
    lam = np.linalg.eigvalsh(A.toarray())
    lmin, lmax = lam[0] - 0.05, lam[-1] + 0.05
    mid = 0.5 * (lmin + lmax)
    coeffs = jf.jackson_cheby_coeffs(mid - 0.2, mid + 0.2, lmin, lmax, 150)
    X = np.random.default_rng(6).standard_normal((7, A.shape[0]))
    want = np.asarray(jf.cheby_filter(jop, X, coeffs, lmin, lmax))
    Xt = torch.from_numpy(X)
    got = pf.cheby_filter(op, Xt, coeffs, lmin, lmax)
    assert _rel(got, want) < 1e-12
    np.testing.assert_array_equal(Xt.numpy(), X)        # X is not modified


@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_kpm_moments_match_jax(kind):
    A, jop, op = _operators(kind)
    lam = np.linalg.eigvalsh(A.toarray())
    bounds = (lam[0] - 0.05, lam[-1] + 0.05)
    key = jax.random.key(9)
    Z = np.asarray(jax.random.rademacher(key, (8, A.shape[0]), dtype=np.float64))
    want = jf.spectral_moments(jop, 300, bounds=bounds, key=key)
    got = pf.spectral_moments(op, 300, bounds=bounds, _Z=Z)
    assert _rel(got, want) < 1e-12
    win = (bounds[0] + 1.0, bounds[0] + 2.0)
    np.testing.assert_allclose(pf.count_from_moments(got, win, bounds),
                               jf.count_from_moments(want, win, bounds),
                               rtol=1e-12)
    # a truncated count re-damps (degree-specific coefficients)
    assert pf.count_from_moments(got, win, bounds, degree=120) == \
        jf.count_from_moments(got, win, bounds, degree=120)


def test_rademacher_probes_from_the_generator():
    op = as_operator(laplace(300).tocsr(), device="cpu")
    bounds = (-4.05, 0.05)
    mu1 = pf.spectral_moments(op, 200, bounds=bounds,
                              generator=torch.Generator().manual_seed(3))
    mu2 = pf.spectral_moments(op, 200, bounds=bounds,
                              generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(mu1, mu2)
    full = laplace_eigen(300)
    for win in [(-2.5, -1.5), (-3.5, -3.0), (-1.0, -0.2)]:
        true = int(((full >= win[0]) & (full <= win[1])).sum())
        est = pf.count_from_moments(mu1, win, bounds)
        assert abs(est - true) < 0.3 * true + 3, (win, est, true)
    est = pf.estimate_window_count(laplace(300).tocsr(), (-2.5, -1.5),
                                   device="cpu",
                                   generator=torch.Generator().manual_seed(7))
    true = int(((full >= -2.5) & (full <= -1.5)).sum())
    assert abs(est - true) < 0.3 * true + 3


@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_spectrum_bounds_match_jax(kind):
    A, jop, op = _operators(kind)
    key = jax.random.key(3)
    v0 = np.asarray(rand_normalized_vector(key, A.shape[0], np.float64))
    want = jf.spectrum_bounds(jop, 40, key=key)
    got = pf.spectrum_bounds(op, 40, _v0=v0)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    lam = np.linalg.eigvalsh(A.toarray())
    assert got[0] <= lam[0] and got[1] >= lam[-1]


def test_filter_gains_separate_ghosts():
    rng = np.random.default_rng(11)
    n = 80
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(-2.0, 2.0, n)
    A = (Q * lam) @ Q.T
    lmin, lmax = -2.1, 2.1
    degree = 400
    delta = 2.5 * (lmax - lmin) / degree
    coeffs = jf.jackson_cheby_coeffs(-0.1 - delta, 0.1 + delta, lmin, lmax,
                                     degree)
    lo = int(np.searchsorted(lam, -0.1 - 6 * delta))
    hi = int(np.searchsorted(lam, 0.1 + 6 * delta)) + 1
    w = lam[hi] / (lam[hi] - lam[lo])
    ghost = np.sqrt(w) * Q[:, lo] + np.sqrt(1 - w) * Q[:, hi]
    V = np.stack([Q[:, int(np.argmin(np.abs(lam)))], ghost])
    want = np.asarray(jf._filter_gains(jax_as_operator(A, dtype=np.float64),
                                       V, coeffs, lmin, lmax))
    got = pf._filter_gains(as_operator(A, device="cpu"), torch.from_numpy(V),
                           coeffs, lmin, lmax).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert got[0] > 0.9 and got[1] < 0.3


# ------------------------------------------------------- eigsh_filtered

@pytest.mark.parametrize("subspace, degree", [(40, None), (24, 60)])
def test_nev_mode_matches_jax(subspace, degree):
    n = 200
    L = laplace(n).tocsr()
    X0 = np.random.default_rng(1).standard_normal((subspace, n))
    kw = dict(tol=1e-10, dtype=np.float64, bounds=BOUNDS_200,
              subspace=subspace, degree=degree, X0=X0)
    vj, _, hj = jf.eigsh_filtered(L, 4, (-2.2, -1.8), key=jax.random.key(0),
                                  **kw)
    vals, vecs, hist = eigsh_filtered(L, 4, (-2.2, -1.8), device="cpu", **kw)
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-10)
    assert hist.total_matvecs == hj.total_matvecs
    assert len(hist.residual_trace) == len(hj.residual_trace)
    np.testing.assert_array_equal(hist.restarts, hj.restarts)
    full = np.sort(laplace_eigen(n))
    want = full[(full >= -2.2) & (full <= -1.8)]
    want = np.sort(want[np.argsort(np.abs(want + 2.0))[:4]])
    np.testing.assert_allclose(vals, want, atol=1e-9)
    assert _residual(L, vals, vecs).max() < 1e-8
    V = to_numpy(vecs)
    np.testing.assert_allclose(V.T @ V, np.eye(4), atol=1e-9)


def test_all_inside_mode_matches_jax():
    n = 250
    L = laplace(n).tocsr()
    a, b = -2.2, -1.8
    key = jax.random.key(1)
    _, kx, kz = jax.random.split(key, 3)
    kz1, kz2 = jax.random.split(kz)
    Zs = {name: np.asarray(jax.random.rademacher(k, (8, n), dtype=np.float64))
          for name, k in (("sizing", kz1), ("count", kz2))}
    kw = dict(tol=1e-10, dtype=np.float64, bounds=BOUNDS_200)
    vj, _, hj, (_, Xj) = jf.eigsh_filtered(L, None, (a, b), key=key,
                                           _extras=True, **kw)
    s = Xj.shape[0]
    X0 = np.asarray(jax.random.normal(kx, (s, n), dtype=np.float64))
    vals, vecs, hist = eigsh_filtered(L, None, (a, b), X0=X0, device="cpu",
                                      _probes=Zs, **kw)
    full = np.sort(laplace_eigen(n))
    want = full[(full >= a) & (full <= b)]
    assert len(vals) == len(vj) == want.size
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-10)
    np.testing.assert_allclose(vals, want, atol=1e-9)
    assert hist.total_matvecs == hj.total_matvecs
    assert len(hist.residual_trace) == len(hj.residual_trace)
    assert hist.matvecs.shape == (len(vals),)
    assert _residual(L, vals, vecs).max() < 1e-9


# ------------------------------------------ float32 refined in float64

def test_f32_refined_meets_the_dw_gates():
    n = 200
    L = laplace(n).tocsr()
    vals, vecs, hist = eigsh_filtered(L, 4, (-2.2, -1.8), tol=1e-9,
                                      dtype=np.float32, device="cpu")
    assert vecs.dtype == torch.float64
    assert _residual(L, vals, vecs).max() < 4.0 * 1e-9
    full = np.sort(laplace_eigen(n))
    w = full[(full >= -2.2) & (full <= -1.8)]
    assert np.abs(vals[:, None] - w[None, :]).min(axis=1).max() < 1e-12
    assert np.unique(np.round(vals, 6)).size == 4


def test_f32_dense_refined():
    rng = np.random.default_rng(8)
    n = 96
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.linspace(-3.0, 3.0, n)
    A = (Q * lam) @ Q.T
    vals, vecs, _ = eigsh_filtered(A, 3, (-0.3, 0.3), tol=1e-9,
                                   dtype=np.float32, device="cpu")
    assert _residual(A, vals, vecs).max() < 3.0 * 3e-9
    assert np.abs(vals[:, None] - lam[None, :]).min(axis=1).max() < 1e-11


def test_refine_none_stays_f32():
    L = laplace(128).tocsr()
    vals, vecs, _ = eigsh_filtered(L, 3, (-2.2, -1.8), tol=3e-5,
                                   dtype=np.float32, refine=None,
                                   device="cpu")
    assert vecs.dtype == torch.float32
    assert _residual(L, vals, vecs).max() < 4 * 3e-5


# ------------------------------------------------------------------ errors

def test_not_converged_raises():
    L = laplace(100).tocsr()
    kw = dict(tol=1e-12, max_iters=1, degree=8, subspace=6, dtype=np.float64)
    with pytest.raises(RuntimeError, match="Has not converged !"):
        jf.eigsh_filtered(L, 3, (-2.1, -1.9), **kw)
    with pytest.raises(RuntimeError, match="Has not converged !"):
        eigsh_filtered(L, 3, (-2.1, -1.9), device="cpu", **kw)


def test_bad_arguments_raise():
    L = laplace(50).tocsr()
    with pytest.raises(ValueError, match="outside the spectral enclosure"):
        eigsh_filtered(L, 2, (10.0, 12.0), dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="empty interval"):
        eigsh_filtered(L, 2, (-1.0, -1.0), dtype=np.float64, device="cpu")
    with pytest.raises(ValueError, match="refine"):
        eigsh_filtered(L, 2, (-2.2, -1.8), refine="bogus", device="cpu")
    with pytest.raises(ValueError, match="real symmetric"):
        eigsh_filtered(L.astype(np.complex128), 2, (-2.2, -1.8), device="cpu")
    with pytest.raises(ValueError, match="device="):
        eigsh_filtered(L, 2, (-2.2, -1.8))


def test_mesh_is_not_ported():
    L = laplace(50).tocsr()
    for call in (lambda: eigsh_filtered(L, 2, (-2.2, -1.8), device="cpu",
                                        mesh=object()),
                 lambda: pf.eigsh_window(L, (-2.2, -1.8), device="cpu",
                                         mesh=object()),
                 lambda: pf.spectrum_bounds(L, device="cpu", mesh=object())):
        with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
            call()
