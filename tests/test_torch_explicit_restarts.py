"""The port's explicit-restart drivers against the JAX package's
(``arnoldi_tpu/solvers/explicit_restarts.py``), on the CPU: Saad's table
6.2 anchors and convergence of ``naive_explicit_restarts``, ARPACK
matching and the failure path of ``explicit_restarts_with_deflation``, the
same restarts, matvecs and values (within 1e-10) as JAX from the same
start vectors, and the two faults of the reference's completeness
backstop that the port does not copy, each on an input that triggers it.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import eigs

from arnoldi_tpu.harness.suite import eigenvalues_match
from arnoldi_tpu.matrices import mark
from arnoldi_tpu.solvers import explicit_restarts as je
from arnoldi_tpu.utils.random import rand_normalized_vector
from arnoldi_tpu_torch import (History, explicit_restarts_with_deflation,
                               naive_explicit_restarts)
from arnoldi_tpu_torch.solvers import explicit_restarts as pe
from arnoldi_tpu_torch.utils.sorting import arg_largest_magnitude
from common import find_best_matching
from torch_parity import to_numpy

torch.set_num_threads(1)


def _jax_start(seed, n, dtype=np.complex128):
    return np.asarray(rand_normalized_vector(jax.random.key(seed), n, dtype))


def _jax_slot_starts(seed, n, count=12, dtype=np.complex128):
    """The start vectors JAX's deflation driver draws for its slots from
    ``key(seed)``: one ``split`` a slot."""
    key, out = jax.random.key(seed), []
    for _ in range(count):
        key, sub = jax.random.split(key)
        out.append(np.asarray(rand_normalized_vector(sub, n, dtype)))
    return out


def _feed(monkeypatch, vectors):
    """Make JAX's deflation driver draw ``vectors`` in turn."""
    it = iter(vectors)
    monkeypatch.setattr(je, "rand_normalized_vector",
                        lambda key, n, dtype=None: jax.numpy.asarray(
                            next(it), dtype=dtype))


# ------------------------------------------------------------------ naive

@pytest.mark.parametrize("restarts, digits",
                         [(1, 0), (2, 1), (3, 3), (4, 5), (5, 6)])
def test_naive_saad_table_6_2(restarts, digits):
    A = mark(10)
    v0 = _jax_start(21, A.shape[0])
    ritz, _, n_restarts = naive_explicit_restarts(A, 10, max_restarts=restarts,
                                                  device="cpu", _v0=v0)
    res = ritz.compute_true_residuals(A)[0]
    assert res <= 2 * 10 ** (-digits)
    rj, _, ij = je.naive_explicit_restarts(A, 10, max_restarts=restarts,
                                           key=jax.random.key(21))
    assert n_restarts == ij
    np.testing.assert_allclose(ritz.values, rj.values, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res, rj.compute_true_residuals(A)[0],
                               rtol=1e-6)


def test_naive_convergence():
    A = mark(10)
    ritz, has_converged, _ = naive_explicit_restarts(
        A, 20, max_restarts=200, stopping_criterion=1e-6, device="cpu",
        generator=torch.Generator().manual_seed(2))
    assert has_converged
    assert ritz.compute_true_residuals(A)[0] <= 1e-6
    assert ritz.vectors.dtype == torch.complex128


def test_naive_matches_jax_to_convergence():
    A = mark(12)
    v0 = _jax_start(2, A.shape[0])
    kw = dict(max_restarts=200, stopping_criterion=1e-8)
    rj, cj, ij = je.naive_explicit_restarts(A, 20, key=jax.random.key(2), **kw)
    ritz, conv, n_restarts = naive_explicit_restarts(A, 20, device="cpu",
                                                     _v0=v0, **kw)
    assert conv and cj and n_restarts == ij
    np.testing.assert_allclose(ritz.values, rj.values, rtol=0, atol=1e-10)


def test_naive_real_work_dtype():
    A = mark(10)
    ritz, conv, _ = naive_explicit_restarts(A, 20, max_restarts=200,
                                            stopping_criterion=1e-8,
                                            dtype=np.float64, device="cpu")
    assert conv
    assert ritz.compute_true_residuals(A)[0] <= 1e-8 * abs(ritz.values[0])


# -------------------------------------------------------------- deflation

def _ensure_values_match_with_arpack(A, k, max_dim=None, which="LM", tol=None,
                                     max_restarts=100, seed=31):
    sort_function = None if which == "LM" else which
    r_vals = eigs(A, k, which=which)[0]
    vals, vecs, history = explicit_restarts_with_deflation(
        A, k, max_dim=max_dim, stopping_criterion=tol,
        sort_function=sort_function, max_restarts=max_restarts,
        device="cpu", generator=torch.Generator().manual_seed(seed))
    V = to_numpy(vecs)
    residuals = np.linalg.norm(A @ V - vals * V, axis=0)
    assert isinstance(history, History) and history.k == k
    np.testing.assert_allclose(residuals, 0, rtol=1e-4, atol=1e-8)
    vals, r_vals = find_best_matching(vals, r_vals)
    np.testing.assert_allclose(vals, r_vals, rtol=1e-4, atol=1e-8)
    return history


def test_deflation_saad_table_6_3():
    history = _ensure_values_match_with_arpack(mark(10), 3, 10, which="LR",
                                               tol=1e-8)
    assert history.total_matvecs > 0
    assert all(history.restarts >= 1)


def test_deflation_simple():
    rng = np.random.default_rng(17)
    D = np.diag([7, 7, 5, 4, 3, 2, 1]).astype(float)
    Q, _ = np.linalg.qr(rng.standard_normal((7, 7)))
    _ensure_values_match_with_arpack(sp.csr_matrix(Q.T @ D @ Q), 3)


def test_deflation_fail_convergence():
    with pytest.raises(ValueError, match="Could not converge for value 0"):
        _ensure_values_match_with_arpack(mark(10), 3, max_dim=5, tol=1e-16,
                                         max_restarts=10)


@pytest.mark.parametrize("case", ["mark10_LR", "mark12_LM", "mark12_LM_real"])
def test_deflation_matches_jax(case):
    A, nev, max_dim, which = {"mark10_LR": (mark(10), 3, 10, "LR"),
                              "mark12_LM": (mark(12), 4, 12, "LM"),
                              "mark12_LM_real": (mark(12), 4, 12, "LM")}[case]
    dtype = np.float64 if case.endswith("real") else None
    kw = dict(max_dim=max_dim, stopping_criterion=1e-8, sort_function=which,
              dtype=dtype)
    vj, Vj, hj = je.explicit_restarts_with_deflation(A, nev,
                                                     key=jax.random.key(31),
                                                     **kw)
    starts = _jax_slot_starts(31, A.shape[0],
                              dtype=np.complex128 if dtype is None else dtype)
    vals, vecs, hist = explicit_restarts_with_deflation(A, nev, device="cpu",
                                                        _v0s=starts, **kw)
    np.testing.assert_array_equal(hist.matvecs, hj.matvecs)
    np.testing.assert_array_equal(hist.restarts, hj.restarts)
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-10)
    V = to_numpy(vecs)
    assert np.linalg.norm(A @ V - V * vals, axis=0).max() < 1e-7


def test_deflation_completeness_backstop_tight_window():
    """At ncv = 2 nev on mark, locking one pair at a time can starve the
    +/- twin of a locked pair; the backstop returns the true top set."""
    A = mark(40)
    ref = eigs(A, 8, which="LM", ncv=40)[0]
    for seed in range(2):
        vals, _, _ = explicit_restarts_with_deflation(
            A, 8, max_dim=16, stopping_criterion=1e-8, max_restarts=100_000,
            device="cpu", _v0s=_jax_slot_starts(seed, A.shape[0], count=20))
        assert eigenvalues_match(vals, ref, "LM"), (seed, vals, ref)


# ------------------------------------- reference faults the port leaves out

def test_backstop_probe_that_runs_out_keeps_the_result(monkeypatch):
    """ADVICE r05, ``explicit_restarts.py:274``: both wanted pairs lock
    at once (their start vectors are eigenvectors), then the backstop's
    extra slot, on a cluster, runs out of restarts.  JAX raises; the port
    returns the converged pairs."""
    n = 60
    A = sp.diags(np.concatenate([[10.0, 9.0],
                                 8.0 - 0.01 * np.arange(n - 2)])).tocsr()
    rng = np.random.default_rng(0)
    starts = [np.eye(n)[0], np.eye(n)[1]] + [rng.standard_normal(n)
                                              for _ in range(5)]
    starts = [(v / np.linalg.norm(v)).astype(np.complex128) for v in starts]
    kw = dict(max_dim=6, stopping_criterion=1e-10, max_restarts=2)
    _feed(monkeypatch, starts)
    with pytest.raises(ValueError, match="Could not converge for value 2"):
        je.explicit_restarts_with_deflation(A, 2, **kw)
    vals, vecs, hist = explicit_restarts_with_deflation(A, 2, device="cpu",
                                                        _v0s=starts, **kw)
    np.testing.assert_allclose(vals, [10.0, 9.0], atol=1e-12)
    np.testing.assert_array_equal(hist.restarts, [1, 1])


def test_backstop_in_top_scales_with_the_tolerance():
    """ADVICE r05, ``explicit_restarts.py:279``: the probed value and its
    locked Rayleigh quotient agree to rounding, which the non-normal or
    single-precision solve lifts above 1e-10 relative while staying far
    inside the solve's tolerance.  Here the probe converged 0.9 (top 2 of
    [1.0, 0.8, 0.9]) at 1e-9 relative from its diagonal entry: the
    reference's test (rtol 1e-10) ends the probe, the port's (10 tol)
    goes on."""
    H = np.diag([1.0, 0.8, 0.9 * (1 + 1e-9)]).astype(np.complex128)
    lam_new = 0.9
    top = np.linalg.eigvals(H)[np.asarray(arg_largest_magnitude(
        np.linalg.eigvals(H)))[:2]]
    assert not np.any(np.isclose(lam_new, top, rtol=1e-10, atol=1e-12))
    assert pe._probe_continues(lam_new, H, arg_largest_magnitude, 2, 1e-8)
    # a value that ranks below the top nev still ends the probe
    assert not pe._probe_continues(0.7, np.diag([1.0, 0.8, 0.7]),
                                   arg_largest_magnitude, 2, 1e-8)
    # as does the tied twin of the displaced nev-th value
    assert not pe._probe_continues(-0.8, np.diag([1.0, 0.8, -0.8]),
                                   arg_largest_magnitude, 2, 1e-8)


def test_mgs_orthogonalize():
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.standard_normal((30, 4)))
    w = rng.standard_normal(30)
    v = to_numpy(pe.mgs_orthogonalize(torch.from_numpy(Q), torch.from_numpy(w),
                                      1e-12))
    np.testing.assert_allclose(Q.T @ v, 0, atol=1e-14)
    np.testing.assert_allclose(np.linalg.norm(v), 1.0, rtol=1e-14)
    np.testing.assert_allclose(v, np.asarray(je.mgs_orthogonalize(Q, w, 1e-12)),
                               atol=1e-13)
    with pytest.raises(AssertionError, match="Too small norm"):
        pe.mgs_orthogonalize(torch.from_numpy(Q), torch.from_numpy(Q[:, 0]),
                             1e-12)
