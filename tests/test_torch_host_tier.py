"""The port's host tier against the JAX package's, and the pieces it uses.

On the CPU the JAX package sends a SciPy/NumPy float64 scalar solve to its
host tier at any size; so does the port with ``device="cpu"``.  Both run
the same C++ engine on sparse input (or the same NumPy expansion on dense
input) from the same start vector, so matvec counts are EQUAL and the
results agree to rounding: eigenvalues within 1e-9 * max|lambda|, Schur
residuals within 10 * tol * max|lambda|.  ``mgs_dgks``/``mgs`` and
``RitzDecomposition`` match JAX's within 1e-12 on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnoldi_tpu import partial_eigh as jax_partial_eigh
from arnoldi_tpu import partial_schur as jax_partial_schur
from arnoldi_tpu.matrices import (
    laplace_2d,
    mark,
    random_scattered,
    random_scattered_complex_pairs,
)
from arnoldi_tpu.ops.ortho import ORTHO_KERNELS as JAX_ORTHO
from arnoldi_tpu.solvers.decomposition import (
    RitzDecomposition as JaxRitzDecomposition,
    arnoldi_decomposition as jax_arnoldi_decomposition,
)
from arnoldi_tpu_torch import (
    RitzDecomposition,
    arnoldi_decomposition,
    as_operator,
    partial_eigh,
    partial_schur,
)
from arnoldi_tpu_torch.native import host_engine
from arnoldi_tpu_torch.ops.ortho import ORTHO_KERNELS
from arnoldi_tpu_torch.solvers.workspace import uses_host_tier
from common import find_best_matching
from torch_parity import assert_quasi_triangular, schur_residuals, to_numpy

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
    "mark40_dense_LR": (lambda: mark(40).toarray(), 5, "LR"),
}


def _schur_both(case, **kw):
    gen, nev, which = CASES[case]
    A = gen()
    v0 = np.random.default_rng(0).standard_normal(A.shape[0])
    args = dict(max_dim=20, stopping_criterion=TOL, sort_function=which,
                max_restarts=1000, v0=v0)
    args.update(kw)
    return A, jax_partial_schur(A, nev, **args), partial_schur(
        A, nev, device="cpu", **args)


def _assert_schur_parity(A, ref, got):
    (Qj, Tj, hj), (Q, T, h) = ref, got
    assert torch.is_tensor(Q) and Q.device.type == "cpu"
    assert Q.dtype == T.dtype == torch.float64
    assert tuple(Q.shape) == np.shape(Qj) and tuple(T.shape) == np.shape(Tj)
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
def test_partial_schur_matches_jax_host_tier(case):
    _assert_schur_parity(*_schur_both(case))


@pytest.mark.parametrize("ortho", ["cgs2", "mgs_dgks"])
def test_partial_schur_host_orthos_match_jax(ortho):
    _assert_schur_parity(*_schur_both("mark40_LR", ortho=ortho))


@pytest.mark.parametrize("lock,p", [("hard", None), ("soft", 10), ("hard", 10)])
def test_partial_schur_lock_and_p_match_jax(lock, p):
    _assert_schur_parity(*_schur_both("mark40_LR", lock=lock, p=p))


@pytest.mark.parametrize("which,ortho", [("LA", "cgs_dgks"), ("SA", "cgs2"),
                                         ("LM", "mgs_dgks"), ("SM", "cgs_dgks")])
def test_partial_eigh_matches_jax_host_tier(which, ortho):
    A = laplace_2d(16, 15)
    v0 = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(which=which, max_dim=20, stopping_criterion=TOL, ortho=ortho,
              max_restarts=1000, v0=v0)
    vj, Vj, hj = jax_partial_eigh(A, 4, **kw)
    v, V, h = partial_eigh(A, 4, device="cpu", **kw)
    assert torch.is_tensor(V) and V.shape == np.shape(Vj)
    scale = np.abs(vj).max()
    np.testing.assert_allclose(v, vj, rtol=0, atol=1e-9 * scale)
    Vn = to_numpy(V)
    assert np.linalg.norm(A @ Vn - Vn * v, axis=0).max() <= 10 * TOL * scale
    np.testing.assert_allclose(Vn.T @ Vn, np.eye(4), atol=1e-10)
    assert h.total_matvecs == hj.total_matvecs
    assert len(h.residual_trace) == len(hj.residual_trace)


def test_bench_gate_case_on_the_host_tier(monkeypatch):
    # bench.py's correctness gate: laplace_2d(40, 39), 4 LA pairs, 1e-8;
    # device="cuda" takes the host tier at n = 1560, so it runs here too.
    from arnoldi_tpu.matrices import laplace_2d_eigen

    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    A = laplace_2d(40, 39)
    assert uses_host_tier(A, device="cuda")
    vals, vecs, hist = partial_eigh(A, 4, which="LA", stopping_criterion=1e-8,
                                    max_restarts=3000, device="cpu")
    want = np.sort(laplace_2d_eigen(40, 39))[-4:]
    assert np.abs(np.sort(vals) - want).max() < 1e-6
    V = to_numpy(vecs)
    assert np.linalg.norm(A @ V - V * vals, axis=0).max() < 1e-6
    engine = "engine.expand" in hist.phases
    assert engine == host_engine.available()
    assert engine or "host.expand" in hist.phases


@pytest.mark.parametrize("driver", ["schur", "eigh"])
def test_engine_and_numpy_paths_agree(driver, monkeypatch):
    A = mark(40)
    if driver == "schur":
        def solve():
            Q, T, h = partial_schur(A, 5, max_dim=24, stopping_criterion=1e-8,
                                    max_restarts=5000, sort_function="LM",
                                    device="cpu")
            return np.sort_complex(np.linalg.eigvals(to_numpy(T))), h
    else:
        A = (A + A.T) / 2

        def solve():
            v, _, h = partial_eigh(A, 5, max_dim=24, stopping_criterion=1e-8,
                                   which="LA", device="cpu")
            return v, h
    v1, h1 = solve()
    monkeypatch.setattr(host_engine, "engine_for", lambda *a, **k: None)
    v2, h2 = solve()
    np.testing.assert_allclose(v1, v2, rtol=1e-8)
    assert h1.total == h2.total


def test_routing_rule(monkeypatch):
    A = mark(20)                                   # n = 210
    assert uses_host_tier(A, device="cuda")
    assert uses_host_tier(A.toarray(), device="cuda", dtype=torch.float64)
    assert uses_host_tier(A, device="cuda", ortho="mgs_dgks")
    monkeypatch.setenv("ARNOLDI_HOST_TIER_N", "100")
    assert not uses_host_tier(A, device="cuda")    # n > cap on a card
    assert uses_host_tier(A, device="cpu")         # the CPU takes any size
    monkeypatch.delenv("ARNOLDI_HOST_TIER_N")
    for kw in (dict(block_size=2), dict(dtype=np.float32), dict(ortho="cgs"),
               dict(ortho="selective"), dict(device=None)):
        args = dict(dict(device="cuda"), **kw)
        assert not uses_host_tier(A, **args), kw
    assert not uses_host_tier(A.astype(np.float32), device="cuda")
    op = as_operator(A, device="cpu")
    assert not uses_host_tier(op, device="cpu")
    assert not uses_host_tier(torch.from_numpy(A.toarray()), device="cpu")


def test_host_tier_keeps_the_refusals():
    A = mark(10)
    with pytest.raises(ValueError, match="device="):
        partial_schur(A, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        partial_schur(A, 3, device="cpu", refine="dw")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        partial_schur(A, 3, device="cpu", v0=np.ones(55, np.complex128))


def _basis(n=200, m=12, seed=2):
    rng = np.random.default_rng(seed)
    Vt = np.zeros((m + 1, n))
    Vt[:m] = np.linalg.qr(rng.standard_normal((n, m)))[0].T
    return Vt, rng


@pytest.mark.parametrize("n_active", [0, 1, 7, 12])
@pytest.mark.parametrize("in_span", [False, True])
@pytest.mark.parametrize("name", ["mgs_dgks", "mgs"])
def test_mgs_matches_jax(name, in_span, n_active):
    # in_span: w mostly inside the active rows, so mgs_dgks's second pass
    # runs (mgs never takes it).
    Vt, rng = _basis()
    w = rng.standard_normal(Vt.shape[1])
    if in_span and n_active:
        w = 0.05 * w + rng.standard_normal(n_active) @ Vt[:n_active]
    got = ORTHO_KERNELS[name](torch.from_numpy(Vt), torch.from_numpy(w),
                              n_active, tol=1e-10)
    want = JAX_ORTHO[name](jnp.asarray(Vt), jnp.asarray(w), n_active, tol=1e-10)
    for g, r in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12)
    assert bool(got[3]) == bool(want[3])


def _factorization(A, m=12):
    n = A.shape[0]
    V = np.zeros((n, m + 1))
    V[:, 0] = np.random.default_rng(4).standard_normal(n)
    V[:, 0] /= np.linalg.norm(V[:, 0])
    return V, np.zeros((m + 1, m))


@pytest.mark.parametrize("ortho", ["cgs_dgks", "mgs_dgks"])
def test_arnoldi_decomposition_matches_jax(ortho):
    A = mark(12)
    V0, H0 = _factorization(A)
    V, H, k = arnoldi_decomposition(A, torch.from_numpy(V0), H0, ortho=ortho)
    Vj, Hj, kj = jax_arnoldi_decomposition(A, V0, H0, ortho=ortho)
    assert k == kj == 12 and tuple(V.shape) == (78, 13)
    np.testing.assert_allclose(V.numpy(), np.asarray(Vj), atol=1e-12)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), atol=1e-12)
    np.testing.assert_array_equal(H0, 0)          # the input is not touched


@pytest.mark.parametrize("case", ["mark12", "complex_pairs"])
def test_ritz_decomposition_matches_jax(case):
    # complex_pairs: complex Ritz values over a real basis, built from two
    # real matmuls on both sides.
    A = mark(12) if case == "mark12" else random_scattered_complex_pairs(
        256, 4, seed=0, bandwidth=32)
    V0, H0 = _factorization(A)
    Vj, Hj, _ = jax_arnoldi_decomposition(A, V0, H0)
    Vj, Hj = np.array(Vj), np.array(Hj)
    got = RitzDecomposition.from_v_and_h(torch.from_numpy(Vj), Hj, 4,
                                         sort_function="LR")
    want = JaxRitzDecomposition.from_v_and_h(
        Vj, Hj, 4, sort_function=lambda x: np.argsort(-np.real(x)))
    np.testing.assert_allclose(got.values, want.values, atol=1e-12)
    assert got.vectors.is_complex() == np.iscomplexobj(want.values)
    np.testing.assert_allclose(to_numpy(got.vectors), np.asarray(want.vectors),
                               atol=1e-12)
    np.testing.assert_allclose(got.approximate_residuals,
                               want.approximate_residuals, atol=1e-12)
    true_res = got.compute_true_residuals(A)
    np.testing.assert_allclose(true_res, want.compute_true_residuals(A),
                               atol=1e-12)
    # the residual identity ||A u - lambda u|| = |h_{m+1,m} s_m|
    np.testing.assert_allclose(true_res, got.approximate_residuals,
                               atol=1e-10)


# Integer-valued operators: the port promotes a non-float real dtype to
# np.result_type(dtype, float32), as the JAX package does, so int64 input
# solves in float64.  On the host tier the solve is JAX's own with
# dtype=np.float64 (equal matvec counts); through as_operator it takes the
# device path (its own counts; JAX's device path on the CPU is not run).
INT_DRIVERS = {
    "schur": (jax_partial_schur, partial_schur, 116),
    "eigh": (jax_partial_eigh, partial_eigh, 120),
}


def _int_values(driver, out):
    if driver == "eigh":
        return np.sort(np.asarray(out[0]))
    return np.sort_complex(np.linalg.eigvals(np.asarray(to_numpy(out[1]))))


def _int_case():
    A = laplace_2d(16, 15).astype(np.int64).tocsr()
    v0 = np.random.default_rng(0).standard_normal(A.shape[0])
    return A, dict(stopping_criterion=TOL, v0=v0)


@pytest.mark.parametrize("driver", sorted(INT_DRIVERS))
def test_integer_operator_matches_jax_float64(driver):
    jax_fn, fn, matvecs = INT_DRIVERS[driver]
    A, kw = _int_case()
    assert uses_host_tier(A, device="cpu")
    ref = jax_fn(A, 5, dtype=np.float64, **kw)
    got = fn(A, 5, device="cpu", **kw)
    assert got[1].dtype == torch.float64
    assert got[-1].total_matvecs == ref[-1].total_matvecs == matvecs
    assert len(got[-1].residual_trace) == len(ref[-1].residual_trace)
    np.testing.assert_allclose(_int_values(driver, got), _int_values(driver, ref),
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("driver", sorted(INT_DRIVERS))
def test_integer_operator_on_the_device_path(driver):
    from arnoldi_tpu.harness.suite import eigenvalues_match

    jax_fn, fn, _ = INT_DRIVERS[driver]
    A, kw = _int_case()
    op = as_operator(A, device="cpu")
    assert op.dtype == torch.int64
    got = fn(op, 5, **kw)
    assert got[1].dtype == torch.float64
    ref = jax_fn(A, 5, dtype=np.float64, **kw)
    which = "LA" if driver == "eigh" else "LM"
    assert eigenvalues_match(_int_values(driver, got), _int_values(driver, ref),
                             which, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dtype,want", [
    (np.int64, torch.float64), (np.int32, torch.float64),
    (np.int16, torch.float32), (np.bool_, torch.float32),
    (np.float32, torch.float32), (torch.int64, torch.float64),
    (torch.complex64, torch.complex64)])
def test_solver_dtype_promotes_as_jax(dtype, want):
    from arnoldi_tpu_torch.device import solver_dtype

    assert solver_dtype(dtype) == want
