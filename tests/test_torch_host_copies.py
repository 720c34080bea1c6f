"""The port's copies of the JAX package's host modules against their
originals: ``matrices``, ``utils.sorting``, ``utils.history``, the dense
tier (``ops/dense_tier.py`` over ``native/dense_tier.cpp``) and the host-tier
engine (``native/host_engine.cpp``).  The copies are the same NumPy/SciPy/C++
arithmetic, so the matrices and orderings must be equal and the C++ results
equal to rounding (1e-13; the two libraries are one source built twice)."""

import numpy as np
import pytest
import scipy.sparse as sp

from arnoldi_tpu import matrices as jax_matrices
from arnoldi_tpu.native import host_engine as jax_host_engine
from arnoldi_tpu.ops import dense_tier as jax_dense_tier
from arnoldi_tpu.utils import history as jax_history
from arnoldi_tpu.utils import sorting as jax_sorting
from arnoldi_tpu_torch import matrices
from arnoldi_tpu_torch.native import BUILD_DIR, host_engine
from arnoldi_tpu_torch.native import dense_tier as native_dense_tier
from arnoldi_tpu_torch.ops import dense_tier
from arnoldi_tpu_torch.utils import history, sorting

#: C++ results of the copy against the original: one source, two builds.
CPP_TOL = 1e-13

MATRIX_CASES = {
    "mark_2": lambda m: m.mark(2),
    "mark_15": lambda m: m.mark(15),
    "mark_40_f32": lambda m: m.mark(40, dtype=np.float32),
    "laplace_2d_12": lambda m: m.laplace_2d(12),
    "laplace_2d_9x7": lambda m: m.laplace_2d(9, 7),
    "scattered": lambda m: m.random_scattered(300, 8, seed=3),
    "scattered_bandwidth": lambda m: m.random_scattered(400, 6, seed=4,
                                                       bandwidth=16),
    "scattered_block": lambda m: m.random_scattered(256, 24, seed=1, block=8),
    "scattered_block_bandwidth": lambda m: m.random_scattered(
        512, 24, seed=1, bandwidth=64, block=8),
    "scattered_reflect": lambda m: m.random_scattered(
        400, 10, seed=5, bandwidth=30, edge="reflect"),
    "scattered_block_reflect": lambda m: m.random_scattered(
        512, 16, seed=6, bandwidth=40, block=4, edge="reflect"),
    "scattered_f32": lambda m: m.random_scattered(200, 5, seed=7,
                                                  dtype=np.float32),
    "complex_pairs": lambda m: m.random_scattered_complex_pairs(300, seed=2),
    "complex_pairs_block_bandwidth": lambda m: m.random_scattered_complex_pairs(
        320, 12, seed=8, bandwidth=32, block=4, n_pairs=4),
}


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_matrices_equal_the_original(case):
    got, want = MATRIX_CASES[case](matrices), MATRIX_CASES[case](jax_matrices)
    got, want = sp.csr_matrix(got), sp.csr_matrix(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.indptr, want.indptr)
    assert np.array_equal(got.indices, want.indices)
    assert np.array_equal(got.data, want.data)


@pytest.mark.parametrize("nx,ny", [(7, None), (9, 4)])
def test_analytic_spectra_equal_the_original(nx, ny):
    assert np.array_equal(matrices.laplace_2d_eigen(nx, ny),
                          jax_matrices.laplace_2d_eigen(nx, ny))
    assert np.array_equal(matrices.laplace_eigen(nx), jax_matrices.laplace_eigen(nx))


def test_matrices_refuse_as_the_original():
    for mod in (matrices, jax_matrices):
        with pytest.raises(ValueError, match="mark"):
            mod.mark(1)
        with pytest.raises(ValueError, match="edge="):
            mod.random_scattered(64, 4, bandwidth=8, edge="wrap")


def _values():
    # ties in every key (equal magnitudes, real and imaginary parts) so the
    # stable order matters
    rng = np.random.default_rng(11)
    z = rng.standard_normal(40) + 1j * rng.standard_normal(40)
    return np.concatenate([z, np.conj(z[:8]), -z[:5], [1.0, -1.0, 1j, -1j, 0.0]])


def test_sorting_registers_the_same_functions():
    assert sorted(sorting.SORT_FUNCTIONS) == sorted(jax_sorting.SORT_FUNCTIONS)


@pytest.mark.parametrize("which", sorted(jax_sorting.SORT_FUNCTIONS))
def test_sort_function_equals_the_original(which):
    x = _values()
    got = sorting.sort_function_for(which)(x)
    assert np.array_equal(got, jax_sorting.sort_function_for(which)(x))
    assert np.array_equal(sorting.SORT_FUNCTIONS[which](x.real),
                          jax_sorting.SORT_FUNCTIONS[which](x.real))


def test_sort_function_refusal_and_callables():
    with pytest.raises(ValueError, match="Unknown 'which'") as got:
        sorting.sort_function_for("XX")
    with pytest.raises(ValueError, match="Unknown 'which'") as want:
        jax_sorting.sort_function_for("XX")
    assert str(got.value) == str(want.value)
    fn = sorting.arg_largest_real
    assert sorting.sort_function_for(fn) is fn


def test_history_equals_the_original():
    h, g = history.History.from_k(4), jax_history.History.from_k(4)
    for rec in (h, g):
        rec.matvecs[:] = [3, 5, 7, 9]
        rec.restarts[:] = [1, 1, 2, 2]
    assert h.k == g.k and h.total_matvecs == g.total_matvecs == 24
    h.total = g.total = 11
    assert h.total_matvecs == g.total_matvecs == 11
    assert [f.name for f in history.dataclasses.fields(h)] == \
        [f.name for f in jax_history.dataclasses.fields(g)]


def _hessenberg(n, seed, complex_):
    rng = np.random.default_rng(seed)
    H = np.triu(rng.standard_normal((n, n)), -1)
    if complex_:
        H = H + 1j * np.triu(rng.standard_normal((n, n)), -1)
    return H


def test_dense_tier_copy_is_native_and_builds_outside_the_sources():
    assert native_dense_tier.available()
    assert dense_tier._native() is native_dense_tier
    assert (BUILD_DIR / "libdense_tier.so").exists()


@pytest.mark.parametrize("which", ["LM", "LR", "SR"])
@pytest.mark.parametrize("n,seed", [(20, 0), (40, 1)])
def test_ordered_schur_complex_equals_the_original(n, seed, which):
    H = _hessenberg(n, seed, complex_=True)
    T, Z = dense_tier.ordered_schur(H, sort_function=sorting.SORT_FUNCTIONS[which])
    T0, Z0 = jax_dense_tier.ordered_schur(
        H, sort_function=jax_sorting.SORT_FUNCTIONS[which])
    np.testing.assert_allclose(T, T0, rtol=0, atol=CPP_TOL)
    np.testing.assert_allclose(Z, Z0, rtol=0, atol=CPP_TOL)


@pytest.mark.parametrize("which", ["LM", "LR", "SR"])
@pytest.mark.parametrize("n,seed", [(20, 2), (40, 3)])
def test_ordered_schur_real_equals_the_original(n, seed, which):
    H = _hessenberg(n, seed, complex_=False)
    T, Z, vals = dense_tier.ordered_schur_real(
        H, sort_function=sorting.SORT_FUNCTIONS[which])
    T0, Z0, vals0 = jax_dense_tier.ordered_schur_real(
        H, sort_function=jax_sorting.SORT_FUNCTIONS[which])
    np.testing.assert_allclose(T, T0, rtol=0, atol=CPP_TOL)
    np.testing.assert_allclose(Z, Z0, rtol=0, atol=CPP_TOL)
    np.testing.assert_allclose(vals, vals0, rtol=0, atol=CPP_TOL)


def _expanded(A, max_dim, engine_mod, ortho):
    n = A.shape[0]
    v0 = np.random.default_rng(1).standard_normal(n)
    Vt = np.zeros((max_dim + 1, n))
    H = np.zeros((max_dim + 1, max_dim))
    Vt[0] = v0 / np.linalg.norm(v0)
    eng = engine_mod.engine_for(A, np.float64, max_dim, ortho)
    assert eng is not None
    _, _, it = eng.expand(Vt, H, 1e-12, start_dim=0, max_dim=max_dim,
                          ortho=ortho)
    return eng, Vt, H, it


@pytest.mark.parametrize("ortho", ["cgs_dgks", "cgs2", "mgs_dgks"])
def test_host_engine_expand_and_cycle_equal_the_original(ortho):
    A = jax_matrices.random_scattered(600, 6, seed=9, bandwidth=40)
    max_dim, pa = 20, 8
    runs = []
    for mod in (host_engine, jax_host_engine):
        eng, Vt, H, it = _expanded(A, max_dim, mod, ortho)
        Qp = np.linalg.qr(np.random.default_rng(2).standard_normal(
            (max_dim, max_dim)))[0][:, :pa]
        H_new = np.zeros_like(H)
        H_new[:pa, :pa] = Qp.T @ H[:max_dim, :max_dim] @ Qp
        H_new[pa, :pa] = H[max_dim, max_dim - 1] * Qp[max_dim - 1, :]
        out = np.empty_like(Vt)
        _, _, it2 = eng.cycle(Vt, out, H_new, Qp, m=max_dim, pa=pa, carry=1,
                              max_dim=max_dim, tol=1e-12, ortho=ortho)
        runs.append((Vt, H, it, out, H_new, it2))
    (Vt, H, it, out, H2, it2), (Vt0, H0, it0, out0, H20, it20) = runs
    assert it == it0 == max_dim and it2 == it20
    for got, want in ((Vt, Vt0), (H, H0), (out, out0), (H2, H20)):
        np.testing.assert_allclose(got, want, rtol=0, atol=CPP_TOL)
    assert (BUILD_DIR / "libhost_engine.so").exists()
