"""The port's block Krylov-Schur pieces against the JAX package's:
``block_cgs2``, one block expansion against ``_block_expand_jit``, every
format's ``matmat``, and block ``partial_schur`` (JAX's device path: its
host tier takes block_size = 1 only).

Both sides start from the same block: v0 and the b - 1 rows JAX draws from
``jax.random.key(0)`` (``krylov_schur.py:421-422``), handed to the port
through its private ``_start_block``.  Tolerances: block_cgs2 outputs
within 1e-12 (float64 gemms over the same rows in another order);
Hungarian-matched eigenvalues within 1e-9 * max|lambda|; Schur residuals
within 10 * tol * max|lambda|; matvec counts and restart counts EQUAL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from arnoldi_tpu import partial_schur as jax_partial_schur
from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import (
    laplace_2d,
    mark,
    random_scattered,
    random_scattered_complex_pairs,
)
from arnoldi_tpu.ops.ortho import block_cgs2 as jax_block_cgs2
from arnoldi_tpu.solvers.decomposition import _block_expand_jit
from arnoldi_tpu_torch import as_operator, partial_schur
from arnoldi_tpu_torch.ops.ortho import block_cgs2
from arnoldi_tpu_torch.solvers.decomposition import block_arnoldi_expand
from arnoldi_tpu_torch.utils.sorting import sort_function_for
from common import find_best_matching
from torch_parity import (
    assert_quasi_triangular,
    jax_start_block,
    port_operator,
    schur_residuals,
    to_numpy,
)

torch.set_num_threads(1)

TOL = 1e-10


def _basis(n=400, mp=24, j=10, b=4, seed=3):
    """``tests/test_block_lanczos.py::TestBlockCGS2``'s workspace."""
    rng = np.random.default_rng(seed)
    Vt = np.zeros((mp, n))
    Vt[:j] = np.linalg.qr(rng.standard_normal((n, j)))[0].T
    return Vt, rng.standard_normal((b, n)), j


def test_block_cgs2_matches_jax_on_a_healthy_block():
    Vt, W, j = _basis()
    C, Q, R, bd = block_cgs2(torch.from_numpy(Vt), torch.from_numpy(W), j,
                             tol=1e-12)
    Cj, Qj, Rj, bdj = jax_block_cgs2(jnp.asarray(Vt), jnp.asarray(W), j,
                                     tol=1e-12)
    for got, want in ((C, Cj), (Q, Qj), (R, Rj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)
    assert bd.shape == () and bd.dtype == torch.bool
    assert not bool(bd) and not bool(bdj)
    Qh = Q.numpy()
    np.testing.assert_allclose(Qh @ Qh.T, np.eye(4), atol=1e-12)
    np.testing.assert_allclose(Vt[:j] @ Qh.T, 0, atol=1e-12)
    np.testing.assert_allclose(C.numpy().T @ Vt + R.numpy().T @ Qh, W, atol=1e-10)
    np.testing.assert_array_equal(C.numpy()[j:], 0)
    np.testing.assert_array_equal(np.tril(R.numpy(), -1), 0)


def test_block_cgs2_flags_a_rank_deficient_block():
    Vt, W, j = _basis()
    W = np.vstack([W[:1]] * 4)
    C, Q, R, bd = block_cgs2(torch.from_numpy(Vt), torch.from_numpy(W), j,
                             tol=1e-8)
    *_, bdj = jax_block_cgs2(jnp.asarray(Vt), jnp.asarray(W), j, tol=1e-8)
    assert bool(bd) and bool(bdj)
    assert torch.isfinite(Q).all()          # the shift keeps it finite


def test_block_cgs2_flags_a_block_inside_the_basis():
    # W in the span of the active rows: the projected block is rounding
    # noise, far below the absolute tolerance.
    Vt, _, j = _basis()
    W = np.random.default_rng(9).standard_normal((4, j)) @ Vt[:j]
    *_, bd = block_cgs2(torch.from_numpy(Vt), torch.from_numpy(W), j, tol=1e-8)
    *_, bdj = jax_block_cgs2(jnp.asarray(Vt), jnp.asarray(W), j, tol=1e-8)
    assert bool(bd) and bool(bdj)


def test_block_cgs2_with_no_active_rows():
    Vt, W, _ = _basis()
    C, Q, R, bd = block_cgs2(torch.from_numpy(Vt), torch.from_numpy(W), 0)
    *_, Qj, _, _ = jax_block_cgs2(jnp.asarray(Vt), jnp.asarray(W), 0)
    np.testing.assert_array_equal(C.numpy(), 0)
    np.testing.assert_allclose(Q.numpy(), np.asarray(Qj), atol=1e-12)
    assert not bool(bd)


def test_block_cgs2_float32():
    Vt, W, j = _basis()
    C, Q, R, bd = block_cgs2(torch.from_numpy(Vt).float(),
                             torch.from_numpy(W).float(), j, tol=1e-5)
    assert Q.dtype == torch.float32 and not bool(bd)
    np.testing.assert_allclose(Q.numpy() @ Q.numpy().T, np.eye(4), atol=1e-5)


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_one_block_expansion_matches_jax(fmt):
    A = random_scattered(512, 24, seed=1, bandwidth=64, block=8)
    b, n_blocks = 4, 5
    jop = jax_as_operator(A, format=fmt)
    n = A.shape[0]
    Vt0 = np.zeros((n_blocks * b + b, n))
    H0 = np.zeros((n_blocks * b + b, n_blocks * b))
    Vt0[:b] = np.asarray(jax_block_cgs2(
        jnp.asarray(Vt0), jnp.asarray(jax_start_block(n, b, np.ones(n))), 0)[1])
    Vj, Hj, jb = _block_expand_jit(jop, jnp.asarray(Vt0), jnp.asarray(H0),
                                   1e-10, start_block=0, n_blocks=n_blocks, b=b)
    V, H, done = block_arnoldi_expand(port_operator(jop), torch.from_numpy(Vt0),
                                      torch.from_numpy(H0), 1e-10, start_block=0,
                                      n_blocks=n_blocks, b=b)
    assert done == int(jb) == n_blocks
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), atol=1e-12)
    np.testing.assert_allclose(V.numpy(), np.asarray(Vj), atol=1e-12)
    # the Arnoldi relation A V[:m]^T = V[:m+b]^T H
    m = n_blocks * b
    np.testing.assert_allclose(A @ V.numpy()[:m].T, V.numpy().T @ H.numpy(),
                               atol=1e-12)


def test_block_expansion_stops_at_breakdown():
    # The start block spans an invariant subspace of dimension 4, so the
    # second step breaks down; both expansions report 1 block done.
    n, b = 40, 2
    D = np.diag(np.arange(1.0, n + 1))
    Vt0 = np.zeros((3 * b + b, n))
    Vt0[0, :2] = Vt0[1, 2:4] = 1.0
    Vt0[1] /= np.sqrt(2)
    Vt0[0] /= np.sqrt(2)
    H0 = np.zeros((3 * b + b, 3 * b))
    jop = jax_as_operator(D)
    _, Hj, jb = _block_expand_jit(jop, jnp.asarray(Vt0), jnp.asarray(H0), 1e-10,
                                  start_block=0, n_blocks=3, b=b)
    V, H, done = block_arnoldi_expand(port_operator(jop), torch.from_numpy(Vt0),
                                      torch.from_numpy(H0), 1e-10, start_block=0,
                                      n_blocks=3, b=b)
    assert done == int(jb) == 1
    np.testing.assert_allclose(H.numpy(), np.asarray(Hj), atol=1e-12)


MATMAT_CASES = {
    "dense": (lambda: np.random.default_rng(5).standard_normal((30, 30)), None),
    "banded": (lambda: laplace_2d(9, 7), "banded"),
    "ell": (lambda: mark(12), "ell"),
    "ell_rectangular": (lambda: sp.random(50, 40, density=0.2, random_state=1,
                                          format="csr"), "ell"),
    "bsr": (lambda: mark(12), ("bsr", (8, 8))),
}


@pytest.mark.parametrize("b", [1, 8, 9])
@pytest.mark.parametrize("case", sorted(MATMAT_CASES))
def test_matmat_matches_jax(case, b):
    gen, fmt = MATMAT_CASES[case]
    A = gen()
    ref = jax_as_operator(A, format=fmt)
    op = as_operator(A, format=fmt, device="cpu")
    X = np.random.default_rng(b).standard_normal((A.shape[1], b))
    want = np.asarray(ref.matmat(jnp.asarray(X)))
    got = op.matmat(torch.from_numpy(X))
    assert tuple(got.shape) == (A.shape[0], b)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    rows = op.matmat_rows(torch.from_numpy(np.ascontiguousarray(X.T)))
    np.testing.assert_allclose(rows.numpy(), want.T, atol=1e-12)


def _diag_conj(d, seed):
    rng = np.random.default_rng(seed)
    Qo, _ = np.linalg.qr(rng.standard_normal((len(d), len(d))))
    return Qo.T @ np.diag(d) @ Qo


BLOCK_CASES = {
    # name: (matrix, nev, which, b, max_dim, format)
    "laplace_2d_16x15_LM_b4": (lambda: laplace_2d(16, 15), 4, "LM", 4, 20, None),
    "laplace_2d_16_LM_b2": (lambda: laplace_2d(16), 6, "LM", 2, 24, None),
    "mark10_LM_b2": (lambda: mark(10), 4, "LM", 2, 16, None),
    "mark12_LR_b3_p9": (lambda: mark(12), 6, "LR", 3, 21, None),
    "scattered_bsr_LR_b8": (lambda: random_scattered(4096, 24, seed=1,
                                                     bandwidth=256, block=8),
                            5, "LR", 8, 40, ("bsr", (8, 8))),
    "scattered_ell_LR_b8": (lambda: random_scattered(4096, 24, seed=1,
                                                     bandwidth=256, block=8),
                            5, "LR", 8, 40, None),
    # tests/test_block_lanczos.py:111-125: a double eigenvalue that the
    # scalar driver sees once
    "double_eigenvalue_LR_b2": (lambda: _diag_conj(
        np.concatenate([[7.0, 7.0, 5.0], np.linspace(4, 0.1, 37)]), 5),
        3, "LR", 2, 20, None),
    "complex_pairs_LR_b2": (lambda: random_scattered_complex_pairs(
        1024, 8, seed=0, bandwidth=64), 4, "LR", 2, 20, None),
}


def _both(case, **kw):
    gen, nev, which, b, max_dim, fmt = BLOCK_CASES[case]
    A = gen()
    n = A.shape[0]
    v0 = np.random.default_rng(0).standard_normal(n)
    jop = jax_as_operator(A, format=fmt)
    args = dict(max_dim=max_dim, stopping_criterion=TOL, sort_function=which,
                max_restarts=1000, dtype=np.float64, block_size=b)
    args.update(kw)
    ref = jax_partial_schur(jop, nev, v0=v0, **args)
    got = partial_schur(port_operator(jop), nev,
                        _start_block=jax_start_block(n, b, v0), **args)
    return A, ref, got


def _multiple_eigenvalues(lam_ref, which, nev, scale):
    """The wanted pairs in lock order (JAX's values sorted by ``which``)
    grouped into runs of one eigenvalue: equal within 1e-8 of the
    spectrum's scale."""
    vals = lam_ref[np.asarray(sort_function_for(which)(lam_ref))][:nev]
    groups = [[0]]
    for i in range(1, nev):
        if abs(vals[i] - vals[i - 1]) <= 1e-8 * scale:
            groups[-1].append(i)
        else:
            groups.append([i])
    return groups


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_matches_jax_device_path(case):
    A, (Qj, Tj, hj), (Q, T, h) = _both(case, p=9 if case.endswith("p9") else None)
    assert tuple(Q.shape) == tuple(np.shape(Qj))
    lam = np.linalg.eigvals(to_numpy(T))
    lam_ref = np.linalg.eigvals(np.asarray(Tj))
    scale = np.abs(lam_ref).max()
    a, b = find_best_matching(lam, lam_ref)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9 * scale)
    assert schur_residuals(A, Q, T).max() <= 10 * TOL * scale
    assert_quasi_triangular(T)
    assert h.total_matvecs == hj.total_matvecs
    assert len(h.residual_trace) == len(hj.residual_trace)
    # A simple eigenvalue locks at JAX's matvec count.  The members of a
    # multiple one lock in an order that rounding decides (how the first
    # restarts split the eigenspace): the cluster's last lock is JAX's,
    # and each member locks within one restart of JAX's.
    _, nev, which, *_ = BLOCK_CASES[case]
    for group in _multiple_eigenvalues(lam_ref, which, nev, scale):
        if len(group) == 1:
            assert h.matvecs[group[0]] == hj.matvecs[group[0]], group
        else:
            assert h.matvecs[group].max() == hj.matvecs[group].max(), group
            assert np.abs(h.restarts[group] - hj.restarts[group]).max() <= 1


def test_double_eigenvalue_found_twice():
    A, _, (Q, T, _) = _both("double_eigenvalue_LR_b2")
    got = np.sort(np.linalg.eigvals(to_numpy(T)).real)[::-1]
    np.testing.assert_allclose(got, [7, 7, 5], atol=1e-8)
    Qn = to_numpy(Q)
    np.testing.assert_allclose(Qn.T @ Qn, np.eye(3), atol=1e-12)


def test_saturation_raises_as_jax_does():
    A = _diag_conj(np.array([7, 7, 5, 4, 3, 2, 1.0]), 5)
    kw = dict(max_dim=6, sort_function="LR", max_restarts=1000, block_size=2)
    with pytest.raises(ValueError, match="saturated"):
        jax_partial_schur(A, 3, key=jax.random.key(1), dtype=np.float64, **kw)
    with pytest.raises(ValueError, match="saturated"):
        partial_schur(A, 3, device="cpu", **kw)


def test_block_geometry():
    A = mark(12)
    # max_dim 21 rounds up to 24; default p = nev + max(5, b) rounded to b
    Q, T, h = partial_schur(A, 4, max_dim=21, block_size=4, sort_function="LR",
                            stopping_criterion=TOL, device="cpu")
    assert Q.shape == (78, 4)
    with pytest.raises(ValueError, match="multiple of block_size"):
        partial_schur(A, 4, max_dim=24, p=10, block_size=4, device="cpu")
    with pytest.raises(ValueError, match="block_size must be positive"):
        partial_schur(A, 4, block_size=0, device="cpu")
    with pytest.raises(ValueError, match="_start_block"):
        partial_schur(A, 4, device="cpu", _start_block=np.ones((1, 78)))
    with pytest.raises(ValueError, match=r"\(4, 78\)"):
        partial_schur(A, 4, block_size=4, device="cpu",
                      _start_block=np.ones((3, 78)))


def test_block_start_block_comes_from_the_generator():
    A = mark(12)
    runs = [partial_schur(A, 4, block_size=2, sort_function="LR", device="cpu",
                          generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert runs[0][2].residual_trace != runs[2][2].residual_trace
