"""The port's ``partial_eigh`` against the JAX package's, on the CPU.

JAX gets a JAX operator (``as_operator(A)``), not the SciPy matrix: with
SciPy input its CPU float64 solve would go to its host tier, while here both
sides run the device loop (``device_loop=True``) or the host-orchestrated
loop over the device workspace (``device_loop=False``).  The port runs on
the same operator arrays (``torch_parity.port_operator``) from the same
start vector; block solves get JAX's start block through ``_start_block``.

Tolerances: eigenvalues within 1e-9 * max|lambda|; eigenvector residuals
within 10 * tol * max|lambda| and orthonormal within 1e-10; matvec and
restart counts EQUAL (the same algorithm on the same data, so the bases
differ by rounding alone; eigh's eigenvector signs may differ, which changes
no count).  The selective kernel matches JAX's within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arnoldi_tpu import partial_eigh as jax_partial_eigh
from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace, laplace_2d, laplace_2d_eigen, random_scattered
from arnoldi_tpu.solvers.lanczos import (
    make_lanczos_selective_ortho as jax_make_selective,
)
from arnoldi_tpu_torch import as_operator, partial_eigh
from arnoldi_tpu_torch.solvers.decomposition import (arnoldi_expand,
                                                     block_arnoldi_expand)
from arnoldi_tpu_torch.solvers.lanczos import make_lanczos_selective_ortho
from torch_parity import port_operator, to_numpy

torch.set_num_threads(1)

TOL = 1e-10


def _symmetric_scattered(n=4096):
    A = random_scattered(n, 24, seed=1, bandwidth=min(2**14, n // 4), block=8,
                         edge="reflect")
    return ((A + A.T) / 2).tocsr()


CASES = {
    # name: (matrix, nev, which, max_dim, block_size)
    "laplace_2d_16x15": (lambda: laplace_2d(16, 15), 4, None, 20, 1),
    "scattered_sym_4096": (_symmetric_scattered, 5, None, 40, 1),
    # square grid: double eigenvalues a single vector cannot resolve
    "laplace_2d_16_b4": (lambda: laplace_2d(16), 6, "SA", 20, 4),
    "laplace_2d_16x15_b2": (lambda: laplace_2d(16, 15), 4, "LA", 20, 2),
}


def _start_block(n, b, v0):
    """JAX's start block for ``key=None``: v0 and normal(key(0)) rows."""
    v0 = np.asarray(v0) / np.linalg.norm(v0)
    extra = np.asarray(jax.random.normal(jax.random.key(0), (b - 1, n),
                                         dtype=np.float64))
    return np.vstack([v0[None, :], extra])


def _both(case, which=None, tol=TOL, **kw):
    gen, nev, case_which, max_dim, b = CASES[case]
    A = gen()
    n = A.shape[0]
    v0 = np.random.default_rng(0).standard_normal(n)
    jop = jax_as_operator(A)
    args = dict(which=which or case_which, max_dim=max_dim,
                stopping_criterion=tol, max_restarts=1000, block_size=b,
                v0=v0)
    args.update(kw)
    ref = jax_partial_eigh(jop, nev, **args)
    if b > 1:
        kw_port = dict(args, _start_block=_start_block(n, b, v0))
    else:
        kw_port = args
    got = partial_eigh(port_operator(jop), nev, **kw_port)
    return A, ref, got


def _assert_parity(A, ref, got, tol=TOL):
    (vj, Vj, hj), (v, V, h) = ref, got
    scale = np.abs(vj).max()
    assert V.shape == np.shape(Vj) and v.shape == np.shape(vj)
    np.testing.assert_allclose(v, vj, rtol=0, atol=1e-9 * scale)
    Vn = to_numpy(V)
    res = np.linalg.norm(A @ Vn - Vn * v[None, :], axis=0)
    assert res.max() <= 10 * tol * scale
    np.testing.assert_allclose(Vn.T @ Vn, np.eye(len(v)), atol=1e-10)
    assert h.total_matvecs == hj.total_matvecs
    assert len(h.residual_trace) == len(hj.residual_trace)
    np.testing.assert_array_equal(h.matvecs, hj.matvecs)
    np.testing.assert_array_equal(h.restarts, hj.restarts)


@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("which", ["LA", "SA", "LM", "SM"])
def test_scalar_matches_jax(which, device_loop):
    _assert_parity(*_both("laplace_2d_16x15", which, device_loop=device_loop))


@pytest.mark.parametrize("device_loop", [True, False])
@pytest.mark.parametrize("case", ["scattered_sym_4096", "laplace_2d_16_b4",
                                  "laplace_2d_16x15_b2"])
def test_other_cases_match_jax(case, device_loop):
    which = "LA" if case.startswith("scattered") else None
    _assert_parity(*_both(case, which, device_loop=device_loop))


@pytest.mark.parametrize("device_loop", [None, True])
@pytest.mark.parametrize("case", ["laplace_2d_16x15", "scattered_sym_4096"])
def test_selective_ortho_matches_jax(case, device_loop):
    # Default: the host-orchestrated loop with the selective kernel rebuilt
    # each restart; forced device loop: JAX runs it with cgs_dgks.
    _assert_parity(*_both(case, "LA", ortho="selective",
                          device_loop=device_loop))


def test_block_recovers_the_double_eigenvalues():
    A, _, (v, V, _) = _both("laplace_2d_16_b4")
    want = np.sort(laplace_2d_eigen(16))[:6]
    np.testing.assert_allclose(np.sort(v), want, atol=1e-9)
    assert len(np.unique(np.round(want, 9))) < 6       # really multiple


def test_breakdown_falls_back_to_the_host_loop():
    # The start vector is an exact eigenvector: the device loop breaks down
    # in its first expansion and the host-orchestrated loop restarts from
    # the same vector with counts from zero (happy breakdown at m = 1).
    A = laplace(64).tocsr()
    w, U = np.linalg.eigh(A.toarray())
    jop = jax_as_operator(A)
    kw = dict(which="LA", stopping_criterion=1e-9, max_restarts=100,
              v0=U[:, -1])
    vj, _, hj = jax_partial_eigh(jop, 1, **kw)
    v, V, h = partial_eigh(port_operator(jop), 1, **kw)
    np.testing.assert_allclose(v[0], w[-1], rtol=1e-10)
    np.testing.assert_allclose(v, vj, rtol=1e-12)
    assert h.total_matvecs == hj.total_matvecs == 1
    assert len(h.residual_trace) == len(hj.residual_trace)
    np.testing.assert_allclose(np.abs(to_numpy(V)[:, 0]), np.abs(U[:, -1]),
                               atol=1e-10)


@pytest.mark.parametrize("device_loop", [True, False])
def test_block_breakdown_falls_back_to_the_host_loop(device_loop):
    # A start block spanning two exact eigenvectors: the first block step is
    # rank deficient.  The device loop only flags it and falls back; the
    # host-orchestrated loop stops at dimension 0 and raises.  (JAX draws
    # its block's second row at random, so it cannot be given this block.)
    A = laplace(64).tocsr()
    U = np.linalg.eigh(A.toarray())[1][:, -2:]
    with pytest.raises(ValueError, match="dimension 0 < nev=2"):
        partial_eigh(as_operator(A, device="cpu"), 2, which="LA", max_dim=8,
                     block_size=2, stopping_criterion=1e-9,
                     _start_block=U.T.copy(), device_loop=device_loop)


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("invariant", [False, True])
def test_expansion_without_host_reads(b, invariant):
    # stop_at_breakdown=False (the device loop's expansions): the same
    # factorization as the stopping expansion when healthy, and a device
    # flag in place of the count; the flag is set when a step broke down.
    n, steps = 40, 3
    A = as_operator(np.diag(np.arange(1.0, n + 1)), device="cpu")
    Vt0 = torch.zeros((steps * b + b, n), dtype=torch.float64)
    if invariant:     # spans 2b eigenvectors: the second step breaks down
        for i in range(b):
            Vt0[i, [2 * i, 2 * i + 1]] = 0.5 ** 0.5
    else:
        Vt0[:b] = torch.linalg.qr(torch.from_numpy(
            np.random.default_rng(1).standard_normal((n, b))))[0].T
    H0 = torch.zeros((steps * b + b, steps * b), dtype=torch.float64)

    def run(stop):
        V, H = Vt0.clone(), H0.clone()
        if b == 1:
            return arnoldi_expand(A, V, H, 1e-10, max_dim=steps,
                                  ortho="cgs2", stop_at_breakdown=stop)
        return block_arnoldi_expand(A, V, H, 1e-10, start_block=0,
                                    n_blocks=steps, b=b, stop_at_breakdown=stop)

    V, H, done = run(True)
    V2, H2, broke = run(False)
    assert torch.is_tensor(broke) and broke.dtype == torch.bool
    assert bool(broke) == invariant == (done < steps)
    if not invariant:
        np.testing.assert_array_equal(V2.numpy(), V.numpy())
        np.testing.assert_array_equal(H2.numpy(), H.numpy())


@pytest.mark.parametrize("device_loop", [True, False])
def test_non_convergence_raises(device_loop):
    op = as_operator(laplace_2d(24), device="cpu")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_eigh(op, 3, which="SA", stopping_criterion=1e-14, max_dim=8,
                     max_restarts=3, device_loop=device_loop)


@pytest.mark.parametrize("device_loop", [True, False])
def test_float32_matches_jax(device_loop):
    # float32 at tol 1e-5 (no refinement on either side): the bases differ
    # by float32 rounding, so values agree within 10 * tol * max|lambda|,
    # the residual gate of the float64 cases.
    A = laplace_2d(16, 15)
    v0 = np.random.default_rng(0).standard_normal(A.shape[0])
    kw = dict(which="LA", max_dim=20, stopping_criterion=1e-5,
              dtype=np.float32, v0=v0, device_loop=device_loop,
              max_restarts=1000)
    vj, _, _ = jax_partial_eigh(jax_as_operator(A.astype(np.float32)), 4, **kw)
    v, V, _ = partial_eigh(as_operator(A.astype(np.float32), device="cpu"), 4,
                           **kw)
    # the device loop's values are float32; the host loop's eigh is float64
    assert V.dtype == torch.float32 and v.dtype == vj.dtype
    want = np.sort(laplace_2d_eigen(16, 15))[::-1][:4]
    gate = 10 * 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(v, vj, rtol=0, atol=gate)
    np.testing.assert_allclose(v, want, rtol=0, atol=gate)
    Vn = to_numpy(V).astype(np.float64)
    assert np.linalg.norm(A @ Vn - Vn * v[None, :], axis=0).max() < gate


def _workspace(n=300, m=14, seed=5):
    rng = np.random.default_rng(seed)
    Vt = np.zeros((m + 1, n))
    Vt[:m] = np.linalg.qr(rng.standard_normal((n, m)))[0].T
    return Vt, rng


@pytest.mark.parametrize("n_locked,n_active", [
    (0, 1), (0, 6), (4, 11), (9, 11), (10, 11), (13, 11), (11, 11)])
@pytest.mark.parametrize("in_span", [False, True])
def test_selective_kernel_matches_jax(n_locked, n_active, in_span):
    # in_span: w mostly inside the active rows, so the DGKS full pass runs.
    Vt, rng = _workspace()
    w = rng.standard_normal(Vt.shape[1])
    if in_span:
        w = 0.05 * w + rng.standard_normal(n_active) @ Vt[:n_active]
    got = make_lanczos_selective_ortho(n_locked)(
        torch.from_numpy(Vt), torch.from_numpy(w), n_active, tol=1e-10)
    want = jax_make_selective(n_locked)(jnp.asarray(Vt), jnp.asarray(w),
                                        n_active, tol=1e-10)
    for g, r in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-12)
    assert bool(got[3]) == bool(want[3])
    np.testing.assert_array_equal(got[0].numpy()[n_active:], 0)


def test_geometry_and_refusals():
    op = as_operator(laplace_2d(10), device="cpu")
    with pytest.raises(ValueError, match="expected LA, SA, LM or SM"):
        partial_eigh(op, 3, which="LR")
    with pytest.raises(ValueError, match="max_dim"):
        partial_eigh(op, 3, max_dim=3)      # p = 2 < nev
    with pytest.raises(TypeError, match="parallel.Mesh"):
        partial_eigh(op, 3, mesh=object())
    with pytest.raises(ValueError, match="refine"):
        partial_eigh(op, 3, refine="bogus")
    # float32 below tol 1e-6 is refined: float64 values and vectors
    v, V, h = partial_eigh(op, 3, dtype=np.float32, stopping_criterion=1e-8)
    assert V.dtype == torch.float64 and v.dtype == np.float64
    # block geometry: max_dim 21 rounds up to 24 at b = 4
    v, V, h = partial_eigh(op, 3, max_dim=21, block_size=4,
                           stopping_criterion=1e-9)
    assert V.shape == (100, 3)
