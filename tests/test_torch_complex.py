"""Complex work dtypes in the port, held against the JAX package.

The JAX package's Pallas kernels are real-only; on complex input it runs
XLA (``conj(Vt) @ w``, the take + einsum ELL, the shift-and-add DIA), and
those functions are what the port's plain versions are held against here.
Its complex solves on the CPU run the device path (a JAX operator, or an
``ortho=`` outside the host tier's) or its complex128 host tier (SciPy
input).  The port runs on the same operator arrays (``convert``), the same
``v0`` and the same ``ortho=``.

Tolerances: normwise relative 1e-13 (complex128) and 1e-5 (complex64) for
the kernels (the same products summed in another order); eigenvalues
within 1e-9 of JAX's (``harness/suite.py::eigenvalues_match``); block CGS2
within 1e-12; matvec counts equal where both sides run the same restart
policy in complex128.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from arnoldi_tpu import partial_eigh as jax_partial_eigh
from arnoldi_tpu import partial_schur as jax_partial_schur
from arnoldi_tpu import svds as jax_svds
from arnoldi_tpu.harness.suite import eigenvalues_match
from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace_2d, mark, random_scattered
from arnoldi_tpu.ops import ortho as jax_ortho
from arnoldi_tpu_torch import as_operator, partial_eigh, partial_schur, svds
from arnoldi_tpu_torch.convert import workspace_from_reference
from arnoldi_tpu_torch.ops import ortho
from arnoldi_tpu_torch.ops.kernels.ortho_fused import (masked_project,
                                                       project_update_norm)
from arnoldi_tpu_torch.ops.kernels.spmv_banded import banded_matvec_plain
from arnoldi_tpu_torch.ops.kernels.spmv_ell import ell_matvec_plain
from torch_parity import port_operator, to_numpy

torch.set_num_threads(1)

RTOL = {np.complex128: 1e-13, np.complex64: 1e-5}
TOL = 1e-10


def gauge_rotated(A, seed=5, phase=np.pi / 6):
    """``e^{i phase} G A G^H`` with ``G = diag(e^{i theta})``, theta uniform
    on [0, 2 pi) from ``seed``: complex, with A's stencil and, for a normal
    A, the eigenvalues of A times ``e^{i phase}``."""
    rng = np.random.default_rng(seed)
    g = np.exp(1j * rng.uniform(0, 2 * np.pi, A.shape[0]))
    G = sp.diags(g)
    return (np.exp(1j * phase) * (G @ A @ G.conj().T)).tocsr()


def phased(A, seed=7):
    """A with every off-diagonal value times ``e^{i phi}``, phi uniform on
    [0, 2 pi) from ``seed``; the diagonal kept."""
    rng = np.random.default_rng(seed)
    C = sp.coo_matrix(A).astype(np.complex128)
    off = C.row != C.col
    C.data[off] *= np.exp(1j * rng.uniform(0, 2 * np.pi, int(off.sum())))
    return C.tocsr()


def scattered(n=2048, edge="clip"):
    return random_scattered(n, 24, seed=1, bandwidth=256, block=8, edge=edge)


def _rel(got, want):
    got, want = to_numpy(got), np.asarray(want)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _v0(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


# -- the kernels' plain versions -----------------------------------------

@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("kind", ["dia", "ell"])
def test_spmv_plain_matches_jax_xla(kind, b, dtype):
    A = (gauge_rotated(laplace_2d(12, 11)) if kind == "dia"
         else phased(scattered(600)))
    jop = jax_as_operator(A, dtype=dtype)
    assert type(jop).__name__ == {"dia": "BandedOperator",
                                  "ell": "EllOperator"}[kind]
    op = port_operator(jop)
    assert op.dtype == {np.complex128: torch.complex128,
                        np.complex64: torch.complex64}[dtype]
    rng = np.random.default_rng(3)
    X = (rng.standard_normal((A.shape[1], b))
         + 1j * rng.standard_normal((A.shape[1], b))).astype(dtype)
    want = np.asarray(jop.matvec(jnp.asarray(X[:, 0])) if b == 1
                      else jop.matmat(jnp.asarray(X)))
    Xt = torch.from_numpy(np.ascontiguousarray(X.T if b > 1 else X[:, 0]))
    if kind == "dia":
        got = banded_matvec_plain(op.bands, Xt, op.offsets)
    else:
        got = ell_matvec_plain(op.data, op.cols, Xt)
    if b > 1:
        got = got.T
    assert _rel(got, want) <= RTOL[dtype]
    # the operator's own products take the same plain version
    got_op = op.matvec(Xt) if b == 1 else op.matmat(torch.from_numpy(X))
    assert _rel(got_op, want) <= RTOL[dtype]


def _basis(dtype, n=900, mp1=21, j=12, in_span=0.0, seed=7):
    """Orthonormal complex leading j rows, stale noise after them, and a w
    with a chosen share inside the span."""
    rng = np.random.default_rng(seed)
    Z = rng.standard_normal((n, j)) + 1j * rng.standard_normal((n, j))
    Vt = np.zeros((mp1, n), dtype=np.complex128)
    Vt[:j] = np.linalg.qr(Z)[0].T
    Vt[j:] = rng.standard_normal((mp1 - j, n))
    w = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    if in_span:
        coef = rng.standard_normal(j) + 1j * rng.standard_normal(j)
        w = in_span * (coef @ Vt[:j]) + (1 - in_span) * w
    return Vt.astype(dtype), w.astype(dtype), j


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize("name", ["cgs2", "cgs_dgks"])
def test_cgs_passes_match_jax_xla(name, dtype):
    Vt, w, j = _basis(dtype, in_span=0.9)
    h_ref, w_ref, beta_ref, _ = getattr(jax_ortho, name)(
        jnp.asarray(Vt), jnp.asarray(w), j)
    h, w_got, beta, _ = getattr(ortho, name)(torch.from_numpy(Vt),
                                             torch.from_numpy(w), j)
    assert h.dtype == torch.from_numpy(Vt).dtype
    assert not beta.is_complex()
    for got, want in ((h, h_ref), (w_got, w_ref)):
        assert _rel(got, want) <= RTOL[dtype]
    assert abs(float(beta) - float(beta_ref)) <= RTOL[dtype] * float(beta_ref)
    assert np.all(to_numpy(h)[j:] == 0)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_fused_passes_conjugate_the_basis(dtype):
    """``masked_project`` is conj(Vt) . w, ``project_update_norm`` takes c
    as it is and returns the real ||w'||^2."""
    Vt, w, j = _basis(dtype)
    c = masked_project(torch.from_numpy(Vt), torch.from_numpy(w), j)
    c_ref = Vt[:j].conj() @ w
    assert _rel(c[:j], c_ref) <= RTOL[dtype]
    w2, norm_sq = project_update_norm(torch.from_numpy(Vt),
                                      torch.from_numpy(w), c, j)
    w_ref = w - to_numpy(c)[:j] @ Vt[:j]
    assert _rel(w2, w_ref) <= RTOL[dtype]
    assert norm_sq.dtype == torch.from_numpy(Vt.real.copy()).dtype
    want = np.vdot(w_ref, w_ref).real
    assert abs(float(norm_sq) - want) <= RTOL[dtype] * want
    # w' is orthogonal to the (orthonormal) active rows
    assert np.abs(Vt[:j].conj() @ to_numpy(w2)).max() <= 1e3 * RTOL[dtype]


@pytest.mark.parametrize("n_active", [0, 5, 12])
def test_block_cgs2_matches_jax(n_active):
    Vt, _, _ = _basis(np.complex128)
    rng = np.random.default_rng(11)
    W = rng.standard_normal((4, Vt.shape[1])) + 1j * rng.standard_normal(
        (4, Vt.shape[1]))
    C_ref, Q_ref, R_ref, bd_ref = jax_ortho.block_cgs2(
        jnp.asarray(Vt), jnp.asarray(W), n_active, tol=1e-8)
    C, Q, R, bd = ortho.block_cgs2(torch.from_numpy(Vt), torch.from_numpy(W),
                                   n_active, tol=1e-8)
    for got, want in ((C, C_ref), (Q, Q_ref), (R, R_ref)):
        np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=0,
                                   atol=1e-12 * max(1.0, np.abs(want).max()))
    assert bool(bd) == bool(bd_ref)
    Qn = to_numpy(Q)
    np.testing.assert_allclose(Qn.conj() @ Qn.T, np.eye(4), atol=1e-12)


# -- the drivers -----------------------------------------------------------

def _assert_schur_parity(A, ref, got, which):
    (Qj, Tj, hj), (Q, T, h) = ref, got
    T = to_numpy(T)
    assert T.dtype == np.complex128
    np.testing.assert_array_equal(np.tril(T, -1), 0)      # triangular
    lam, lam_ref = np.diag(T), np.diag(np.asarray(Tj))
    scale = np.abs(lam_ref).max()
    assert eigenvalues_match(lam, lam_ref, which=which, rtol=0,
                             atol=1e-9 * scale)
    Qn = to_numpy(Q)
    res = np.linalg.norm(A @ Qn - Qn @ T, axis=0).max()
    assert res <= 10 * TOL * scale
    np.testing.assert_allclose(Qn.conj().T @ Qn, np.eye(Qn.shape[1]),
                               atol=1e-12)
    assert h.total_matvecs == hj.total_matvecs
    np.testing.assert_array_equal(h.matvecs, hj.matvecs)


SCHUR_CASES = {
    "gauge_laplace_2d_12x11_LM": (lambda: gauge_rotated(laplace_2d(12, 11)),
                                  4, "LM"),
    "phased_scattered_2048_LR": (lambda: phased(scattered()), 5, "LR"),
}


@pytest.mark.parametrize("case", sorted(SCHUR_CASES))
def test_partial_schur_device_path_matches_jax(case):
    gen, nev, which = SCHUR_CASES[case]
    A = gen()
    jop = jax_as_operator(A)
    args = dict(max_dim=20, stopping_criterion=TOL, sort_function=which,
                max_restarts=500, ortho="cgs", v0=_v0(A.shape[0]))
    ref = jax_partial_schur(jop, nev, **args)
    got = partial_schur(port_operator(jop), nev, **args)
    assert got[0].dtype == torch.complex128
    _assert_schur_parity(A, ref, got, which)


def test_gauge_rotation_keeps_the_spectrum():
    """The gauge-rotated stencil's eigenvalues are the stencil's times
    e^{i pi/6}, through the complex DIA path and the fused passes."""
    A = laplace_2d(12, 11)
    Aq = gauge_rotated(A)
    op = as_operator(Aq, device="cpu")
    assert type(op).__name__ == "BandedOperator" and op.dtype == torch.complex128
    _, T, _ = partial_schur(op, 4, max_dim=20, stopping_criterion=TOL,
                            ortho="cgs2", max_restarts=500)
    exact = np.exp(1j * np.pi / 6) * np.linalg.eigvalsh(A.toarray())
    lam = np.diag(to_numpy(T))
    err = np.abs(lam[:, None] - exact[None, :]).min(axis=1)
    assert err.max() <= 1e-9 * np.abs(exact).max()


def test_complex128_host_tier_matches_jax(monkeypatch):
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    A = gauge_rotated(laplace_2d(12, 11))
    args = dict(max_dim=20, stopping_criterion=TOL, sort_function="LM",
                max_restarts=500, v0=_v0(A.shape[0]))
    ref = jax_partial_schur(A, 4, **args)
    got = partial_schur(A, 4, device="cpu", **args)
    assert "host.expand" in got[2].phases       # NumPy: the engine is float64
    _assert_schur_parity(A, ref, got, "LM")


@pytest.mark.parametrize("device_loop", [None, False])
def test_hermitian_partial_eigh_matches_jax(device_loop):
    Af = phased(scattered(edge="reflect"))
    H = ((Af + Af.conj().T) / 2).tocsr()
    jop = jax_as_operator(H)
    args = dict(which="LA", max_dim=20, stopping_criterion=TOL,
                v0=_v0(H.shape[0]), device_loop=device_loop)
    vals_ref, _, h_ref = jax_partial_eigh(jop, 4, **args)
    vals, V, h = partial_eigh(port_operator(jop), 4, **args)
    assert vals.dtype == np.float64 and V.dtype == torch.complex128
    np.testing.assert_allclose(vals, np.asarray(vals_ref), rtol=0,
                               atol=1e-9 * np.abs(vals_ref).max())
    Vn = to_numpy(V)
    res = np.linalg.norm(H @ Vn - Vn * vals[None, :], axis=0).max()
    assert res <= 10 * TOL * np.abs(vals).max()
    np.testing.assert_allclose(Vn.conj().T @ Vn, np.eye(4), atol=1e-10)
    assert h.total_matvecs == h_ref.total_matvecs


def test_hermitian_host_tier_matches_jax(monkeypatch):
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    H = gauge_rotated(laplace_2d(12, 11), phase=0.0)    # Hermitian
    args = dict(which="SA", max_dim=20, stopping_criterion=TOL,
                v0=_v0(H.shape[0]))
    vals_ref, _, h_ref = jax_partial_eigh(H, 4, **args)
    vals, V, h = partial_eigh(H, 4, device="cpu", **args)
    assert "host.expand" in h.phases and V.dtype == torch.complex128
    np.testing.assert_allclose(vals, np.asarray(vals_ref), rtol=0, atol=1e-9)
    assert h.total_matvecs == h_ref.total_matvecs


def test_svds_of_a_complex_matrix_matches_jax():
    A = phased(scattered(edge="reflect"))[:, :1500]
    U_ref, s_ref, Vh_ref = jax_svds(A, 4, which="LM", tol=TOL, ncv=20)
    U, s, Vh = svds(A, 4, which="LM", tol=TOL, ncv=20, device="cpu")
    assert U.dtype == Vh.dtype == torch.complex128
    np.testing.assert_allclose(s, s_ref, rtol=1e-9, atol=0)
    Un, Vn = to_numpy(U), to_numpy(Vh).conj().T
    np.testing.assert_allclose(np.linalg.norm(A @ Vn - Un * s, axis=0), 0,
                               atol=1e-8 * s.max())
    np.testing.assert_allclose(
        np.linalg.norm(A.conj().T @ Un - Vn * s, axis=0), 0,
        atol=1e-8 * s.max())


def test_complex_v0_makes_a_real_operator_complex():
    """A complex start vector makes the work dtype complex, as in JAX
    (``test_torch_krylov_schur.py::test_complex_solves_match_jax`` holds
    that solve against JAX's); a drawn one keeps a real operator real."""
    A = mark(10)
    op = as_operator(A, device="cpu")
    v0 = _v0(A.shape[0]) + 1j * _v0(A.shape[0], seed=1)
    args = dict(max_dim=20, stopping_criterion=TOL, sort_function="LR",
                max_restarts=500)
    Q, T, _ = partial_schur(op, 4, v0=v0, **args)
    assert Q.dtype == T.dtype == torch.complex128
    T = to_numpy(T)
    np.testing.assert_array_equal(np.tril(T, -1), 0)
    Qn = to_numpy(Q)
    assert np.linalg.norm(A @ Qn - Qn @ T, axis=0).max() <= 10 * TOL
    Q, _, _ = partial_schur(op, 4, **args)
    assert Q.dtype == torch.float64
    vals, V, _ = partial_eigh(as_operator(laplace_2d(6), device="cpu"), 3,
                              v0=v0[:36], stopping_criterion=TOL)
    assert V.dtype == torch.complex128 and vals.dtype == np.float64


def test_convert_carries_complex_leaves():
    Aq = gauge_rotated(laplace_2d(6))
    for A in (Aq, phased(scattered(296)), Aq.toarray()):
        jop = jax_as_operator(A)
        op = port_operator(jop)
        assert op.dtype == torch.complex128
        x = _v0(A.shape[0]) + 1j * _v0(A.shape[0], seed=2)
        np.testing.assert_allclose(to_numpy(op.matvec(torch.from_numpy(x))),
                                   A @ x, rtol=1e-13, atol=1e-13)
    Vt, H, v0 = workspace_from_reference(
        np.eye(3, 5, dtype=np.complex128), np.zeros((3, 2), np.complex64),
        np.ones(5, np.complex128) * 1j, device="cpu")
    assert (Vt.dtype, H.dtype, v0.dtype) == (torch.complex128, torch.complex64,
                                             torch.complex128)


def test_dw_refinement_of_a_complex_solve_is_refused():
    op = as_operator(mark(10), device="cpu")
    for solve in (partial_schur, partial_eigh):
        with pytest.raises(ValueError, match="refine='dw'"):
            solve(op, 3, refine="dw", dtype=np.complex64)
