"""Refined solves of the port (a float32 phase, then a float64
continuation) against the JAX package's (a float32 phase, then double-word
float32 arithmetic), on the CPU, at ``tests/test_refine.py``'s 1e-8 targets.

Both sides start from the same ``v0``, drawn with ``jax.random``.  The
continuations differ in arithmetic and loop, so their matvec counts may
differ; they must agree on what they converge to.  Tolerances: the port's
Q and T float64, its Schur residual below 1e-8, its eigenvalues within 1e-9
of JAX's refined ones (Hungarian-matched); ``partial_eigh`` within 1e-8 of
the analytic values with residuals below 1e-7; the float32 phase's matvec
count EQUAL to JAX's float32 device-path solve to 2e-4 (the same operator
arrays, the same start vector and the same Pallas-twin ortho).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse.linalg import eigs

from arnoldi_tpu import partial_eigh as jax_partial_eigh
from arnoldi_tpu import partial_schur as jax_partial_schur
from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace_2d, laplace_2d_eigen, mark
from arnoldi_tpu.solvers.refine import (
    refinement_start_vector as jax_refinement_start_vector,
)
from arnoldi_tpu_torch import (CallableOperator, as_operator, partial_eigh,
                               partial_schur)
from arnoldi_tpu_torch.solvers import refine
from common import find_best_matching
from torch_parity import (ContinuationCounter, port_operator,
                          schur_residuals, to_numpy)

torch.set_num_threads(1)


def _v0(n, seed):
    return np.array(jax.random.normal(jax.random.key(seed), (n,),
                                      dtype=np.float64))


# name: (matrix, nev, max_dim, start seed, operator format); the BSR case is
# built from the float32 cast, so its refinement target is the float32
# matrix (tests/test_refine.py::test_partial_schur_bsr_refine).
CASES = {
    "mark30": (lambda: mark(30), 4, 20, 0, None),
    "mark10_saad": (lambda: mark(10), 3, 10, 1, None),
    "mark25_bsr_f32": (lambda: mark(25).astype(np.float32), 3, 18, 2,
                       ("bsr", (8, 8))),
}


def _refined_schur(case):
    gen, nev, max_dim, seed, fmt = CASES[case]
    A = gen()
    kw = dict(max_dim=max_dim, stopping_criterion=1e-8, sort_function="LR",
              max_restarts=2000, dtype=np.float32, ortho="cgs2",
              v0=_v0(A.shape[0], seed))
    jop = A if fmt is None else jax_as_operator(A, format=fmt)
    ref = jax_partial_schur(jop, nev, **kw)
    got = partial_schur(as_operator(A, format=fmt, device="cpu"), nev, **kw)
    return A.astype(np.float64), ref, got


@pytest.mark.parametrize("case", sorted(CASES))
def test_partial_schur_refined_matches_jax(case):
    A, (Qj, Tj, hj), (Q, T, h) = _refined_schur(case)
    assert Q.dtype == T.dtype == torch.float64
    assert schur_residuals(A, Q, T).max() < 1e-8
    lam, lam_ref = (np.linalg.eigvals(to_numpy(t)) for t in (T, Tj))
    a, b = find_best_matching(lam, lam_ref)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    assert h.residual_trace[-1] == 1e-8 == hj.residual_trace[-1]
    assert (h.matvecs == h.total_matvecs).all()
    if case == "mark10_saad":        # Saad's anchor, against ARPACK
        ref = np.sort(np.real(eigs(A, 3, which="LR")[0]))
        np.testing.assert_allclose(np.sort(lam.real), ref, atol=1e-7)


def test_float32_phase_matches_jax_device_path(monkeypatch):
    # JAX's float32 device path to 2e-4 (Pallas twins in interpret mode, as
    # tests/test_torch_krylov_schur.py forces it) is the port's first phase.
    A = mark(30).astype(np.float32)
    v0 = _v0(A.shape[0], 0)
    jop = jax_as_operator(A, backend="pallas")
    kw = dict(max_dim=20, sort_function="LR", max_restarts=2000,
              dtype=np.float32, ortho="cgs2_pallas", v0=v0)
    _, _, hj = jax_partial_schur(jop, 4, stopping_criterion=2e-4, refine=None,
                                 **kw)
    counter = ContinuationCounter(refine.refine_schur)
    monkeypatch.setattr(refine, "refine_schur", counter)
    _, _, h = partial_schur(port_operator(jop), 4, stopping_criterion=1e-8,
                            **kw)
    (continuation,) = counter.matvecs
    assert h.total_matvecs - continuation == hj.total_matvecs
    assert h.residual_trace[:-1] == pytest.approx(hj.residual_trace, rel=1e-3)


def test_partial_eigh_refined_gate():
    # The bench gate's shape at the 1e-8 tolerance (tests/test_refine.py).
    nx, ny = 40, 39
    A = laplace_2d(nx, ny)
    kw = dict(which="LA", stopping_criterion=1e-8, max_restarts=3000,
              dtype=np.float32, v0=_v0(A.shape[0], 0))
    vj, _, _ = jax_partial_eigh(A.astype(np.float32), 4, **kw)
    vals, V, hist = partial_eigh(A.astype(np.float32), 4, device="cpu", **kw)
    want = np.sort(laplace_2d_eigen(nx, ny))[-4:][::-1]
    assert V.dtype == torch.float64 and vals.dtype == np.float64
    np.testing.assert_allclose(vals, want, rtol=0, atol=1e-8)
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-9)
    Vn = to_numpy(V)
    assert np.linalg.norm(A @ Vn - Vn * vals[None, :], axis=0).max() < 1e-7
    np.testing.assert_allclose(Vn.T @ Vn, np.eye(4), atol=1e-10)


@pytest.mark.parametrize("device_loop", [True, False])
def test_partial_eigh_refines_on_both_loops(device_loop, monkeypatch):
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    A = laplace_2d(16, 15)
    vals, V, h = partial_eigh(as_operator(A, device="cpu"), 3, which="SA",
                              stopping_criterion=1e-9, dtype=np.float32,
                              device_loop=device_loop, max_restarts=1000)
    want = np.sort(laplace_2d_eigen(16, 15))[:3]
    np.testing.assert_allclose(vals, want, rtol=0, atol=1e-9)
    assert {"refine.start_vector", "refine.continue"} <= set(h.phases)
    assert ("trl.device_loop" in h.phases) == device_loop


def test_refine_none_keeps_float32():
    Q, T, h = partial_schur(as_operator(mark(20), device="cpu"), 3,
                            stopping_criterion=2e-4, sort_function="LR",
                            max_restarts=2000, dtype=np.float32, ortho="cgs2",
                            refine=None)
    assert Q.dtype == T.dtype == torch.float32
    assert h.residual_trace[-1] != 2e-4


@pytest.mark.parametrize("refine_value", ["bogus", "DW", 1.5])
def test_unknown_refine_value_raises(refine_value):
    with pytest.raises(ValueError, match="refine"):
        partial_schur(mark(10), 2, stopping_criterion=1e-8, device="cpu",
                      refine=refine_value, dtype=np.float32)
    with pytest.raises(ValueError, match="refine"):
        partial_eigh(laplace_2d(6), 2, device="cpu", refine=refine_value)


def test_dw_refines_float64_host_input_off_the_host_tier(monkeypatch):
    # "dw" refines any solve, and a refined solve never takes the host tier.
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    A = mark(20)
    Q, T, h = partial_schur(A, 3, sort_function="LR", stopping_criterion=1e-10,
                            device="cpu", refine="dw", max_restarts=2000)
    assert "refine.continue" in h.phases
    assert not any(k.startswith(("engine.", "host.")) for k in h.phases)
    assert schur_residuals(A, Q, T).max() < 1e-10


def test_refinement_start_vector_matches_jax():
    Vt = np.random.default_rng(3).standard_normal((8, 40)).astype(np.float32)
    want = np.asarray(jax_refinement_start_vector(jnp.asarray(Vt), 5))
    got = refine.refinement_start_vector(torch.from_numpy(Vt), 5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    np.testing.assert_allclose(torch.linalg.vector_norm(got).item(), 1.0,
                               atol=1e-6)
    # a mix that cancels falls back to row 0, as JAX's does
    Vt[1] = -2 * Vt[0]
    got = refine.refinement_start_vector(torch.from_numpy(Vt), 2)
    want = np.asarray(jax_refinement_start_vector(jnp.asarray(Vt), 2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("with_f64", [True, False])
def test_callable_operator_refines_only_with_fn_f64(with_f64):
    A = mark(20)
    A32 = torch.from_numpy(A.toarray().astype(np.float32))
    A64 = torch.from_numpy(A.toarray())
    op = CallableOperator(lambda x: A32 @ x, A.shape, torch.float32,
                          fn_f64=(lambda x: A64 @ x) if with_f64 else None,
                          device="cpu")
    Q, T, h = partial_schur(op, 3, sort_function="LR", stopping_criterion=1e-8,
                            max_restarts=2000, ortho="cgs2")
    if with_f64:
        assert Q.dtype == torch.float64
        assert schur_residuals(A, Q, T).max() < 1e-8
    else:
        assert Q.dtype == torch.float32 and len(h.residual_trace) > 0
        with pytest.raises(TypeError, match="fn_f64"):
            partial_schur(op, 3, sort_function="LR", refine="dw",
                          stopping_criterion=1e-8, max_restarts=2000)
