"""Checkpoint/resume of the port's ``partial_schur``, held against the JAX
package's.

The first six tests are the single-process cases of
``tests/test_checkpoint.py`` run on the port.  Then: a run cut at half its
restarts and resumed repeats the unbroken run exactly (bit-equal T, equal
matvecs and restarts) on the host tier (the C++ engine's fused cycle and
the NumPy loop), the float32 device path, the block driver and a refined
solve's float32 phase, with the counts of JAX's own unbroken run from the
same start vector (JAX's ``key(5)`` draw, passed as ``v0``); snapshots
written by either package resume in the other with the other's resumed
counts; a sharded snapshot (no ``V``) without a mesh and one of another
workspace geometry are refused (``test_torch_checkpoint_sharded.py`` holds
the sharded snapshots).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from arnoldi_tpu import partial_schur as jax_partial_schur
from arnoldi_tpu.matrices import mark
from arnoldi_tpu.utils import checkpoint as jax_checkpoint
from arnoldi_tpu.utils.random import rand_normalized_vector
from arnoldi_tpu_torch import as_operator, partial_schur
from arnoldi_tpu_torch.utils.checkpoint import (RestartCheckpoint,
                                                load_checkpoint,
                                                save_checkpoint)
from torch_parity import to_numpy

torch.set_num_threads(1)

norm = np.linalg.norm
KEY = 5


def _jax_v0(n, dtype=np.float64):
    """The start vector JAX's ``partial_schur`` draws from ``key(5)``."""
    return np.array(rand_normalized_vector(jax.random.key(KEY), n, dtype))


def _jax_start_block(n, b, dtype=np.float64):
    """JAX's block start for ``key(5)``: its v0 and the b - 1 rows it draws
    from the key's second split (``krylov_schur.py:421-422``)."""
    extra = jax.random.normal(jax.random.split(jax.random.key(KEY))[1],
                              (b - 1, n), dtype=dtype)
    return np.vstack([_jax_v0(n, dtype)[None, :], np.asarray(extra)])


def _assert_schur(A, Q, T, atol=1e-8):
    Qh, Th = to_numpy(Q), to_numpy(T)
    res = norm(A.toarray() @ Qh - Qh @ Th, axis=0)
    np.testing.assert_allclose(res, 0, atol=atol)


def _same_spectrum(T1, T2):
    v1 = np.sort_complex(np.linalg.eigvals(to_numpy(T1)))
    v2 = np.sort_complex(np.linalg.eigvals(to_numpy(T2)))
    np.testing.assert_allclose(v1, v2, rtol=1e-7, atol=1e-9)


# -- tests/test_checkpoint.py's single-process cases -----------------------

HOST = dict(max_dim=12, stopping_criterion=1e-10, sort_function="LR",
            device="cpu")


def test_resume_after_budget_exhaustion(tmp_path):
    A = mark(15)
    kwargs = dict(HOST, v0=_jax_v0(A.shape[0]))
    ckpt = str(tmp_path / "ks.npz")
    Q_ref, T_ref, h_ref = partial_schur(A, 3, max_restarts=5000, **kwargs)
    total_restarts = int(h_ref.restarts.max())
    assert total_restarts > 3, "need a multi-restart problem for this test"

    budget = max(2, total_restarts // 2)
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=budget, checkpoint_path=ckpt,
                      **kwargs)
    ck = load_checkpoint(ckpt)
    assert ck.restart == budget
    assert ck.total_matvecs > 0

    Q, T, h = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, **kwargs)
    _assert_schur(A, Q, T)
    _same_spectrum(T_ref, T)
    assert int(h.restarts.max()) >= budget


def test_checkpoint_every(tmp_path):
    A = mark(15)
    ckpt = str(tmp_path / "every3.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_dim=12, stopping_criterion=1e-12,
                      max_restarts=7, sort_function="LR", device="cpu",
                      checkpoint_path=ckpt, checkpoint_every=3,
                      v0=_jax_v0(A.shape[0]))
    assert load_checkpoint(ckpt).restart == 6   # the last multiple of 3


def test_block_driver_checkpoint_resume(tmp_path):
    A = mark(15)
    op = as_operator(A, device="cpu")
    kwargs = dict(max_dim=16, stopping_criterion=1e-10, sort_function="LR",
                  block_size=2, _start_block=_jax_start_block(A.shape[0], 2))
    ckpt = str(tmp_path / "blk.npz")
    Q_ref, T_ref, h_ref = partial_schur(op, 3, max_restarts=5000, **kwargs)
    total_restarts = int(h_ref.restarts.max())
    assert total_restarts > 2, "need a multi-restart problem for this test"

    budget = max(1, total_restarts // 2)
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(op, 3, max_restarts=budget, checkpoint_path=ckpt,
                      **kwargs)
    assert load_checkpoint(ckpt).restart == budget

    Q, T, h = partial_schur(op, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, **kwargs)
    _assert_schur(A, Q, T)
    _same_spectrum(T_ref, T)


def test_resume_accepts_full_workspace_checkpoint(tmp_path):
    # A snapshot holding all max_dim + b rows (an older writer's) is sliced
    # to its head rows.
    A = mark(15)
    n, max_dim = A.shape[0], 12
    kwargs = dict(HOST, v0=_jax_v0(n))
    ckpt = str(tmp_path / "oldfmt.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=2, checkpoint_path=ckpt, **kwargs)
    ck = load_checkpoint(ckpt)
    V_full = np.zeros((max_dim + 1, n), dtype=ck.V.dtype)
    V_full[:ck.V.shape[0]] = ck.V
    save_checkpoint(ckpt, dataclasses.replace(ck, V=V_full))

    Q, T, _ = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, **kwargs)
    _assert_schur(A, Q, T)


def test_resume_hard_lock_checkpoint_under_soft_unfreezes(tmp_path):
    A = mark(15)
    kwargs = dict(HOST, v0=_jax_v0(A.shape[0]))
    ckpt = str(tmp_path / "hard.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=4, checkpoint_path=ckpt,
                      lock="hard", **kwargs)
    Q, T, _ = partial_schur(A, 3, max_restarts=5000, checkpoint_path=ckpt,
                            resume=True, lock="soft", **kwargs)
    _assert_schur(A, Q, T)
    _, T2, _ = partial_schur(A, 3, max_restarts=5000, **kwargs)
    _same_spectrum(T2, T)


def test_resume_without_file_starts_fresh(tmp_path):
    A = mark(10)
    kwargs = dict(stopping_criterion=1e-8, max_restarts=2000,
                  sort_function="LR", device="cpu", v0=_jax_v0(A.shape[0]))
    Q, T, h = partial_schur(A, 2, checkpoint_path=str(tmp_path / "none.npz"),
                            resume=True, **kwargs)
    _assert_schur(A, Q, T)
    _, T_ref, h_ref = partial_schur(A, 2, **kwargs)
    np.testing.assert_array_equal(to_numpy(T), to_numpy(T_ref))
    assert h.total_matvecs == h_ref.total_matvecs


# -- a resume repeats the unbroken run --------------------------------------

def _route(kind, A):
    """``(port input, port kwargs, JAX input, JAX kwargs)`` of one route."""
    n = A.shape[0]
    common = dict(sort_function="LR", max_restarts=5000)
    if kind in ("host_engine", "host_numpy"):
        src = A if kind == "host_engine" else A.toarray()
        kw = dict(common, max_dim=12, stopping_criterion=1e-10)
        return (src, dict(kw, device="cpu", v0=_jax_v0(n)), src,
                dict(kw, key=jax.random.key(KEY)))
    if kind == "device_f32":
        kw = dict(common, max_dim=12, stopping_criterion=1e-5, dtype=np.float32)
        return (as_operator(A, device="cpu"), dict(kw, v0=_jax_v0(n, np.float32)),
                A, dict(kw, key=jax.random.key(KEY)))
    kw = dict(common, max_dim=16, stopping_criterion=1e-10, block_size=2,
              dtype=np.float64)
    return (as_operator(A, device="cpu"),
            dict(kw, _start_block=_jax_start_block(n, 2)), A,
            dict(kw, key=jax.random.key(KEY)))


@pytest.mark.parametrize("kind", ["host_engine", "host_numpy", "device_f32",
                                  "block2"])
def test_resume_repeats_the_unbroken_run(kind, tmp_path, monkeypatch):
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    A = mark(15)
    src, kw, jsrc, jkw = _route(kind, A)
    _, _, h_jax = jax_partial_schur(jsrc, 3, **jkw)
    Q, T, h = partial_schur(src, 3, **kw)
    restarts = len(h.residual_trace)
    assert (h.total_matvecs, restarts) == (h_jax.total_matvecs,
                                           len(h_jax.residual_trace))
    if kind == "host_engine":
        assert (h.total_matvecs, restarts) == (76, 12)
        assert "engine.cycle" in h.phases
    if kind == "host_numpy":
        assert "host.expand" in h.phases and "engine.cycle" not in h.phases
    if kind == "device_f32":
        assert (h.total_matvecs, restarts) == (52, 11)

    ckpt = str(tmp_path / f"{kind}.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(src, 3, checkpoint_path=ckpt, **dict(kw, max_restarts=restarts // 2))
    assert load_checkpoint(ckpt).restart == restarts // 2
    Q2, T2, h2 = partial_schur(src, 3, checkpoint_path=ckpt, resume=True, **kw)
    np.testing.assert_array_equal(to_numpy(T2), to_numpy(T))
    np.testing.assert_array_equal(to_numpy(Q2), to_numpy(Q))
    assert h2.total_matvecs == h.total_matvecs
    assert h2.residual_trace == h.residual_trace
    np.testing.assert_array_equal(h2.matvecs, h.matvecs)
    np.testing.assert_array_equal(h2.restarts, h.restarts)


def test_refined_solve_resumes_its_float32_phase(tmp_path, monkeypatch):
    """A float32 solve to 1e-8 snapshots its float32 phase; the resumed
    solve runs the same continuation to the same T."""
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    A = mark(15)
    op = as_operator(A, device="cpu")
    kw = dict(max_dim=12, stopping_criterion=1e-8, sort_function="LR",
              dtype=np.float32, max_restarts=5000, v0=_jax_v0(A.shape[0]))
    Q, T, h = partial_schur(op, 3, **kw)
    assert T.dtype == torch.float64 and "refine.continue" in h.phases
    phase_restarts = len(h.residual_trace) - 1     # the trace ends with tol
    ckpt = str(tmp_path / "refined.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(op, 3, checkpoint_path=ckpt,
                      **dict(kw, max_restarts=phase_restarts // 2))
    ck = load_checkpoint(ckpt)
    assert ck.V.dtype == np.float32 and ck.restart == phase_restarts // 2
    Q2, T2, h2 = partial_schur(op, 3, checkpoint_path=ckpt, resume=True, **kw)
    np.testing.assert_array_equal(to_numpy(T2), to_numpy(T))
    assert h2.total_matvecs == h.total_matvecs
    np.testing.assert_array_equal(h2.restarts, h.restarts)
    _assert_schur(A, Q2, T2)


# -- snapshots cross packages ------------------------------------------------

@pytest.mark.parametrize("kind", ["host_engine", "device_f32"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_resume_in_the_other_package(writer, kind, tmp_path):
    A = mark(15)
    src, kw, jsrc, jkw = _route(kind, A)
    _, _, h_full = partial_schur(src, 3, **kw)
    budget = len(h_full.residual_trace) // 2
    mine, theirs = str(tmp_path / "own.npz"), str(tmp_path / "other.npz")
    write = {"jax": lambda path: jax_partial_schur(
                 jsrc, 3, checkpoint_path=path, **dict(jkw, max_restarts=budget)),
             "port": lambda path: partial_schur(
                 src, 3, checkpoint_path=path, **dict(kw, max_restarts=budget))}
    resume = {"jax": lambda path: jax_partial_schur(
                  jsrc, 3, checkpoint_path=path, resume=True, **jkw),
              "port": lambda path: partial_schur(
                  src, 3, checkpoint_path=path, resume=True, **kw)}
    reader = "port" if writer == "jax" else "jax"
    for path in (mine, theirs):
        with pytest.raises(ValueError, match="Has not converged"):
            write[writer](path)
    # The writer's own resume, and the other package's from the same file.
    _, T_own, h_own = resume[writer](mine)
    _, T_other, h_other = resume[reader](theirs)
    assert h_other.total_matvecs == h_own.total_matvecs
    assert len(h_other.residual_trace) == len(h_own.residual_trace)
    np.testing.assert_array_equal(np.asarray(h_other.matvecs), np.asarray(h_own.matvecs))
    scale = np.abs(np.diag(to_numpy(T_own))).max()
    np.testing.assert_allclose(np.diag(to_numpy(T_other)), np.diag(to_numpy(T_own)),
                               rtol=0, atol=1e-9 * scale)


# -- refusals -----------------------------------------------------------------

def test_a_sharded_snapshot_is_refused(tmp_path):
    A = mark(15)
    ckpt = str(tmp_path / "ks.npz")
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(A, 3, max_restarts=2, checkpoint_path=ckpt,
                      **dict(HOST, v0=_jax_v0(A.shape[0])))
    ck = load_checkpoint(ckpt)
    # the JAX package's sharded metadata file: every key but V
    jax_checkpoint._atomic_savez(ckpt, **jax_checkpoint._meta_arrays(ck))
    assert load_checkpoint(ckpt).V is None
    # without a mesh, as JAX asserts (resume needs a mesh of any size)
    with pytest.raises(AssertionError, match="sharded checkpoint: pass a mesh"):
        partial_schur(A, 3, checkpoint_path=ckpt, resume=True,
                      **dict(HOST, v0=_jax_v0(A.shape[0])))


def test_a_snapshot_of_another_geometry_is_refused_as_jax_refuses_it(tmp_path):
    A = mark(15)
    n = A.shape[0]
    ckpt = str(tmp_path / "ks.npz")
    save_checkpoint(ckpt, RestartCheckpoint(
        V=np.eye(5, n), H_hp=np.zeros((11, 10)), pa=4, restart=3,
        total_matvecs=30, matvecs=np.zeros(3, np.int32),
        restarts=np.zeros(3, np.int32), residual_trace=[1.0, 0.5, 0.2]))
    with pytest.raises(AssertionError, match="does not match workspace"):
        jax_partial_schur(A, 3, max_dim=12, checkpoint_path=ckpt, resume=True)
    with pytest.raises(AssertionError, match="does not match workspace"):
        partial_schur(A, 3, max_dim=12, checkpoint_path=ckpt, resume=True,
                      device="cpu")


def test_mesh_still_raises():
    # mesh= takes a parallel.Mesh: any other object is refused
    with pytest.raises(TypeError, match="parallel.Mesh"):
        partial_schur(as_operator(mark(10), device="cpu"), 2, mesh=object())
