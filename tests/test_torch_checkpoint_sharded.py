"""Sharded (mesh) checkpoints of the port's ``partial_schur`` against the
JAX package's, on the CPU.

The JAX package (``tests/conftest.py``'s 8 virtual devices, one process,
one shard file of 8 pieces) cuts ``mark(30)`` (LR, 3 pairs, m = 20, tol
1e-9, cgs2, the same numpy ``v0``) at 8 restarts into a snapshot; the
port resumes it on 2 gloo ranks and on one.  The port cuts the same
solve on 2 ranks (a shard file a rank); its resumed run repeats its
unbroken run (bit-equal T, equal matvecs and restarts), it resumes on 4
ranks (mesh-elastic), and the JAX package resumes it on its 8 devices.
Eigenvalues within 1e-9 of JAX's unbroken solve.  In process: the files'
layout and generation token, stale shards refused, surplus shard files
deleted.
"""

import os

import jax
import numpy as np
import pytest
import torch

from arnoldi_tpu.matrices import mark
from arnoldi_tpu.parallel import make_mesh as jax_make_mesh
from arnoldi_tpu.parallel import sharded_partial_schur as jax_sharded_partial_schur
from arnoldi_tpu.utils import checkpoint as jax_checkpoint
from arnoldi_tpu.utils.sorting import arg_largest_real
from arnoldi_tpu_torch import as_operator, partial_schur
from arnoldi_tpu_torch.parallel import Mesh, make_mesh
from arnoldi_tpu_torch.utils import checkpoint
from torch_dist_worker import CKPT_ARGS, CKPT_CUT

import torch_dist

torch.set_num_threads(1)
A = mark(30)
N = A.shape[0]
V0 = np.random.default_rng(11).standard_normal(N)
JAX_ARGS = dict(CKPT_ARGS, sort_function=arg_largest_real, v0=V0)


def _values(T):
    return np.sort_complex(np.linalg.eigvals(np.asarray(T)))


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def run(jax_mesh, tmp_path_factory):
    """JAX's unbroken solve and its cut snapshot, the port's 2-rank
    checkpoint scenario and its 4-rank elastic resume, then JAX's resume
    of the port's snapshot."""
    out = tmp_path_factory.mktemp("ckpt")
    _, T_jax, h_jax = jax_sharded_partial_schur(A, 3, mesh=jax_mesh,
                                                max_restarts=2000, **JAX_ARGS)
    with pytest.raises(ValueError, match="Has not converged"):
        jax_sharded_partial_schur(A, 3, mesh=jax_mesh, max_restarts=CKPT_CUT,
                                  checkpoint_path=str(out / "jax_ck.npz"),
                                  **JAX_ARGS)
    two = torch_dist.spawn("checkpoint", 2, out)
    files = {k: dict(np.load(str(out / f"port_ck.npz.p{k}")))
             for k in range(2)}
    four = torch_dist.spawn("checkpoint_elastic", 4, out)
    _, T_back, h_back = jax_sharded_partial_schur(
        A, 3, mesh=jax_mesh, max_restarts=2000, resume=True,
        checkpoint_path=str(out / "port_ck.npz"), checkpoint_every=10**6,
        **JAX_ARGS)
    return dict(out=out, T_jax=np.asarray(T_jax), h_jax=h_jax, two=two,
                four=four, files=files, T_back=np.asarray(T_back),
                h_back=h_back)


def test_the_port_resumes_a_jax_snapshot_on_two_ranks(run):
    for r in run["two"]:
        assert int(r["from_jax_restarts"]) > CKPT_CUT   # continued, not restarted
        np.testing.assert_allclose(_values(r["from_jax_T"]), _values(run["T_jax"]),
                                   rtol=1e-9, atol=1e-9)
    assert len({int(r["from_jax_matvecs"]) for r in run["two"]}) == 1
    Q, T = run["two"][0]["from_jax_Q"], run["two"][0]["from_jax_T"]
    assert np.linalg.norm(A @ Q - Q @ T, axis=0).max() < 1e-8


def test_the_resumed_run_repeats_the_unbroken_one(run):
    for r in run["two"]:
        np.testing.assert_array_equal(r["resumed_T"], r["unbroken_T"])
        assert int(r["resumed_matvecs"]) == int(r["unbroken_matvecs"])
        assert int(r["resumed_restarts"]) == int(r["unbroken_restarts"])
    np.testing.assert_allclose(_values(run["two"][0]["unbroken_T"]),
                               _values(run["T_jax"]), rtol=1e-9, atol=1e-9)


def test_a_two_rank_snapshot_resumes_on_four_ranks(run):
    for r in run["four"]:
        np.testing.assert_allclose(_values(r["T"]), _values(run["T_jax"]),
                                   rtol=1e-9, atol=1e-9)
        assert int(r["restarts"]) > CKPT_CUT
    Q, T = run["four"][0]["Q"], run["four"][0]["T"]
    assert np.linalg.norm(A @ Q - Q @ T, axis=0).max() < 1e-8


def test_jax_resumes_a_port_snapshot(run):
    assert len(run["h_back"].residual_trace) > CKPT_CUT
    np.testing.assert_allclose(_values(run["T_back"]), _values(run["T_jax"]),
                               rtol=1e-9, atol=1e-9)


def test_the_port_writes_the_jax_layout(run):
    meta = dict(np.load(str(run["out"] / "port_ck.npz")))
    assert "V" not in meta and bool(meta["sharded"])
    n_solve = int(meta["n_solve"])
    assert n_solve == N + (N % 2)                    # padded for 2 ranks
    for k, f in run["files"].items():
        (key,) = [name for name in f if name.startswith("c")]
        assert key == f"c{k * n_solve // 2}"
        assert f[key].shape == (int(meta["head"]), n_solve // 2)
        assert str(f["gen"]) == str(meta["gen"])
    ck = checkpoint.load_checkpoint(str(run["out"] / "port_ck.npz"))
    assert str(meta["gen"]) == checkpoint._generation(ck) \
        == jax_checkpoint._generation(ck)
    assert not os.path.exists(str(run["out"] / "port_ck.npz.p2"))


def test_one_rank_resumes_a_jax_snapshot(run):
    Q, T, h = partial_schur(as_operator(A, device="cpu"), 3,
                            mesh=make_mesh(device="cpu"), v0=V0,
                            max_restarts=2000, resume=True,
                            checkpoint_path=str(run["out"] / "jax_ck.npz"),
                            checkpoint_every=10**6, **CKPT_ARGS)
    assert len(h.residual_trace) > CKPT_CUT
    np.testing.assert_allclose(_values(T), _values(run["T_jax"]), rtol=1e-9,
                               atol=1e-9)


def _one_rank_snapshot(path):
    with pytest.raises(ValueError, match="Has not converged"):
        partial_schur(as_operator(A, device="cpu"), 3,
                      mesh=make_mesh(device="cpu"), v0=V0, max_restarts=3,
                      checkpoint_path=path, **CKPT_ARGS)


def test_stale_shards_are_refused(tmp_path):
    path = str(tmp_path / "ks.npz")
    _one_rank_snapshot(path)
    shard = dict(np.load(path + ".p0"))
    checkpoint._atomic_savez(path + ".p0", **dict(shard, gen=np.asarray("stale")))
    with pytest.raises(FileNotFoundError, match="stale-generation"):
        checkpoint.load_checkpoint_sharded(path, make_mesh(device="cpu"))


def test_surplus_shard_files_are_deleted(tmp_path):
    path = str(tmp_path / "ks.npz")
    checkpoint._atomic_savez(path + ".p3", gen=np.asarray("old"))
    _one_rank_snapshot(path)
    assert os.path.exists(path + ".p0") and not os.path.exists(path + ".p3")
    assert checkpoint.checkpoint_is_sharded(path)


def test_columns_past_the_saved_size_are_zeros(tmp_path):
    path = str(tmp_path / "ks.npz")
    _one_rank_snapshot(path)
    n_solve = N + 3                     # a wider padding than the save's
    ck = checkpoint.load_checkpoint_sharded(
        path, Mesh(None, 0, 1, torch.device("cpu")), n_solve=n_solve)
    assert ck.V.shape == (ck.pa + 1, n_solve)
    np.testing.assert_array_equal(ck.V[:, N:], 0)
