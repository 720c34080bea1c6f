"""The port's row mesh (``arnoldi_tpu_torch.parallel``) against the JAX
package's device mesh, on the CPU.

In process: a one-rank mesh (no process group) against JAX's
``sharded_partial_schur`` on ``tests/conftest.py``'s 8 virtual devices
(``mark(30)``, float64 and complex128, the same numpy ``v0`` on both
sides; eigenvalues within rtol 1e-7 / atol 1e-9 and residuals within 1e-8,
as ``tests/test_parallel.py`` holds JAX to itself), and bit for bit against
the port's own unsharded solve; ``process_local_rows`` against JAX's on
its fake 8-device mesh; the refusals.

Spawned (gloo, one CPU process a rank, ``torch_dist_worker.py``): at 2
and 4 ranks a sharded ``mark(40)`` solve (the all-gather ELL operator, the
ring-halo ELL and BSR-8 operators) against ARPACK, with every rank
counting the same matvecs, and the block driver over the DIA halo against
the exact spectrum; at 2 ranks a refined float32 ``partial_eigh`` (LA 3)
of a 9-band matrix with a separated top against ``eigvalsh`` (the 4-rank
one, over the halo, is in ``test_torch_halo.py``).  The refined float32
``partial_eigh(laplace(1024), LA 3)`` of ``test_parallel.py`` runs on the
one-rank mesh against ``laplace_eigen`` within rtol 1e-7.
"""

import jax
import numpy as np
import pytest
import torch

from arnoldi_tpu.matrices import laplace, laplace_2d, laplace_eigen, mark
from arnoldi_tpu.parallel import make_mesh as jax_make_mesh
from arnoldi_tpu.parallel import sharded_partial_schur as jax_sharded_partial_schur
from arnoldi_tpu.utils.sorting import arg_largest_real
from arnoldi_tpu_torch import (CallableOperator, as_operator, partial_eigh,
                               partial_schur)
from arnoldi_tpu_torch.parallel import (Mesh, gather_rows, halo_matvec_closure,
                                        local_rows, make_mesh, shard_operator,
                                        shard_workspace, sharded_partial_schur)
from arnoldi_tpu_torch.parallel import multihost

import torch_dist

torch.set_num_threads(1)
norm = np.linalg.norm


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_one_rank_mesh_matches_jax(dtype, jax_mesh, mesh1):
    A = mark(30)       # n = 465; JAX pads it to 472 on 8 devices
    v0 = np.random.default_rng(7).standard_normal(A.shape[0])
    args = dict(stopping_criterion=1e-9, max_restarts=2000, dtype=dtype, v0=v0)
    Qj, Tj, hj = jax_sharded_partial_schur(A, 3, mesh=jax_mesh,
                                           sort_function=arg_largest_real, **args)
    Q, T, h = sharded_partial_schur(as_operator(A, device="cpu"), 3, mesh=mesh1,
                                    sort_function="LR", **args)
    assert Q.shape == (A.shape[0], T.shape[0]) and T.dtype == torch.from_numpy(
        np.zeros(1, dtype)).dtype
    for Qh, Th in ((np.asarray(Qj), np.asarray(Tj)), (Q.numpy(), T.numpy())):
        np.testing.assert_allclose(norm(A @ Qh - Qh @ Th, axis=0), 0, atol=1e-8)
    want = np.sort_complex(np.linalg.eigvals(np.asarray(Tj)))
    got = np.sort_complex(np.linalg.eigvals(T.numpy()))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("case", ["ell", "banded", "halo_banded", "block_bsr"])
def test_one_rank_mesh_is_the_unsharded_solve(case, mesh1):
    # one rank: every all-reduce is of one term, so the mesh solve repeats
    # the unsharded one bit for bit, matvec for matvec
    if case == "ell":
        op, args = as_operator(mark(30), device="cpu"), dict(sort_function="LR")
    elif case == "block_bsr":       # n = 496: whole blocks, no padding
        op = as_operator(mark(31), format=("bsr", (8, 8)), device="cpu")
        args = dict(sort_function="LR", block_size=4)
    else:
        op, args = as_operator(laplace_2d(20), device="cpu"), dict(max_dim=30)
    args.update(stopping_criterion=1e-9, max_restarts=2000)
    Q0, T0, h0 = partial_schur(op, 4, **args)
    A = halo_matvec_closure(op, mesh1) if case == "halo_banded" else op
    Q1, T1, h1 = partial_schur(A, 4, mesh=mesh1, **args)
    assert h1.total_matvecs == h0.total_matvecs
    np.testing.assert_array_equal(T1.numpy(), T0.numpy())
    np.testing.assert_array_equal(Q1.numpy(), Q0.numpy())


def test_shard_operator_and_workspace(mesh1):
    A = mark(20)
    op = as_operator(A, device="cpu")
    sop = shard_operator(op, mesh1)
    assert sop.shape == op.shape and sop.n_global == op.shape[0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(A.shape[0]))
    np.testing.assert_array_equal(sop.matvec(x).numpy(), op.matvec(x).numpy())
    assert shard_operator(sop, mesh1) is sop
    Vt, H = torch.zeros(21, 210, dtype=torch.float64), torch.zeros(21, 20)
    Vs, Hs = shard_workspace(Vt, H, mesh1)
    assert Vs.shape == Vt.shape and Hs.shape == H.shape
    assert local_rows(210, mesh1) == (0, 210)
    assert gather_rows(x, mesh1) is x


def test_refusals(mesh1):
    op = as_operator(mark(10), device="cpu")
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="needs a process group"):
        Mesh(None, 0, 2, torch.device("cpu")).all_reduce(torch.ones(2))
    with pytest.raises(ValueError, match="another mesh"):
        partial_schur(shard_operator(op, mesh1), 2,
                      mesh=Mesh(None, 1, 2, torch.device("cpu")))
    with pytest.raises(TypeError, match="cannot be sharded"):
        shard_operator(CallableOperator(op.matvec, op.shape, op.dtype,
                                        device="cpu"), mesh1)
    with pytest.raises(ValueError, match="divide"):
        local_rows(7, Mesh(None, 0, 2, torch.device("cpu")))
    with pytest.raises(TypeError, match="parallel.Mesh"):
        sharded_partial_schur(op, 2, mesh=jax_make_mesh(1))


def test_process_local_rows_matches_jax():
    import unittest.mock as mock

    from jax.sharding import Mesh as JaxMesh

    from arnoldi_tpu.parallel.multihost import \
        process_local_rows as jax_process_local_rows

    class FakeDev:
        def __init__(self, pid):
            self.process_index = pid
            self.id = pid

    fake = JaxMesh(np.array([FakeDev(i) for i in range(8)]), ("rows",))
    for rank in range(8):
        with mock.patch.object(jax, "process_index", lambda: rank):
            want = jax_process_local_rows(1000, fake, row_granularity=8)
        got = multihost.process_local_rows(
            1000, Mesh(None, rank, 8, torch.device("cpu")), row_granularity=8)
        assert got == want
    assert multihost.process_local_rows(1000, make_mesh(device="cpu")) == (0, 1000)


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("ARNOLDI_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    multihost.initialize()
    assert not dist.is_initialized()
    m = multihost.make_slice_mesh(device="cpu")
    assert (m.rank, m.size, m.group) == (0, 1, None)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def solves(request, tmp_path_factory):
    size = request.param
    out = tmp_path_factory.mktemp(f"solves{size}")
    return size, torch_dist.spawn("solves", size, out)


@pytest.fixture(scope="module")
def mark40_reference():
    from scipy.sparse.linalg import eigs

    A = mark(40)
    return A, eigs(A, 5, which="LM", ncv=40)[0]


@pytest.mark.parametrize("label", ["gather", "halo_ell", "halo_bsr"])
def test_sharded_mark_matches_arpack(label, solves, mark40_reference):
    size, ranks = solves
    A, ref = mark40_reference
    counts = {int(r[f"{label}_matvecs"]) for r in ranks}
    assert len(counts) == 1, f"ranks count different matvecs: {counts}"
    T, Q = ranks[0][f"{label}_T"], ranks[0][f"{label}_Q"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{label}_T"], T)   # replicated
    vals = np.linalg.eigvals(T)
    np.testing.assert_allclose(np.sort(np.abs(vals)), np.sort(np.abs(ref)),
                               atol=1e-7)
    assert Q.shape == (A.shape[0], T.shape[0])
    assert norm(A @ Q - Q @ T, axis=0).max() < 5e-7


def test_block_driver_over_the_dia_halo(solves):
    size, ranks = solves
    assert len({int(r["block_matvecs"]) for r in ranks}) == 1
    T, Q = ranks[0]["block_T"], ranks[0]["block_Q"]
    L = laplace_2d(32)
    e1 = laplace_eigen(32)
    want = np.sort((e1[:, None] + e1[None, :]).ravel())[:4]   # largest magnitude
    np.testing.assert_allclose(np.sort(np.linalg.eigvals(T).real)[:4], want,
                               rtol=1e-9, atol=1e-9)
    assert norm(L @ Q - Q @ T, axis=0).max() < 1e-7


def test_local_rows_tile_the_matrix(solves):
    size, ranks = solves
    rows = np.array([r["local_rows"] for r in ranks])
    assert rows[0, 0] == 0 and rows[-1, 1] == mark(40).shape[0]
    np.testing.assert_array_equal(rows[1:, 0], rows[:-1, 1])


def test_refined_partial_eigh_of_laplace_on_a_one_rank_mesh(mesh1):
    # test_parallel.py's refined partial_eigh(laplace(1024)): ~18,500
    # matvecs, each a few gloo collectives on several ranks, so it runs on
    # the one-rank mesh here (the spawned ranks take a separated spectrum)
    vals, vecs, _ = partial_eigh(laplace(1024).tocsr(), 3, which="LA",
                                 stopping_criterion=1e-8, max_restarts=3000,
                                 mesh=mesh1, dtype=np.float32)
    want = np.sort(laplace_eigen(1024))[::-1][:3]
    assert vecs.dtype == torch.float64 and vecs.shape == (1024, 3)
    np.testing.assert_allclose(np.sort(vals)[::-1], want, rtol=1e-7, atol=1e-8)


def test_refined_partial_eigh_on_two_ranks(tmp_path):
    from torch_dist_worker import separated_symmetric

    ranks = torch_dist.spawn("eigh_gather", 2, tmp_path)
    A = separated_symmetric()
    want = np.linalg.eigvalsh(A.toarray())[::-1][:3]
    assert len({int(r["matvecs"]) for r in ranks}) == 1
    vals, vecs = ranks[0]["values"], ranks[0]["vectors"]
    assert vecs.dtype == np.float64 and vecs.shape == (1024, 3)
    np.testing.assert_allclose(np.sort(vals)[::-1], want, rtol=1e-7, atol=1e-9)
    assert norm(A @ vecs - vecs * vals, axis=0).max() < 1e-7
