"""The port's filtered drivers on a row mesh (``mesh=``) against its own
unsharded solves and the JAX package's, on the CPU.

In process: a one-rank mesh (no process group) over ``shard_operator``'s
all-gather and over the DIA halo repeats the unsharded port bit for bit
(``spectrum_bounds``, ``spectral_moments``, ``eigsh_filtered``,
``eigsh_window``: values, vectors, matvecs and sweeps); the refusals.

Spawned (two gloo ranks, ``torch_dist_worker.py filtered_mesh``): the
inputs of JAX's ``tests/test_filtered.py::TestFilteredMesh`` (laplace(256):
nev 4 in (-2.2, -1.8) at tol 1e-10 in float64; nev 3 at tol 1e-9 in
float32 refined; ``eigsh_window`` (-2.15, -1.95) at tol 1e-10) over the
DIA halo and over the all-gather, from JAX's bounds, start block and
probes, against JAX's unsharded solves: values within 1e-9, residuals
under JAX's limits (1e-9; 4e-9 for float32), both ranks with the same
matvecs.  laplace_3d(8) as ELL over the ELL halo against the exact
spectrum, and a KPM count on two ranks against one.
"""

import jax
import numpy as np
import pytest
import torch

from arnoldi_tpu.linop import as_operator as jax_as_operator
from arnoldi_tpu.matrices import laplace, laplace_3d, laplace_3d_eigen, laplace_eigen
from arnoldi_tpu.solvers import filtered as jf
from arnoldi_tpu_torch import CallableOperator, as_operator
from arnoldi_tpu_torch.parallel import Mesh, halo_matvec_closure, make_mesh
from arnoldi_tpu_torch.solvers import filtered as pf

import torch_dist
import torch_dist_worker as worker

torch.set_num_threads(1)

N = 256


def _residual(A, vals, V):
    return np.linalg.norm(A @ V - V * np.asarray(vals)[None, :], axis=0)


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(device="cpu")


def _routes(mesh):
    L = laplace(N).tocsr()
    dia = as_operator(L, device="cpu")
    return L, {"gather": L, "halo": halo_matvec_closure(dia, mesh)}


def _gen():
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize("route", ["gather", "halo"])
@pytest.mark.parametrize("driver", ["bounds", "moments", "filtered", "window"])
def test_one_rank_mesh_is_the_unsharded_solve(driver, route, mesh1):
    # one rank: every all-reduce is of one term and every block is whole,
    # so the mesh run repeats the unsharded one bit for bit
    L, ops = _routes(mesh1)
    op = ops[route]
    if driver == "bounds":
        assert pf.spectrum_bounds(op, generator=_gen(), mesh=mesh1,
                                  device="cpu") == \
            pf.spectrum_bounds(L, generator=_gen(), device="cpu")
        return
    if driver == "moments":
        bounds = (-4.01, 0.01)
        mesh_op = op if route == "halo" else as_operator(L, device="cpu")
        np.testing.assert_array_equal(
            pf.spectral_moments(mesh_op, 200, bounds=bounds, generator=_gen(),
                                mesh=mesh1),
            pf.spectral_moments(as_operator(L, device="cpu"), 200, bounds=bounds,
                                generator=_gen()))
        return
    if driver == "filtered":
        def run(A, **kw):
            return pf.eigsh_filtered(A, 4, (-2.2, -1.8), tol=1e-10,
                                     dtype=np.float64, generator=_gen(),
                                     device="cpu", **kw)
    else:
        def run(A, **kw):
            return pf.eigsh_window(A, (-2.15, -1.95), tol=1e-10,
                                   dtype=np.float64, generator=_gen(),
                                   device="cpu", **kw)
    vals, vecs, hist = run(op, mesh=mesh1)
    want_vals, want_vecs, want_hist = run(L)
    np.testing.assert_array_equal(vals, want_vals)
    assert torch.equal(vecs, want_vecs)
    assert hist.total_matvecs == want_hist.total_matvecs
    np.testing.assert_array_equal(hist.restarts, want_hist.restarts)
    assert hist.residual_trace == want_hist.residual_trace
    assert vals.size and _residual(L, vals, vecs.numpy()).max() < 1e-9


def test_refusals():
    L = laplace(N + 1).tocsr()
    two = Mesh(None, 0, 2, torch.device("cpu"))     # refused before any collective
    for call in (lambda: pf.eigsh_filtered(L, 2, (-2.2, -1.8), mesh=two),
                 lambda: pf.eigsh_window(L, (-2.2, -1.8), mesh=two),
                 lambda: pf.spectrum_bounds(L, mesh=two),
                 lambda: pf.estimate_window_count(L, (-2.2, -1.8), mesh=two)):
        with pytest.raises(ValueError, match="pad_operator"):
            call()
    A = as_operator(laplace(N).tocsr(), device="cpu")
    fn = CallableOperator(A.matvec, A.shape, A.dtype, A.nnz, device="cpu")
    with pytest.raises(TypeError, match="CallableOperator cannot be sharded"):
        pf.eigsh_filtered(fn, 2, (-2.2, -1.8), mesh=two)


def _jax_inputs():
    """JAX's ``TestFilteredMesh`` solves (unsharded, on the CPU) and the
    bounds, start blocks and probes they drew from their keys."""
    L = laplace(N).tocsr()
    inputs, ref = {}, {}
    for case, seed in (("f64", 0), ("f32", 1)):
        nev, window, tol, dtype = worker.FILTER_CASES[case]
        key = jax.random.key(seed)
        kb, kx, kz = jax.random.split(key, 3)
        vals, vecs, _, (_, X) = jf.eigsh_filtered(L, nev, window, tol=tol,
                                                  dtype=dtype, key=key,
                                                  _extras=True)
        ref[case] = (np.asarray(vals), np.asarray(vecs, np.float64))
        s = X.shape[0]
        inputs[f"{case}_bounds"] = np.asarray(jf.spectrum_bounds(
            jax_as_operator(L, dtype=dtype), 40, key=kb))
        inputs[f"{case}_X0"] = np.asarray(jax.random.normal(kx, (s, N), dtype=dtype))
        inputs[f"{case}_sizing"] = np.asarray(jax.random.rademacher(
            jax.random.split(kz)[0], (8, N), dtype=dtype))
    _, window, tol, dtype = worker.FILTER_CASES["window"]
    key = jax.random.key(2)
    kb, kz, _ = jax.random.split(key, 3)
    vals, vecs, _ = jf.eigsh_window(L, window, tol=tol, dtype=dtype, key=key)
    ref["window"] = (np.asarray(vals), np.asarray(vecs))
    inputs["window_bounds"] = np.asarray(jf.spectrum_bounds(
        jax_as_operator(L, dtype=dtype), 40, key=kb))
    inputs["window_census"] = np.asarray(jax.random.rademacher(kz, (8, N),
                                                               dtype=dtype))
    return inputs, ref


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("filtered_mesh")
    inputs, ref = _jax_inputs()
    np.savez(out / "filtered_inputs.npz", **inputs)
    return torch_dist.spawn("filtered_mesh", 2, str(out)), ref


@pytest.mark.parametrize("route", ["halo", "gather"])
@pytest.mark.parametrize("case", list(worker.FILTER_CASES))
def test_two_ranks_match_jax(case, route, two_ranks):
    ranks, ref = two_ranks
    L = laplace(N).tocsr()
    key = f"{route}_{case}"
    got = [r[f"{key}_vals"] for r in ranks]
    np.testing.assert_array_equal(got[0], got[1])      # replicated values
    assert len({int(r[f"{key}_matvecs"]) for r in ranks}) == 1
    assert len({int(r[f"{key}_sweeps"]) for r in ranks}) == 1
    vals_j, vecs_j = ref[case]
    assert len(got[0]) == len(vals_j)
    np.testing.assert_allclose(got[0], vals_j, rtol=0, atol=1e-9)
    limit = 4e-9 if case == "f32" else 1e-9
    V = ranks[0][f"{key}_vecs"]
    assert V.shape == (N, len(vals_j))
    assert _residual(L, got[0], V).max() < limit
    assert _residual(L, vals_j, vecs_j).max() < limit
    if case == "window":
        full = np.sort(laplace_eigen(N))
        want = full[(full >= -2.15) & (full <= -1.95)]
        np.testing.assert_allclose(got[0], want, atol=1e-9)


def test_two_ranks_ell_halo_and_count(two_ranks, mesh1):
    ranks, _ = two_ranks
    assert len({int(r["ell_matvecs"]) for r in ranks}) == 1
    vals = ranks[0]["ell_vals"]
    full = np.sort(laplace_3d_eigen(8))
    a, b = worker.FILTER_ELL_WINDOW
    want = full[(full >= a) & (full <= b)]
    assert len(vals) == want.size
    np.testing.assert_allclose(vals, want, atol=1e-9)
    assert _residual(laplace_3d(8), vals, ranks[0]["ell_vecs"]).max() < 1e-9
    one = pf.estimate_window_count(
        as_operator(laplace(N).tocsr(), device="cpu"), (-2.2, -1.8),
        bounds=(-4.01, 0.01), mesh=mesh1, generator=torch.Generator().manual_seed(4))
    assert ranks[0]["count"] == ranks[1]["count"]
    np.testing.assert_allclose(ranks[0]["count"], one, rtol=1e-10)


def test_two_ranks_time_the_ring_exchange(two_ranks, mesh1):
    """A mesh's clock takes the host time of each ring exchange: one start
    and one wait a halo product, on both ranks; a one-rank mesh exchanges
    nothing."""
    ranks, _ = two_ranks
    for r in ranks:
        np.testing.assert_array_equal(r["ring_calls"], [3, 3])
        assert (r["ring_seconds"] > 0).all()
    assert mesh1.clock.report() == {}
