"""Multi-process worker of the port's sharded tests (not a pytest file).

    python torch_dist_worker.py SCENARIO RANK SIZE PORT OUT_DIR

Each spawned process joins a gloo process group at ``127.0.0.1:PORT``
(``arnoldi_tpu_torch.parallel.multihost.initialize``), builds the row mesh
on the CPU, runs one scenario of :data:`SCENARIOS` and saves what it
computed to ``OUT_DIR/SCENARIO.r{RANK}.npz``; the test process compares
that with the JAX package's results.  Imports nothing of JAX.  Inputs are
made from numpy seeds, as the tests make theirs.
"""

import os
import sys

import numpy as np
import scipy.sparse as sp
import torch

torch.set_num_threads(1)

from arnoldi_tpu_torch import as_operator, partial_eigh, partial_schur  # noqa: E402
from arnoldi_tpu_torch.matrices import (laplace, laplace_2d, mark,  # noqa: E402
                                        random_scattered)
from arnoldi_tpu_torch.linop import EllOperator  # noqa: E402
from arnoldi_tpu_torch.parallel import (banded_matvec_halo,  # noqa: E402
                                        bsr_matvec_halo, ell_matvec_halo,
                                        gather_rows, halo_matvec_closure,
                                        make_mesh, shard_operator)
from arnoldi_tpu_torch.parallel.sharded import DiaRows  # noqa: E402
from arnoldi_tpu_torch.parallel.multihost import (initialize,  # noqa: E402
                                                  process_local_rows)

#: name -> (matrix, format) of the matvec cases (every n divides 8).
MATVEC_CASES = {
    "laplace_1024": (lambda: laplace(1024).tocsr(), "banded"),
    "laplace_2d_32": (lambda: laplace_2d(32), "banded"),
    "laplace_2d_16_32": (lambda: laplace_2d(16, 32), "banded"),
    "scattered_ell": (lambda: random_scattered(4096, 24, seed=2, bandwidth=64),
                      "ell"),
    "scattered_bsr": (lambda: random_scattered(4096, 24, seed=2, bandwidth=64,
                                               block=8), ("bsr", (8, 8))),
    "diagonal_banded": (lambda: sp.diags(np.linspace(1.0, 2.0, 512)).tocsr(),
                        "banded"),
    "diagonal_ell": (lambda: sp.diags(np.linspace(1.0, 2.0, 512)).tocsr(), "ell"),
    "diagonal_bsr": (lambda: sp.diags(np.linspace(1.0, 2.0, 512)).tocsr(),
                     ("bsr", (8, 8))),
}

#: The checkpoint scenarios' solve: mark(30), LR, 3 pairs.
CKPT_ARGS = dict(max_dim=20, stopping_criterion=1e-9, sort_function="LR",
                 dtype=np.float64, ortho="cgs2")
CKPT_CUT = 8           # restarts of the cut run


def matvec_inputs(n, seed):
    """The test's x (n,) and X (3, n) for a case."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n), rng.standard_normal((3, n))


def _rows(a, mesh):
    lo, hi = process_local_rows(a.shape[-1], mesh)
    return torch.from_numpy(np.ascontiguousarray(a[..., lo:hi]))


def _gather(y, mesh):
    """The whole of a (n_local,) or (b, n_local) result on every rank."""
    if y.ndim == 1:
        return gather_rows(y, mesh).numpy()
    return gather_rows(y.T.contiguous(), mesh).T.numpy()


def _halo_apply(halo, x, overlap):
    """``halo``'s product with its block ``x``, through the format's
    ``*_matvec_halo`` with the exchange overlapped or not."""
    local, mesh = halo.local, halo.mesh
    if isinstance(local, DiaRows):
        return banded_matvec_halo(local, x, mesh, overlap=overlap)
    if isinstance(local, EllOperator):
        return ell_matvec_halo(local, x, mesh, halo.halo, overlap=overlap)
    return bsr_matvec_halo(local, x, mesh, halo.halo, overlap=overlap)


def scenario_matvecs(mesh, out):
    """Ring-halo (overlap on and off) and all-gather products of every
    case, one column and three, gathered."""
    res = {}
    for seed, (name, (make, fmt)) in enumerate(MATVEC_CASES.items()):
        A = make()
        op = as_operator(A, format=fmt, device="cpu")
        x, X = matvec_inputs(A.shape[0], seed)
        halo = halo_matvec_closure(op, mesh)
        for overlap in (True, False):
            res[f"halo_{name}_{overlap}"] = _gather(
                _halo_apply(halo, _rows(x, mesh), overlap), mesh)
            res[f"halo_cols_{name}_{overlap}"] = _gather(
                _halo_apply(halo, _rows(X, mesh), overlap), mesh)
        res[f"halo_width_{name}"] = np.asarray(halo.halo)
        sharded = shard_operator(op, mesh)
        res[f"gather_{name}"] = _gather(sharded.matvec(_rows(x, mesh)), mesh)
        res[f"gather_cols_{name}"] = _gather(sharded.matmat_rows(_rows(X, mesh)),
                                             mesh)
    return res


def scenario_solves(mesh, out):
    """A sharded mark(40) (all-gather ELL, and ring-halo ELL and BSR-8) and
    the block driver over the DIA halo; each rank's counts."""
    from arnoldi_tpu_torch.linop import pad_operator

    res = {}
    A = mark(40)
    n = A.shape[0]
    args = dict(max_dim=20, stopping_criterion=1e-8, sort_function="LM",
                max_restarts=2000, dtype=np.float64, refine=None)
    ell = as_operator(A, format="ell", device="cpu")
    bsr = as_operator(A, format=("bsr", (8, 8)), device="cpu")
    gran = mesh.size * 8
    bsr = pad_operator(bsr, -(-n // gran) * gran)
    for label, op in (("gather", ell),
                      ("halo_ell", halo_matvec_closure(ell, mesh)),
                      ("halo_bsr", halo_matvec_closure(bsr, mesh))):
        Q, T, hist = partial_schur(op, 5, mesh=mesh, **args)
        res[f"{label}_T"] = T.numpy()
        res[f"{label}_Q"] = gather_rows(Q, mesh).numpy()[:n]
        res[f"{label}_matvecs"] = np.asarray(hist.total_matvecs)
    L = laplace_2d(32)
    Q, T, hist = partial_schur(halo_matvec_closure(as_operator(L, device="cpu"),
                                                   mesh), 4, max_dim=24, p=12,
                               block_size=4, stopping_criterion=1e-9,
                               sort_function="LM", max_restarts=3000)
    res["block_T"] = T.numpy()
    res["block_Q"] = gather_rows(Q, mesh).numpy()
    res["block_matvecs"] = np.asarray(hist.total_matvecs)
    lo, hi = process_local_rows(n, mesh)
    res["local_rows"] = np.asarray([lo, hi])
    return res


def separated_symmetric(n=1024):
    """The symmetric part of ``random_scattered(n, 24, seed=3,
    bandwidth=4)``: 9 diagonals (DIA), its three largest eigenvalues well
    separated (a refined float32 ``partial_eigh`` takes ~56 matvecs)."""
    R = random_scattered(n, 24, seed=3, bandwidth=4)
    return ((R + R.T) / 2).tocsr()


def _eigh(mesh, A):
    vals, vecs, hist = partial_eigh(A, 3, which="LA", stopping_criterion=1e-8,
                                    max_restarts=3000, mesh=mesh,
                                    dtype=np.float32)
    return {"values": np.asarray(vals), "vectors": gather_rows(vecs, mesh).numpy(),
            "matvecs": np.asarray(hist.total_matvecs),
            "refined": np.asarray("refine.continue" in (hist.phases or {})
                                  or vecs.dtype == torch.float64)}


def scenario_eigh_gather(mesh, out):
    """The refined float32 ``partial_eigh`` (LA 3) of
    :func:`separated_symmetric` as a SciPy matrix (sharded with the
    all-gather of x)."""
    return _eigh(mesh, separated_symmetric())


def scenario_eigh_halo(mesh, out):
    """The same solve over the ring-halo DIA operator."""
    return _eigh(mesh, halo_matvec_closure(
        as_operator(separated_symmetric(), device="cpu"), mesh))


def _ckpt_solve(mesh, **kw):
    A = as_operator(mark(30), device="cpu")
    v0 = np.random.default_rng(11).standard_normal(A.shape[0])
    return partial_schur(A, 3, mesh=mesh, v0=v0, **CKPT_ARGS, **kw)


def scenario_checkpoint(mesh, out):
    """Resume the JAX package's snapshot ``out/jax_ck.npz``; then an
    unbroken solve, the same solve cut at :data:`CKPT_CUT` restarts into
    ``out/port_ck.npz`` and resumed from it (no further snapshots)."""
    res = {}
    Q, T, hist = _ckpt_solve(mesh, max_restarts=2000, resume=True,
                             checkpoint_path=os.path.join(out, "jax_ck.npz"),
                             checkpoint_every=10**6)
    res["from_jax_T"] = T.numpy()
    res["from_jax_matvecs"] = np.asarray(hist.total_matvecs)
    res["from_jax_restarts"] = np.asarray(len(hist.residual_trace))
    res["from_jax_Q"] = gather_rows(Q, mesh).numpy()
    Q, T, hist = _ckpt_solve(mesh, max_restarts=2000)
    res["unbroken_T"], res["unbroken_matvecs"] = T.numpy(), np.asarray(
        hist.total_matvecs)
    res["unbroken_restarts"] = np.asarray(len(hist.residual_trace))
    path = os.path.join(out, "port_ck.npz")
    try:
        _ckpt_solve(mesh, max_restarts=CKPT_CUT, checkpoint_path=path)
        raise AssertionError("the cut run converged")
    except ValueError as e:
        assert "Has not converged" in str(e), e
    Q, T, hist = _ckpt_solve(mesh, max_restarts=2000, resume=True,
                             checkpoint_path=path, checkpoint_every=10**6)
    res["resumed_T"], res["resumed_matvecs"] = T.numpy(), np.asarray(
        hist.total_matvecs)
    res["resumed_restarts"] = np.asarray(len(hist.residual_trace))
    return res


def scenario_checkpoint_elastic(mesh, out):
    """Resume ``out/port_ck.npz`` (written on another rank count)."""
    Q, T, hist = _ckpt_solve(mesh, max_restarts=2000, resume=True,
                             checkpoint_path=os.path.join(out, "port_ck.npz"),
                             checkpoint_every=10**6)
    return {"T": T.numpy(), "matvecs": np.asarray(hist.total_matvecs),
            "restarts": np.asarray(len(hist.residual_trace)),
            "Q": gather_rows(Q, mesh).numpy()}


#: The filtered solves of ``test_torch_filtered_mesh.py`` (JAX's
#: ``TestFilteredMesh`` inputs): name -> (nev, window, tol, dtype).
FILTER_CASES = {
    "f64": (4, (-2.2, -1.8), 1e-10, np.float64),
    "f32": (3, (-2.2, -1.8), 1e-9, np.float32),
    "window": (None, (-2.15, -1.95), 1e-10, np.float64),
}
FILTER_ELL_WINDOW = (-6.1, -5.9)       # laplace_3d(8) as ELL


def _filtered(op, case, inputs, mesh):
    """One of :data:`FILTER_CASES` on ``op`` from the JAX package's bounds,
    start block and probes (``inputs``, saved by the test)."""
    from arnoldi_tpu_torch import eigsh_filtered, eigsh_window

    nev, window, tol, dtype = FILTER_CASES[case]
    bounds = tuple(inputs[f"{case}_bounds"])
    if case == "window":
        return eigsh_window(op, window, tol=tol, dtype=dtype, bounds=bounds,
                            mesh=mesh, _probes={"census": inputs["window_census"]})
    return eigsh_filtered(op, nev, window, tol=tol, dtype=dtype, bounds=bounds,
                          X0=inputs[f"{case}_X0"], mesh=mesh,
                          _probes={"sizing": inputs[f"{case}_sizing"]})


def scenario_filtered_mesh(mesh, out):
    """The filtered drivers on laplace(256) over the DIA halo and the
    all-gather (:data:`FILTER_CASES`), laplace_3d(8) as ELL over the ELL
    halo (all pairs of :data:`FILTER_ELL_WINDOW`), and the KPM count of a
    window; each result's values, gathered vectors and counts."""
    from arnoldi_tpu_torch.matrices import laplace_3d
    from arnoldi_tpu_torch.solvers.filtered import estimate_window_count

    with np.load(os.path.join(out, "filtered_inputs.npz")) as z:
        inputs = {k: z[k] for k in z.files}
    res = {}
    L = laplace(256).tocsr()
    dia = as_operator(L, device="cpu")
    for route, op in (("halo", halo_matvec_closure(dia, mesh)), ("gather", L)):
        for case in FILTER_CASES:
            vals, vecs, hist = _filtered(op, case, inputs, mesh)
            res[f"{route}_{case}_vals"] = np.asarray(vals)
            res[f"{route}_{case}_vecs"] = gather_rows(vecs, mesh).numpy()
            res[f"{route}_{case}_matvecs"] = np.asarray(hist.total_matvecs)
            res[f"{route}_{case}_sweeps"] = np.asarray(int(hist.restarts.max()))
    ell = halo_matvec_closure(as_operator(laplace_3d(8), format="ell",
                                          device="cpu"), mesh)
    from arnoldi_tpu_torch import eigsh_filtered

    vals, vecs, hist = eigsh_filtered(ell, None, FILTER_ELL_WINDOW, tol=1e-10,
                                      dtype=np.float64,
                                      generator=torch.Generator().manual_seed(3))
    res["ell_vals"] = np.asarray(vals)
    res["ell_vecs"] = gather_rows(vecs, mesh).numpy()
    res["ell_matvecs"] = np.asarray(hist.total_matvecs)
    res["count"] = np.asarray(estimate_window_count(
        dia, (-2.2, -1.8), bounds=(-4.01, 0.01), mesh=mesh,
        generator=torch.Generator().manual_seed(4)))
    # the exchange clock: three halo products (b = 1, 2, 5) on a mesh whose
    # clock runs, as under ARNOLDI_PHASES
    import dataclasses

    from arnoldi_tpu_torch.utils.profiling import WallClock

    timed = dataclasses.replace(mesh, clock=WallClock())
    H = halo_matvec_closure(dia, timed)
    for b in (1, 2, 5):
        H.matmat_rows(torch.ones(b, H.shape[0], dtype=H.dtype))
    res["ring_calls"] = np.asarray([timed.clock.counts.get(k, 0) for k in
                                    ("mesh.ring_start", "mesh.ring_wait")])
    res["ring_seconds"] = np.asarray([timed.clock.totals.get(k, 0.0) for k in
                                      ("mesh.ring_start", "mesh.ring_wait")])
    return res


SCENARIOS = {
    "filtered_mesh": scenario_filtered_mesh,
    "matvecs": scenario_matvecs,
    "solves": scenario_solves,
    "eigh_gather": scenario_eigh_gather,
    "eigh_halo": scenario_eigh_halo,
    "checkpoint": scenario_checkpoint,
    "checkpoint_elastic": scenario_checkpoint_elastic,
}


def main():
    scenario, rank, size, port, out = (sys.argv[1], int(sys.argv[2]),
                                       int(sys.argv[3]), int(sys.argv[4]),
                                       sys.argv[5])
    initialize(f"127.0.0.1:{port}", num_processes=size, process_id=rank,
               backend="gloo")
    import torch.distributed as dist

    mesh = make_mesh(size, device="cpu")
    result = SCENARIOS[scenario](mesh, out)
    np.savez(os.path.join(out, f"{scenario}.r{rank}.npz"), **result)
    mesh.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
