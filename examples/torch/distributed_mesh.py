"""Row-partitioned solves over a mesh of two ``torch.distributed`` ranks.

Spawns two processes (one rank each, ``127.0.0.1`` as the coordinator):
NCCL when every rank has a card of its own, gloo otherwise (two ranks on
one card, or ``--device cpu``).  Each rank holds its row block of the
operator and of the basis:

- ``sharded_partial_schur`` of mark(50) (the all-gather of x; n = 1275 is
  padded to the mesh);
- the ring-halo DIA product of laplace(1024) against the whole product;
- ``eigsh_filtered`` over the DIA halo of laplace(1024).

    PYTHONPATH=. python examples/torch/distributed_mesh.py [--device cpu]
"""

import argparse
import multiprocessing
import socket

import numpy as np
import torch


def rank_main(rank, size, port, device_kind):
    from arnoldi_tpu_torch import as_operator, eigsh_filtered
    from arnoldi_tpu_torch.matrices import laplace, laplace_eigen, mark
    from arnoldi_tpu_torch.parallel import (gather_rows, halo_matvec_closure,
                                            make_mesh, sharded_partial_schur)
    from arnoldi_tpu_torch.parallel.multihost import initialize

    torch.set_num_threads(1)
    if device_kind == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(rank % cards)
        backend = "nccl" if cards >= size else "gloo"
    else:
        backend = "gloo"
    initialize(f"127.0.0.1:{port}", size, rank, backend=backend)
    mesh = make_mesh(device=device_kind)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh: {mesh.size} ranks, backend {mesh.backend}, device {mesh.device}")

    # Krylov-Schur with the operator and basis row-partitioned: every
    # projection and norm is summed over the ranks.
    A = mark(50)
    Q, T, hist = sharded_partial_schur(A, 5, mesh=mesh, sort_function="LR",
                                       stopping_criterion=1e-8,
                                       max_restarts=2000)
    Qh, Th = gather_rows(Q, mesh).cpu().numpy(), T.cpu().numpy()
    res = np.linalg.norm(A @ Qh - Qh @ Th, axis=0)
    say(f"sharded partial_schur residuals: {res} ({hist.total_matvecs} matvecs)")
    assert res.max() < 1e-7

    # The ring-halo SpMV: two edge exchanges instead of an all-gather of x.
    L = laplace(1024).tocsr()
    op = as_operator(L, device=mesh.device)
    halo = halo_matvec_closure(op, mesh)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1024))
    row0 = mesh.rank * halo.n_local
    y = halo.matvec(x[row0:row0 + halo.n_local].to(mesh.device))
    err = float(np.abs(gather_rows(y, mesh).cpu().numpy() - L @ x.numpy()).max())
    say(f"halo-exchange SpMV (halo {halo.halo}) max error against the whole "
        f"product: {err:.2e}")
    assert err < 1e-12

    # Interior pairs by Chebyshev filtering over the DIA halo.
    vals, vecs, hist = eigsh_filtered(halo, 4, (-2.2, -1.8), tol=1e-9,
                                      dtype=np.float64)
    full = np.sort(laplace_eigen(1024))
    err = float(np.abs(vals[:, None] - full[None, :]).min(axis=1).max())
    V = gather_rows(vecs, mesh).cpu().numpy()
    res = np.linalg.norm(L @ V - V * vals[None, :], axis=0)
    say(f"eigsh_filtered over the DIA halo: {np.round(vals, 8)}, eigenvalue "
        f"error {err:.2e}, residual {res.max():.2e}, "
        f"{hist.total_matvecs} matvecs")
    assert err < 1e-9 and res.max() < 1e-7
    mesh.barrier()
    import torch.distributed as dist

    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no card; pass --device cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    size = 2
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(rank, size, port, args.device))
             for rank in range(size)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * size, f"ranks exited {codes}"
    print("OK")


if __name__ == "__main__":
    main()
