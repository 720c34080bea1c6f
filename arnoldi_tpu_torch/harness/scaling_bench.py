"""Scaling of the Arnoldi hot loop over ranks of ``torch.distributed``.

Counterpart of ``arnoldi_tpu/harness/scaling_bench.py``.  For each rank
count it spawns that many processes on one row mesh (one rank a process,
``127.0.0.1`` as the coordinator), each holding its row block of the same
operator, and times expansion cycles (``max_dim`` steps of
``arnoldi_expand`` with the fused CGS2 pair, the projections all-reduced)
over the ring halo (DIA for ``--matrix laplace``, BSR-8 for ``--matrix
scattered``) or the all-gather of x (``--no-halo``).  It prints one JSON
row a rank count: ms a step, nnz/s, the efficiency of a rank against the
first row's, the backend, the ranks per card, the kernel launches of the
timed cycles summed over the ranks, and what the row measures.
Ranks that share a card, or CPU processes, check the mechanism: their
rows are not scaling numbers.

    python -m arnoldi_tpu_torch.harness.scaling_bench --grid 724 --ranks 1,2
    python -m arnoldi_tpu_torch.harness.scaling_bench --grid 64 --ranks 1,2 --device cpu

The backend is NCCL when every rank has a card of its own and gloo
otherwise.
"""

import argparse
import json
import math
import time

from .suite import add_device_argument, check_device

#: Seconds a row's ranks may take.
ROW_TIMEOUT_S = 600


def _operator(matrix, n_grid, max_ranks, dtype):
    """The SciPy matrix of a run and its format: laplace_2d(n_grid) (DIA),
    or random_scattered(n_grid^2, 8) with columns within a bandwidth that
    fits the largest mesh's shard (BSR-8)."""
    from .. import matrices

    if matrix == "laplace":
        return matrices.laplace_2d(n_grid).astype(dtype), None, 1
    if matrix == "scattered":
        n = n_grid * n_grid
        bw = max(n // (4 * max_ranks), 8)
        return (matrices.random_scattered(n, 8, seed=0, bandwidth=bw, dtype=dtype),
                ("bsr", (8, 8)), 8)
    raise ValueError(f"matrix={matrix!r}: expected laplace|scattered")


def _rank_main(rank, size, port, cfg, queue):
    """One rank of a row: build the shard, run ``cfg["cycles"]`` timed
    cycles after one warm cycle, put ``(rank, result)`` on ``queue``."""
    import numpy as np
    import torch

    from ..linop import as_operator, pad_operator
    from ..ops import kernels
    from ..parallel import halo_matvec_closure, make_mesh, shard_operator
    from ..parallel.multihost import initialize
    from ..parallel.sharded import start_rows
    from ..solvers.decomposition import arnoldi_expand
    from ..utils.random import rand_normalized_vector

    torch.set_num_threads(1)
    if cfg["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    if size > 1:
        initialize(f"127.0.0.1:{port}", size, rank, backend=cfg["backend"])
    mesh = make_mesh(device=device)
    A, fmt, gran = _operator(cfg["matrix"], cfg["grid"], cfg["max_ranks"],
                             np.dtype(cfg["dtype"]))
    op = as_operator(A, format=fmt, device=device)
    n = op.shape[0]
    n_pad = -(-n // (size * gran)) * (size * gran)
    op = pad_operator(op, n_pad)
    op = halo_matvec_closure(op, mesh) if cfg["halo"] else shard_operator(op, mesh)
    m = cfg["max_dim"]
    dt = op.dtype
    H = torch.zeros((m + 1, m), dtype=dt, device=device)
    Vt = torch.zeros((m + 1, op.shape[0]), dtype=dt, device=device)

    def cycle(seed):
        v0 = rand_normalized_vector(n_pad, dt, device="cpu",
                                    generator=torch.Generator().manual_seed(seed))
        Vt[0] = start_rows(v0, None, n_pad, mesh)[0]
        arnoldi_expand(op, Vt, H, 1e-6, max_dim=m, ortho="cgs2", mesh=mesh,
                       stop_at_breakdown=False)
        return float(H.abs().sum())       # a host read ends the cycle

    cycle(0)
    kernels.reset_launch_counts()
    mesh.barrier()
    t0 = time.perf_counter()
    acc = 0.0
    for i in range(cfg["cycles"]):
        acc += cycle(77 + i)
    per_step = (time.perf_counter() - t0) / (cfg["cycles"] * m)
    queue.put((rank, {"per_step": per_step, "nnz": int(A.nnz), "n": n,
                      "kernel": op.kernel, "backend": mesh.backend,
                      "launches": {k: v for k, v in kernels.launch_counts().items()
                                   if v},
                      "exchange_bytes": op.exchange_bytes(), "checksum": acc}))
    if size > 1:
        import torch.distributed as dist

        mesh.barrier()
        dist.destroy_process_group()


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_row(size, cfg):
    """Spawn the ``size`` ranks of one row; their results in rank order."""
    import multiprocessing
    import queue as queue_mod

    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(rank, size, port, cfg, q))
             for rank in range(size)]
    for p in procs:
        p.start()
    results, t0 = {}, time.perf_counter()
    try:
        while len(results) < size:
            try:
                rank, out = q.get(timeout=2)
                results[rank] = out
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"a rank of the {size}-rank row exited "
                                       f"{dead[0]}")
                if time.perf_counter() - t0 > ROW_TIMEOUT_S:
                    raise RuntimeError(f"the {size}-rank row outlived "
                                       f"{ROW_TIMEOUT_S} s")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(size)]


def run_scaling(n_grid=256, rank_counts=(1, 2), max_dim=40, cycles=2,
                dtype="float32", matrix="laplace", halo=True, device="cuda"):
    """The rows of a run (see the module docstring), one a rank count."""
    import torch

    cards = torch.cuda.device_count() if device == "cuda" else 0
    if device == "cuda":
        from ..ops.kernels import _build

        _build.build()          # once here, loaded by every rank
    results = []
    for size in rank_counts:
        per_card = math.ceil(size / cards) if cards else None
        cfg = dict(device=device, matrix=matrix, grid=n_grid,
                   backend="nccl" if device == "cuda" and per_card == 1 else "gloo",
                   max_ranks=max(rank_counts), dtype=dtype, max_dim=max_dim,
                   cycles=cycles, halo=halo)
        ranks = _run_row(size, cfg)
        per_step = max(r["per_step"] for r in ranks)     # the slowest rank
        r0 = ranks[0]
        if device == "cpu":
            what = "CPU processes: a mechanism check, not a scaling number"
        elif per_card > 1:
            what = (f"{per_card} ranks share a card: a mechanism check, not a "
                    "scaling number")
        else:
            what = "one card a rank"
        results.append({
            "ranks": size,
            "backend": r0["backend"] or "none (one rank)",
            "device": device,
            "ranks_per_card": per_card,
            "kernel": r0["kernel"],
            "n": r0["n"],
            "exchange_bytes_per_matvec": r0["exchange_bytes"],
            "ms_per_step": round(per_step * 1e3, 4),
            "nnz_per_s": round(r0["nnz"] / per_step, 0),
            "launches": {k: sum(r["launches"].get(k, 0) for r in ranks)
                         for k in sorted({k for r in ranks for k in r["launches"]})},
            "measurement": what,
        })
    if results:
        base = results[0]["nnz_per_s"] / results[0]["ranks"]
        for r in results:
            r["efficiency"] = round((r["nnz_per_s"] / r["ranks"]) / base, 4)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--ranks", default="1,2")
    ap.add_argument("--max-dim", type=int, default=40)
    ap.add_argument("--matrix", default="laplace",
                    choices=("laplace", "scattered"))
    ap.add_argument("--no-halo", action="store_true",
                    help="the all-gather of x instead of the ring halo")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)

    counts = tuple(int(x) for x in args.ranks.split(","))
    results = run_scaling(n_grid=args.grid, rank_counts=counts,
                          max_dim=args.max_dim, matrix=args.matrix,
                          halo=not args.no_halo, device=device)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
