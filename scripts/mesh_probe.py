#!/usr/bin/env python3
"""What torch.distributed does with ranks that share one NVIDIA card.

    python3 scripts/mesh_probe.py

Three probes, each two spawned processes on ``cuda:0`` over a localhost
rendezvous, each given 90 s before it is killed:

* gloo with CUDA tensors passed straight in: ``all_reduce`` and
  ``all_gather`` (the collectives ``parallel.Mesh`` stages through pinned
  host buffers on gloo);
* gloo ``isend``/``irecv`` of CUDA tensors (the ring exchange), in its own
  pair of processes, since it may crash them;
* NCCL with both ranks on the one card.

Prints each probe's outcome per rank (the values it computed, or the
exception's text) and the card's name and power limit.
"""

import multiprocessing
import socket
import subprocess
import sys
import traceback


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _probe(kind, rank, port, queue):
    import torch
    import torch.distributed as dist

    try:
        torch.cuda.set_device(0)
        backend = "nccl" if kind == "nccl" else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=2, rank=rank)
        t = torch.full((4,), float(rank + 1), device="cuda")
        if kind == "p2p":
            recv = torch.empty_like(t)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, t, 1 - rank),
                dist.P2POp(dist.irecv, recv, 1 - rank)])
            for r in reqs:
                r.wait()
            out = f"received {recv.cpu().tolist()}"
        else:
            dist.all_reduce(t)
            parts = [torch.empty_like(t) for _ in range(2)]
            dist.all_gather(parts, torch.full((4,), float(rank), device="cuda"))
            torch.cuda.synchronize()
            out = (f"all_reduce {t.cpu().tolist()}, all_gather "
                   f"{[p.cpu().tolist() for p in parts]}")
        dist.destroy_process_group()
        queue.put((rank, "ok: " + out))
    except Exception as e:       # the probe's finding: report it
        queue.put((rank, f"{type(e).__name__}: {e}\n"
                         + "".join(traceback.format_exc().splitlines(True)[-3:])))


def run(kind):
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), _port()
    procs = [ctx.Process(target=_probe, args=(kind, r, port, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=90)
    outcome = {}
    while not queue.empty():
        rank, msg = queue.get()
        outcome[rank] = msg
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
            p.join()
            outcome.setdefault(r, "killed after 90 s (no answer)")
        outcome.setdefault(r, f"exited {p.exitcode} without a report")
    for r in range(2):
        print(f"{kind} rank {r}: {outcome[r]}")
    sys.stdout.flush()


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("mesh_probe: needs a card")
    print(f"torch {torch.__version__}, NCCL {torch.cuda.nccl.version()}")
    for kind in ("gloo", "p2p", "nccl"):
        run(kind)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
