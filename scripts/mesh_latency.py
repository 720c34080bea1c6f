#!/usr/bin/env python3
"""Latency of the collectives two ranks sharing one NVIDIA card pay.

    python3 scripts/mesh_latency.py [--steps N]

Two spawned processes on ``cuda:0`` join a gloo group and time, per call
(mean of N after a warm-up): a sum all-reduce of an 81-entry float64
vector held on the card (into gloo directly), the same as an all-gather
summed in rank order, staged through a pinned host buffer, and of a host
tensor; the ring's exchange of 724-entry host halos (two messages each
way, and one); a step of small kernels
followed by ``torch.cuda.synchronize()`` with no communication (both ranks
at once); and that step followed by one all-reduce of the card vector.
One process alone times the same step, to show what sharing the card
costs.  Prints one line per measurement and the card's name and power
limit.
"""

import argparse
import multiprocessing
import socket
import subprocess
import time


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _step(Vt, w):
    import torch

    c = Vt @ w                     # the projection's gemv
    w2 = w - c @ Vt                # the update
    return c, torch.dot(w2, w2)


def _rank(rank, port, steps, queue):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    dev = torch.device("cuda", 0)
    t = torch.ones(81, dtype=torch.float64, device=dev)
    h = torch.ones(81, dtype=torch.float64)
    Vt = torch.randn(81, 262088, dtype=torch.float64, device=dev) / 512
    w = torch.randn(262088, dtype=torch.float64, device=dev)

    def timed(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps

    def staged():
        buf = torch.empty(81, dtype=torch.float64, pin_memory=True)
        buf.copy_(t)
        dist.all_reduce(buf)
        t.copy_(buf)

    def step_only():
        _step(Vt, w)
        torch.cuda.synchronize()

    def step_reduce():
        c, _ = _step(Vt, w)
        dist.all_reduce(c)

    def gathered():
        parts = [torch.empty_like(t) for _ in range(2)]
        dist.all_gather(parts, t)
        return parts[0] + parts[1]

    peer = 1 - rank
    sends = [torch.ones(724, dtype=torch.float64) for _ in range(2)]
    recvs = [torch.empty(724, dtype=torch.float64) for _ in range(2)]

    def exchange(k):
        ops = ([dist.P2POp(dist.isend, sends[i], peer, tag=i) for i in range(k)]
               + [dist.P2POp(dist.irecv, recvs[i], peer, tag=i) for i in range(k)])
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    out = {"all_reduce card tensor (gloo direct)": timed(lambda: dist.all_reduce(t)),
           "exchange of host halos, 2 sends 2 receives": timed(lambda: exchange(2)),
           "exchange of host halos, 1 send 1 receive": timed(lambda: exchange(1)),
           "all_gather card tensor, summed in rank order": timed(gathered),
           "all_reduce via a pinned buffer": timed(staged),
           "all_reduce host tensor": timed(lambda: dist.all_reduce(h)),
           "step, no communication (both ranks)": timed(step_only),
           "step + all_reduce of its coefficients": timed(step_reduce)}
    dist.destroy_process_group()
    queue.put((rank, out))


def main():
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=500)
    steps = parser.parse_args().steps
    if not torch.cuda.is_available():
        raise SystemExit("mesh_latency: needs a card")
    ctx = multiprocessing.get_context("spawn")
    queue, port = ctx.Queue(), _port()
    procs = [ctx.Process(target=_rank, args=(r, port, steps, queue)) for r in range(2)]
    for p in procs:
        p.start()
    res = dict(queue.get(timeout=600) for _ in procs)
    for p in procs:
        p.join()
    dev = torch.device("cuda", 0)
    Vt = torch.randn(81, 262088, dtype=torch.float64, device=dev) / 512
    w = torch.randn(262088, dtype=torch.float64, device=dev)
    for _ in range(20):
        _step(Vt, w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        _step(Vt, w)
        torch.cuda.synchronize()
    alone = 1e3 * (time.perf_counter() - t0) / steps
    for name in res[0]:
        print(f"{name}: rank 0 {res[0][name]:.4f} ms, rank 1 {res[1][name]:.4f} ms")
    print(f"step, no communication, one process alone: {alone:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
