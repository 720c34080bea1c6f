#!/usr/bin/env python3
"""Time the ELL SpMV kernels of one checkout of ``arnoldi_tpu_torch`` on the card.

    python3 scripts/ell_ab.py [--repo DIR] [--label NAME] [--profile]
                              [--matrix scattered|S|both] [--solves]

Imports ``arnoldi_tpu_torch`` from DIR (default: the checkout that holds this
script), builds its CUDA kernels there, and times ``spmv_ell`` and
``spmv_ell_cols`` (b = 8), float64, on the scattered 2^20-row matrix
(``random_scattered(2^20, 24, seed=1, bandwidth=2^14, block=8)``, ELL L = 25)
and on its symmetrization S (``edge="reflect"``, L = 129), each checked
against the plain version: CUDA-event means of 20 back-to-back launches after
3 warm-up launches.  ``--profile`` adds the profiler's device time per call.
``--solves`` also runs the float64 solves that launch these kernels, warm
(as ``chip_smoke.py`` runs them: B ``partial_schur`` LR and F the same at
``block_size=8`` on the scattered matrix; K ``partial_eigh`` LA with
``ortho="selective"`` and J at ``block_size=8`` on S; k = 5, m = 40, tol
1e-8): the median wall of 3 runs, the matvecs, and under the profiler one
more run's device time (kernel and copy rows) and the ELL kernels' share of
it.  Prints one JSON line, with the card's name and power limit.  To compare two
checkouts on one card, run it for each in one call, in turns (A B B A).
Needs a card; exits nonzero without one.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def cuda_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps=20):
    """Profiler device time per call of the kernels whose name holds
    ``spmv_ell``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if "spmv_ell" in ev.key:
            total += getattr(ev, "device_time_total", None) or ev.cuda_time_total
    return total / 1e3 / reps


def device_split(fn):
    """``(device ms, ELL kernels' device ms, wall ms)`` of one profiled
    call of ``fn``: self device time summed over the profiler's rows, so
    each kernel and copy counts once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = ell = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        total += us
        if "spmv_ell" in ev.key:
            ell += us
    return total / 1e3, ell / 1e3, 1e3 * wall


def time_solves(name, op):
    """Warm walls, matvecs and device split of the solves on ``op``."""
    import statistics

    import torch

    from arnoldi_tpu_torch import partial_eigh, partial_schur

    common = {"max_dim": 40, "stopping_criterion": 1e-8, "dtype": torch.float64}
    if name == "scattered":
        runs = {"B": lambda: partial_schur(op, 5, sort_function="LR", ortho="cgs2",
                                           **common),
                "F": lambda: partial_schur(op, 5, sort_function="LR", ortho="cgs2",
                                           block_size=8, **common)}
    else:
        runs = {"K": lambda: partial_eigh(op, 5, which="LA", ortho="selective",
                                          **common),
                "J": lambda: partial_eigh(op, 5, which="LA", block_size=8, **common)}
    out = {}
    for label, fn in runs.items():
        hist = fn()[-1]                     # warm-up: libraries, workspaces
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        dev, ell, wall_ms = device_split(fn)
        out[label] = {"wall_s": statistics.median(walls), "walls_s": walls,
                      "matvecs": hist.total_matvecs, "device_ms": dev,
                      "ell_device_ms": ell, "profiled_wall_ms": wall_ms}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--matrix", choices=("scattered", "S", "both"), default="both")
    ap.add_argument("--solves", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ell_ab: no CUDA card")
    from arnoldi_tpu_torch.linop import EllOperator
    from arnoldi_tpu_torch.ops import kernels
    from arnoldi_tpu_torch.ops.kernels import spmv_ell

    try:
        from arnoldi_tpu_torch import matrices
    except ImportError:   # checkouts from before the port owned its host modules
        from arnoldi_tpu_torch._host import matrices

    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    mats = {}
    if args.matrix in ("scattered", "both"):
        mats["scattered"] = matrices.random_scattered(2**20, 24, seed=1,
                                                      bandwidth=2**14, block=8)
    if args.matrix in ("S", "both"):
        R = matrices.random_scattered(2**20, 24, seed=1, bandwidth=2**14, block=8,
                                      edge="reflect")
        mats["S"] = ((R + R.T) / 2).tocsr()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"label": args.label, "repo": str(Path(args.repo).resolve()),
           "build_s": build_s}
    for name, M in mats.items():
        op = EllOperator.from_scipy(M, device=dev)
        x = torch.randn(op.shape[1], generator=gen, device=dev, dtype=torch.float64)
        X = torch.randn(8, op.shape[1], generator=gen, device=dev, dtype=torch.float64)
        res = {"L": op.data.shape[1], "nnz": op.nnz}
        for tag, kernel, plain in (
                ("spmv_ell", lambda: spmv_ell.ell_matvec(op.data, op.cols, x),
                 lambda: spmv_ell.ell_matvec_plain(op.data, op.cols, x)),
                ("spmv_ell_cols", lambda: spmv_ell.ell_matmat(op.data, op.cols, X),
                 lambda: spmv_ell.ell_matvec_plain(op.data, op.cols, X))):
            got, want = kernel(), plain()
            err = float((got - want).norm() / want.norm())
            if not err <= 1e-12:
                raise SystemExit(f"ell_ab: {name} {tag} relative error {err:.3e}")
            res[tag] = {"ms": cuda_ms(kernel), "rel_err": err}
            if args.profile:
                res[tag]["device_ms"] = device_ms(kernel)
        if args.solves:
            res["solves"] = time_solves(name, op)
        out[name] = res
        del op, x, X
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
