#!/usr/bin/env python3
"""Time the BSR SpMV kernels of one checkout of ``arnoldi_tpu_torch`` on the card.

    python3 scripts/bsr_ab.py [--repo DIR] [--label NAME] [--profile] [--solves]
                              [--cols B]

Imports ``arnoldi_tpu_torch`` from DIR (default: the checkout that holds this
script), builds its CUDA kernels there, and times the four BSR kernel forms,
float64, on "banded-1024" (``random_scattered(2^20, 24, seed=2,
bandwidth=1024, block=8)`` as BSR-8, the window kernel's matrix in
``chip_smoke.py``): ``spmv_bsr_window`` and ``spmv_bsr_window_cols`` (b = 8,
or ``--cols B``),
and the gather kernel's ``spmv_bsr`` and ``spmv_bsr_cols`` on the same
matrix.  Each is checked against its plain version (relative error 1e-12),
the window form against the gather form bit for bit, and the columns of the
b-column window form against the single-column window kernel bit for bit;
then timed as CUDA-event means of 20 back-to-back launches after 3 warm-up
launches.  ``--profile`` adds the profiler's device time per call.
``--solves`` also runs, warm, the float64 solves that launch the BSR
kernels, as ``chip_smoke.py`` runs them (``partial_schur`` LR, k = 5,
m = 40, tol 1e-8): D (``block_size=8``) and H (scalar) on banded-1024
through the window kernel, and G (``block_size=8``) and C (scalar) on
"scattered" (``seed=1, bandwidth=2^14``) through the gather kernel; for
each, the median wall of 3 runs, the matvecs, and under the profiler one
more run's device time (kernel and copy rows) and the BSR kernel's share
of it.
Prints one JSON line, with the card's name and power limit.  To compare two
checkouts on one card, run it for each in one call, in turns (A B B A).
Needs a card; exits nonzero without one.
"""

import argparse
import json
import statistics
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
    """Profiler device time per call: the kernels ``fn`` launched, summed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(ev.time_range.elapsed_us() for ev in prof.events()
             if ev.device_type == DeviceType.CUDA)
    return us / 1e3 / reps


def device_split(fn):
    """``(device ms, BSR kernels' device ms, wall ms)`` of one profiled call
    of ``fn``: self device time summed over the profiler's rows, so each
    kernel and copy counts once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    total = bsr = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = ev.self_cuda_time_total if us is None else us
        total += us
        if "spmv_bsr" in ev.key:
            bsr += us
    return total / 1e3, bsr / 1e3, 1e3 * wall


def time_solves(op_window, op_gather):
    """Warm walls, matvecs and device split of solves D and H on
    ``op_window`` and G and C on ``op_gather``."""
    import torch

    from arnoldi_tpu_torch import partial_schur

    common = {"max_dim": 40, "stopping_criterion": 1e-8, "dtype": torch.float64,
              "sort_function": "LR", "ortho": "cgs2"}
    runs = {"D": lambda: partial_schur(op_window, 5, block_size=8, **common),
            "H": lambda: partial_schur(op_window, 5, **common),
            "G": lambda: partial_schur(op_gather, 5, block_size=8, **common),
            "C": lambda: partial_schur(op_gather, 5, **common)}
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
        dev, bsr, wall_ms = device_split(fn)
        out[label] = {"wall_s": statistics.median(walls), "walls_s": walls,
                      "matvecs": hist.total_matvecs, "device_ms": dev,
                      "bsr_device_ms": bsr, "profiled_wall_ms": wall_ms}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--solves", action="store_true")
    ap.add_argument("--cols", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bsr_ab: no CUDA card")
    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.linop import BsrOperator
    from arnoldi_tpu_torch.ops import kernels
    from arnoldi_tpu_torch.ops.kernels import spmv_bsr

    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    A = matrices.random_scattered(2**20, 24, seed=2, bandwidth=1024, block=8)
    dev = torch.device("cuda")
    op = BsrOperator.from_scipy(A, device=dev)
    if not op.uses_window:
        raise SystemExit("bsr_ab: banded-1024 should take the window kernel")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(op.n_cols, generator=gen, device=dev, dtype=torch.float64)
    X = torch.randn(args.cols, op.n_cols, generator=gen, device=dev, dtype=torch.float64)
    blk, ids, win, nr = op.blocks, op.block_cols, op.window, op.n_rows
    forms = {
        "spmv_bsr_window": (lambda: spmv_bsr.bsr_window_matvec(blk, win, x, nr),
                            lambda: spmv_bsr.bsr_window_matvec_plain(blk, win, x, nr)),
        "spmv_bsr_window_cols": (lambda: spmv_bsr.bsr_window_matmat(blk, win, X, nr),
                                 lambda: spmv_bsr.bsr_window_matvec_plain(blk, win, X, nr)),
        "spmv_bsr": (lambda: spmv_bsr.bsr_matvec(blk, ids, x, nr),
                     lambda: spmv_bsr.bsr_matvec_plain(blk, ids, x, nr)),
        "spmv_bsr_cols": (lambda: spmv_bsr.bsr_matmat(blk, ids, X, nr),
                          lambda: spmv_bsr.bsr_matvec_plain(blk, ids, X, nr)),
    }
    out = {"label": args.label, "repo": str(Path(args.repo).resolve()),
           "build_s": build_s, "blocks": list(blk.shape), "window": win.width,
           "cols": args.cols}
    got = {}
    for tag, (kernel, plain) in forms.items():
        got[tag], want = kernel(), plain()
        err = float((got[tag] - want).norm() / want.norm())
        if not err <= 1e-12:
            raise SystemExit(f"bsr_ab: {tag} relative error {err:.3e}")
        out[tag] = {"ms": cuda_ms(kernel), "rel_err": err}
        if args.profile:
            out[tag]["device_ms"] = device_ms(kernel)
    out["window_equals_gather"] = (
        torch.equal(got["spmv_bsr_window"], got["spmv_bsr"])
        and torch.equal(got["spmv_bsr_window_cols"], got["spmv_bsr_cols"]))
    out["columns_equal_single"] = all(
        torch.equal(got["spmv_bsr_window_cols"][j],
                    spmv_bsr.bsr_window_matvec(blk, win, X[j], nr))
        for j in range(X.shape[0]))
    if args.solves:
        A = matrices.random_scattered(2**20, 24, seed=1, bandwidth=2**14, block=8)
        op_gather = BsrOperator.from_scipy(A, device=dev)
        if op_gather.uses_window:
            raise SystemExit("bsr_ab: the scattered matrix should take the gather kernel")
        out["solves"] = time_solves(op, op_gather)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
