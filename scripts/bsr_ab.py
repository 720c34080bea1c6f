#!/usr/bin/env python3
"""Time the BSR SpMV kernels of one checkout of ``arnoldi_tpu_torch`` on the card.

    python3 scripts/bsr_ab.py [--repo DIR] [--label NAME] [--matrix M]
                              [--profile] [--library] [--solves] [--cols B]
                              [--dtype D] [--per-pass P] [--time-only]
                              [--save FILE | --against FILE]

Imports ``arnoldi_tpu_torch`` from DIR (default: the checkout that holds this
script), builds its CUDA kernels there, and times the BSR kernel forms,
float64, on one matrix as BSR-8 (``--matrix``, both as ``chip_smoke.py``
builds them):

* ``banded`` (the default): "banded-1024", ``random_scattered(2^20, 24,
  seed=2, bandwidth=1024, block=8)``, whose window fits shared memory:
  ``spmv_bsr_window`` and ``spmv_bsr_window_cols``, and the gather kernel's
  ``spmv_bsr`` and ``spmv_bsr_cols`` on the same matrix;
* ``scattered``: ``random_scattered(2^20, 24, seed=1, bandwidth=2^14,
  block=8)``, whose 4216-block-column window does not fit: the gather
  kernel's ``spmv_bsr`` and ``spmv_bsr_cols``, as solves C and G run them.

b = 8 columns, or ``--cols B``.  ``--dtype complex128`` or ``complex64``
times the complex forms on the matrix with every off-diagonal value times
``e^{i phi}`` (phi uniform on [0, 2 pi) from seed 7: ``chip_smoke.phased``).
``--per-pass P`` also times the window kernel's b-column form with P
columns staged a pass (``bsr_window_matmat(..., per_pass=P)``; two stages
where they fit), bit for bit against the wrapper's plan.  Each form is checked
against its plain version (relative error 1e-12, 1e-5 in complex64), the
window form against the gather form bit
for bit, and every column of each b-column form against its single-column
form bit for bit; then timed as CUDA-event means of 20 back-to-back
launches after 3 warm-up launches.  ``--profile`` adds the profiler's
device time per call; ``--library`` times cuSPARSE's BSR SpMV and SpMM
(``A_bsr @ x``, ``A_bsr @ Xt``) the same ways.  ``--solves`` also runs,
warm, the float64 solves that launch the BSR kernels, as ``chip_smoke.py``
runs them (``partial_schur`` LR, k = 5, m = 40, tol 1e-8): on banded, D
(``block_size=8``) and H (scalar) through the window kernel, then G
(``block_size=8``) and C (scalar) on "scattered" through the gather kernel;
on scattered, G and C only.  For each, the median wall of 3 runs, the
matvecs, and under the profiler one more run's device time (kernel and copy
rows) and the BSR kernels' share of it.  ``--time-only`` skips every check,
for a variant that computes something else on purpose (one that leaves
out its x or block loads, to see what they cost).  ``--save FILE`` keeps
every form's output (``torch.save``); ``--against FILE`` checks each form's
output bit for bit against such a file from another checkout (the inputs
come from fixed seeds), so a change that must keep the bits can be held to
its parent.
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


def time_solves(op_window, op_gather, dtype):
    """Warm walls, matvecs and device split of solves D and H on
    ``op_window`` (None: skipped) and G and C on ``op_gather``."""
    from arnoldi_tpu_torch import partial_schur

    common = {"max_dim": 40, "stopping_criterion": 1e-8, "dtype": dtype,
              "sort_function": "LR", "ortho": "cgs2"}
    runs = {"G": lambda: partial_schur(op_gather, 5, block_size=8, **common),
            "C": lambda: partial_schur(op_gather, 5, **common)}
    if op_window is not None:
        runs = {"D": lambda: partial_schur(op_window, 5, block_size=8, **common),
                "H": lambda: partial_schur(op_window, 5, **common), **runs}
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


def bsr_tensor(A, device, dtype):
    """``A`` as a torch BSR tensor with (8, 8) blocks in ``dtype`` (the
    cuSPARSE yardstick's operand)."""
    import numpy as np
    import torch

    B = A.tobsr(blocksize=(8, 8))
    return torch.sparse_bsr_tensor(
        torch.from_numpy(B.indptr.astype(np.int32)).to(device),
        torch.from_numpy(B.indices.astype(np.int32)).to(device),
        torch.from_numpy(B.data).to(device=device, dtype=dtype), size=B.shape)


def phased(A, seed=7):
    """A with every off-diagonal value times ``e^{i phi}``, phi uniform on
    [0, 2 pi) from ``seed`` (``chip_smoke.phased``)."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    C = sp.coo_matrix(A).astype(np.complex128)
    off = C.row != C.col
    C.data[off] *= np.exp(1j * rng.uniform(0, 2 * np.pi, int(off.sum())))
    return C.tocsr()


MATRICES = {"banded": {"seed": 2, "bandwidth": 1024},
            "scattered": {"seed": 1, "bandwidth": 2**14}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--matrix", choices=sorted(MATRICES), default="banded")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--library", action="store_true")
    ap.add_argument("--solves", action="store_true")
    ap.add_argument("--cols", type=int, default=8)
    ap.add_argument("--dtype", choices=("float64", "float32", "complex128",
                                        "complex64"),
                    default="float64")
    ap.add_argument("--per-pass", type=int, default=0)
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--save", default="")
    ap.add_argument("--against", default="")
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
    banded = args.matrix == "banded"
    dtype = getattr(torch, args.dtype)
    limit = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-12

    def source(name):
        A = matrices.random_scattered(2**20, 24, block=8, **MATRICES[name])
        return A if not dtype.is_complex else phased(A)

    A = source(args.matrix)
    dev = torch.device("cuda")
    op = BsrOperator.from_scipy(A, dtype=dtype, device=dev)
    if op.uses_window != banded:
        raise SystemExit(f"bsr_ab: {args.matrix} should take the "
                         f"{'window' if banded else 'gather'} kernel")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(op.n_cols, generator=gen, device=dev, dtype=dtype)
    X = torch.randn(args.cols, op.n_cols, generator=gen, device=dev, dtype=dtype)
    blk, ids, win, nr = op.blocks, op.block_cols, op.window, op.n_rows
    forms = {
        "spmv_bsr": (lambda: spmv_bsr.bsr_matvec(blk, ids, x, nr),
                     lambda: spmv_bsr.bsr_matvec_plain(blk, ids, x, nr)),
        "spmv_bsr_cols": (lambda: spmv_bsr.bsr_matmat(blk, ids, X, nr),
                          lambda: spmv_bsr.bsr_matvec_plain(blk, ids, X, nr)),
    }
    if banded:
        forms = {
            "spmv_bsr_window": (lambda: spmv_bsr.bsr_window_matvec(blk, win, x, nr),
                                lambda: spmv_bsr.bsr_window_matvec_plain(blk, win, x, nr)),
            "spmv_bsr_window_cols": (
                lambda: spmv_bsr.bsr_window_matmat(blk, win, X, nr),
                lambda: spmv_bsr.bsr_window_matvec_plain(blk, win, X, nr)),
            **forms}
    out = {"label": args.label, "repo": str(Path(args.repo).resolve()),
           "matrix": args.matrix, "dtype": args.dtype, "build_s": build_s,
           "blocks": list(blk.shape),
           "window": win.width, "cols": args.cols}
    got = {}
    for tag, (kernel, plain) in forms.items():
        got[tag], want = kernel(), plain()
        err = float((got[tag] - want).norm() / want.norm())
        if not (err <= limit or args.time_only):
            raise SystemExit(f"bsr_ab: {tag} relative error {err:.3e}")
        out[tag] = {"ms": cuda_ms(kernel), "rel_err": err}
        if args.profile:
            out[tag]["device_ms"] = device_ms(kernel)
    out["gather_columns_equal_single"] = all(
        torch.equal(got["spmv_bsr_cols"][j], spmv_bsr.bsr_matvec(blk, ids, X[j], nr))
        for j in range(X.shape[0]))
    if banded:
        out["window_equals_gather"] = (
            torch.equal(got["spmv_bsr_window"], got["spmv_bsr"])
            and torch.equal(got["spmv_bsr_window_cols"], got["spmv_bsr_cols"]))
        out["columns_equal_single"] = all(
            torch.equal(got["spmv_bsr_window_cols"][j],
                        spmv_bsr.bsr_window_matvec(blk, win, X[j], nr))
            for j in range(X.shape[0]))
    if args.save:
        torch.save({tag: y.cpu() for tag, y in got.items()}, args.save)
    if args.against:
        theirs = torch.load(args.against)
        out["bits_equal_against"] = {tag: torch.equal(y.cpu(), theirs[tag])
                                     for tag, y in got.items()}
    if banded and args.per_pass:
        def call():
            return spmv_bsr.bsr_window_matmat(blk, win, X, nr, per_pass=args.per_pass)

        out[f"spmv_bsr_window_cols_per_pass_{args.per_pass}"] = {
            "ms": cuda_ms(call),
            "equals_wrapper": torch.equal(call(), got["spmv_bsr_window_cols"])}
        if args.profile:
            out[f"spmv_bsr_window_cols_per_pass_{args.per_pass}"]["device_ms"] = \
                device_ms(call)
    if args.library:
        A_bsr, Xt = bsr_tensor(A, dev, dtype), X.T.contiguous()
        for tag, fn in (("cusparse_spmv", lambda: A_bsr @ x),
                        ("cusparse_spmm", lambda: A_bsr @ Xt)):
            out[tag] = {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}
        del A_bsr, Xt
    if args.solves:
        op_gather = op
        if banded:
            op_gather = BsrOperator.from_scipy(source("scattered"), dtype=dtype,
                                               device=dev)
            if op_gather.uses_window:
                raise SystemExit("bsr_ab: the scattered matrix should take the "
                                 "gather kernel")
        out["solves"] = time_solves(op if banded else None, op_gather, dtype)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
