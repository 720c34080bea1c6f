#!/usr/bin/env python3
"""Time the fused CGS2 passes of one checkout of ``arnoldi_tpu_torch`` on the card.

    python3 scripts/ortho_ab.py [--repo DIR] [--label NAME] [--save FILE]
                                [--against FILE] [--time-only]

Imports ``arnoldi_tpu_torch`` from DIR (default: the checkout that holds this
script), builds its CUDA kernels there, and times ``masked_project`` and
``project_update_norm`` in float64 at the main path's shape (Vt (81,
524176), as solve A runs them: 80 active rows), each checked against its
plain version (relative error 1e-12): CUDA-event means of 20 back-to-back
calls after 3 warm-up calls, and the profiler's device time per call.
cuBLAS's gemv (``Vt[:k] @ w``), the one PyTorch call for
``masked_project``'s function, is timed the same two ways.

``--save FILE`` writes ``masked_project``'s outputs at n_active 0, 1, 7, 40, 80
and 81 (float64 and float32, inputs from a seeded generator on the card)
with ``torch.save``; ``--against FILE`` compares this checkout's outputs with
such a file bit for bit (run the two checkouts in turn, the first with
``--save``).  ``--time-only`` skips the error check (for timing variants
that compute something else).  Prints one JSON line, with the card's name and power limit.
Needs a card; exits nonzero without one.
"""

import argparse
import json
import subprocess
import sys
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--label", default="")
    ap.add_argument("--save")
    ap.add_argument("--against")
    ap.add_argument("--time-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.repo).resolve()))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ortho_ab: no CUDA card")
    from arnoldi_tpu_torch.ops import kernels
    from arnoldi_tpu_torch.ops.kernels import ortho_fused

    kernels.build()
    dev = torch.device("cuda")
    n, mp1, na = 524_176, 81, 80
    out = {"label": args.label, "repo": str(Path(args.repo).resolve())}
    outputs = {}
    for dtype in (torch.float64, torch.float32):
        gen = torch.Generator(device=dev).manual_seed(1)
        Vt = torch.randn(mp1, n, generator=gen, device=dev, dtype=dtype) / n ** 0.5
        w = torch.randn(n, generator=gen, device=dev, dtype=dtype)
        for k in (0, 1, 7, 40, 80, 81):
            outputs[f"{dtype}-{k}"] = ortho_fused.masked_project(Vt, w, k).cpu()
        if dtype != torch.float64:
            continue
        c_plain = ortho_fused.masked_project_plain(Vt, w, na)
        forms = {
            "masked_project": (lambda: ortho_fused.masked_project(Vt, w, na),
                               lambda: c_plain),
            "project_update_norm": (
                lambda: ortho_fused.project_update_norm(Vt, w, c_plain, na)[0],
                lambda: ortho_fused.project_update_norm_plain(Vt, w, c_plain, na)[0]),
        }
        for tag, (kernel, plain) in forms.items():
            got, want = kernel(), plain()
            err = float((got - want).norm() / want.norm())
            if not (err <= 1e-12 or args.time_only):
                raise SystemExit(f"ortho_ab: {tag} relative error {err:.3e}")
            out[tag] = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
                        "rel_err": err}
        Va = Vt[:na]
        out["cublas_gemv"] = {"ms": cuda_ms(lambda: Va @ w),
                              "device_ms": device_ms(lambda: Va @ w)}
    if args.save:
        torch.save(outputs, args.save)
    if args.against:
        ref = torch.load(args.against)
        out["bit_equal_to_saved"] = all(torch.equal(outputs[k], ref[k]) for k in ref)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
