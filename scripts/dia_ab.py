#!/usr/bin/env python3
"""A/B timing of the DIA SpMV kernels of checkouts of ``arnoldi_tpu_torch`` on one card.

    python3 scripts/dia_ab.py --checkout parent=build/parent --checkout new=. \\
        [--order ABBA] [--solves] [--out build/dia_ab.json]
    python3 scripts/dia_ab.py --worker --repo DIR [--solves] [--cpu]

The first form runs each checkout in a subprocess of its own (``--worker``),
in turns (``ABBA``: A, B, B, A; with three checkouts A B C C B A), and
prints, for every DIA form, each checkout's median event time, cold device
time and host enqueue time with their spread over its turns, whether the
checkouts' outputs have the same SHA-256, and the library call's times; the
full records go to ``--out``.  A worker imports ``arnoldi_tpu_torch`` from
``DIR``, builds its kernels there, and for every form:

- checks the kernel against its plain version (normwise 1e-12 in float64
  and complex128, 1e-5 in float32 and complex64);
- hashes the output's bytes (SHA-256; the inputs come from one seed);
- ``ev_ms``: CUDA events around 100 back-to-back launches, after 10;
- ``dev_ms``: the profiler's device time a call over copies of the inputs
  that pass twice the 50 MB L2 together (as a solve finds them: cold);
- ``enqueue_us``: the host clock over 1000 calls (100 for b > 8), read
  before the synchronize: the time the wrapper takes to issue a launch;
- the same three for the one PyTorch call computing the same function
  (cuSPARSE through ``torch.sparse``: ``A_csr @ x``, ``A_csr @ Xt``).

The forms are the DIA shapes of ``chip_smoke.py``'s main path:
laplace_2d(724) (5 bands, n = 524,176) at b = 1 in float64, float32,
complex128 and complex64 and at b = 8 in float64, complex128 and complex64;
the pencil's one-band lumped mass matrix at b = 1 and 5; laplace_3d(64) (7
bands, n = 262,144) at the filter's b = 297 and at 8k + 3 = 299, float64;
and the shard form on rank 1 of the 2-rank ring halo of laplace_2d(724)
(262,088 rows against a 263,536-entry window, h = 724) at b = 1 in float64
and complex128 and at b = 8 in float64.  ``--solves`` also times, warm
(one run first, then one timed, ending in a synchronize), the two solves
whose walls the single-column launch path paces: A, ``partial_schur`` on
laplace_2d(724) (LM, k = 5, m = 80, tol 1e-8, cgs2), and X, ``eigsh`` on
it at ``sigma=0.01`` with CG inner solves (ncv = 40), with A's matvecs.
``--cpu`` rehearses
a worker on the CPU at small sizes (checks and hashes, no times).  Prints
the card's name and power limit.  Needs a card otherwise; exits nonzero
without one.
"""

import argparse
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

L2_BYTES = 50 * 2**20


def sync():
    import torch

    torch.cuda.synchronize()


def cuda_ms(fn, reps=100, warmup=10):
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


def enqueue_us(fn, calls):
    """Host microseconds a call takes to issue ``fn`` (no synchronize
    inside the timed loop)."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    sync()
    return us


def device_ms(fn, reps=20):
    """Mean profiler device time of ``fn()`` a call (kernels and copies);
    None when the profiler recorded no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        us = sum(ev.time_range.elapsed_us() for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / reps
    return None


def nbytes(t):
    import torch

    if t.layout == torch.sparse_csr:
        return sum(nbytes(u) for u in (t.values(), t.col_indices(), t.crow_indices()))
    return t.numel() * t.element_size()


def cold(fn, *inputs):
    """``fn`` over copies of ``inputs`` that pass twice the L2 together."""
    import itertools

    per = sum(nbytes(t) for t in inputs)
    copies = [inputs] + [tuple(t.clone() for t in inputs)
                         for _ in range(-(-2 * L2_BYTES // per))]
    turn = itertools.cycle(copies)
    return lambda: fn(*next(turn))


def csr(A, dtype, device):
    import numpy as np
    import torch

    A = A.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int32)).to(device),
        torch.from_numpy(A.indices.astype(np.int32)).to(device),
        torch.from_numpy(A.data).to(device=device, dtype=dtype), size=A.shape)


def window_csr(A, row0, row1, halo):
    """Rows [row0, row1) of ``A`` over the columns [row0 - halo, row1 +
    halo), as SciPy CSR: the shard's product as one CSR matrix."""
    import scipy.sparse as sp

    B = sp.coo_matrix(A.tocsr()[row0:row1])
    return sp.csr_matrix((B.data, (B.row, B.col - row0 + halo)),
                         shape=(row1 - row0, row1 - row0 + 2 * halo))


def forms(args, dev):
    """``(name, dtype, kernel(bands, X), plain(), inputs, library matrix
    (SciPy), rhs)`` for every form, built lazily."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.linop import BandedOperator, cast_operator
    from arnoldi_tpu_torch.ops.kernels import spmv_banded as sb
    from arnoldi_tpu_torch.parallel import Mesh, halo_matvec_closure

    side, side3, n_b = (40, 8, 45) if args.cpu else (724, 64, 297)
    gen = torch.Generator(device=dev).manual_seed(0)
    lap = matrices.laplace_2d(side)
    lap3 = matrices.laplace_3d(side3)
    mass = sp.diags(np.random.default_rng(9).uniform(0.5, 1.5, lap.shape[0])).tocsr()
    cases = [("dia", lap, dt, 1) for dt in (torch.float64, torch.float32,
                                            torch.complex128, torch.complex64)]
    cases += [("dia", lap, dt, 8) for dt in (torch.float64, torch.complex128,
                                             torch.complex64)]
    cases += [("mass", mass, torch.float64, 1), ("mass", mass, torch.float64, 5),
              ("3d", lap3, torch.float64, n_b), ("3d", lap3, torch.float64, n_b + 2)]
    for tag, A, dtype, b in cases:
        op = cast_operator(BandedOperator.from_scipy(A, device=dev), dtype)
        n = op.shape[0]
        X = torch.randn((n,) if b == 1 else (b, n), generator=gen, device=dev,
                        dtype=dtype)
        wrap = sb.banded_matvec if b == 1 else sb.banded_matmat

        def kernel(bands, X, wrap=wrap, offsets=op.offsets):
            return wrap(bands, X, offsets)

        def plain(op=op, X=X):
            return sb.banded_matvec_plain(op.bands, X, op.offsets)

        yield (f"{tag} b={b} {str(dtype)[6:]}", dtype, kernel, plain,
               (op.bands, X), A, X if b == 1 else X.T.contiguous())
    square = BandedOperator.from_scipy(lap, device=dev)
    for dtype, b in ((torch.float64, 1), (torch.complex128, 1), (torch.float64, 8)):
        local = halo_matvec_closure(cast_operator(square, dtype),
                                    Mesh(None, 1, 2, dev)).local
        h, n_local = local.x_base, local.bands.shape[1]
        width = n_local + 2 * h
        X = torch.randn((width,) if b == 1 else (b, width), generator=gen,
                        device=dev, dtype=dtype)
        wrap = sb.banded_matvec_ext if b == 1 else sb.banded_matmat_ext

        def kernel(bands, X, wrap=wrap, offsets=local.offsets, h=h):
            return wrap(bands, X, offsets, x_base=h)

        def plain(local=local, X=X, h=h):
            return sb.banded_matvec_ext_plain(local.bands, X, local.offsets, x_base=h)

        yield (f"ext b={b} {str(dtype)[6:]}", dtype, kernel, plain,
               (local.bands, X), window_csr(lap, n_local, 2 * n_local, h),
               X if b == 1 else X.T.contiguous())


def worker(args):
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    dev = torch.device("cpu" if args.cpu else "cuda")
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("dia_ab: no CUDA card")
    import arnoldi_tpu_torch
    from arnoldi_tpu_torch.ops import kernels

    here = Path(arnoldi_tpu_torch.__file__).resolve()
    if Path(args.repo).resolve() not in here.parents:
        raise SystemExit(f"dia_ab: imported {here}, not from {args.repo}")
    t0 = time.perf_counter()
    if not args.cpu:
        kernels.build()
    out = {"repo": str(Path(args.repo).resolve()), "build_s": time.perf_counter() - t0,
           "forms": {}}
    for name, dtype, kernel, plain, inputs, A, rhs in forms(args, dev):
        got, want = kernel(*inputs), plain()
        limit = 1e-12 if dtype in (torch.float64, torch.complex128) else 1e-5
        err = float((got - want).norm() / want.norm())
        if not err <= limit:
            raise SystemExit(f"dia_ab: {name}: relative error {err:.3e} > {limit:g}")
        rec = {"rel_err": err,
               "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()}
        if not args.cpu:
            W = csr(A, dtype, dev)

            def library(W, rhs):
                return W @ rhs

            calls = 1000 if got.ndim == 1 or got.shape[0] <= 8 else 100
            fn = lambda: kernel(*inputs)          # noqa: E731
            lib = lambda: library(W, rhs)         # noqa: E731
            rec.update(ev_ms=cuda_ms(fn), dev_ms=device_ms(cold(kernel, *inputs)),
                       enqueue_us=enqueue_us(fn, calls),
                       library_ev_ms=cuda_ms(lib),
                       library_dev_ms=device_ms(cold(library, W, rhs)),
                       library_enqueue_us=enqueue_us(lib, calls))
            del W
        out["forms"][name] = rec
        del got, want, inputs
    if not args.cpu:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    if args.solves:
        out["solves"] = time_solves(dev, args.cpu)
    print(json.dumps(out))


def time_solves(dev, cpu):
    """Warm walls of solves A and X (see the module's docstring)."""
    import torch

    from arnoldi_tpu_torch import as_operator, matrices, partial_schur
    from arnoldi_tpu_torch.solvers.spectral_transform import eigsh

    op = as_operator(matrices.laplace_2d(40 if cpu else 724), dtype=torch.float64,
                     device=dev)
    runs = {"A": lambda: partial_schur(op, 5, max_dim=80, stopping_criterion=1e-8,
                                       sort_function="LM", dtype=torch.float64,
                                       ortho="cgs2")[2].total_matvecs,
            "X": lambda: eigsh(op, 5, sigma=0.01, which="LM", ncv=40, tol=1e-8,
                               inner_solver="cg") and None}
    out = {}
    for label, fn in runs.items():
        fn()
        if not cpu:
            sync()
        t0 = time.perf_counter()
        matvecs = fn()
        if not cpu:
            sync()
        out[label] = {"wall_s": time.perf_counter() - t0, "matvecs": matvecs}
    return out


def turns(labels, order):
    """Checkout labels in turns: ABBA gives A B B A (A B C C B A for three)."""
    if order == "ABBA":
        return labels + labels[::-1]
    return list(labels)


def summarize(runs, labels):
    """Per form: each label's medians and spreads; the SHA-256 agreement."""
    rows = {}
    for name in runs[0][1]["forms"]:
        row = {}
        for label in labels:
            recs = [r["forms"][name] for lab, r in runs if lab == label]
            row[label] = {key: {"median": statistics.median(v), "spread": max(v) - min(v)}
                          for key in ("ev_ms", "dev_ms", "enqueue_us", "library_ev_ms",
                                      "library_dev_ms", "library_enqueue_us")
                          for v in ([r[key] for r in recs if r.get(key) is not None],)
                          if v}
            row[label]["sha256"] = sorted({r["sha256"] for r in recs})
        row["same_bits"] = len({h for label in labels for h in row[label]["sha256"]}) == 1
        rows[name] = row
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--repo", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--solves", action="store_true")
    ap.add_argument("--checkout", action="append", default=[],
                    help="LABEL=DIR, once per checkout")
    ap.add_argument("--order", choices=("ABBA", "once"), default="ABBA")
    ap.add_argument("--out", default="build/dia_ab.json")
    args = ap.parse_args()
    if args.worker:
        return worker(args)
    checkouts = dict(c.split("=", 1) for c in args.checkout)
    labels = list(checkouts)
    runs = []
    for label in turns(labels, args.order):
        cmd = [sys.executable, __file__, "--worker", "--repo", checkouts[label]]
        cmd += ["--cpu"] * args.cpu + ["--solves"] * args.solves
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"dia_ab: {label} failed ({proc.returncode}):\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"{label}: {time.perf_counter() - t0:.1f} s", flush=True)
    rows = summarize(runs, labels)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"labels": labels, "order": args.order,
                                          "runs": runs, "summary": rows}, indent=1))
    for name, row in rows.items():
        cells = []
        for label in labels:
            r = row[label]
            cells.append(label + " " + " ".join(
                f"{key.replace('_ms', '').replace('_us', '')} "
                f"{r[key]['median']:.4f}±{r[key]['spread']:.4f}"
                for key in ("ev_ms", "dev_ms", "enqueue_us") if key in r))
        lib = row[labels[0]]
        if "library_ev_ms" in lib:
            cells.append("library " + " ".join(
                f"{key[8:].replace('_ms', '').replace('_us', '')} {lib[key]['median']:.4f}"
                for key in ("library_ev_ms", "library_dev_ms", "library_enqueue_us")
                if key in lib))
        print(f"{name:<18} same bits {row['same_bits']}; " + "; ".join(cells))
    for solve in runs[0][1].get("solves", {}):
        print(f"solve {solve}: " + "; ".join(
            f"{label} " + " ".join(f"{r['solves'][solve]['wall_s']:.4f}"
                                   for lab, r in runs if lab == label)
            + f" s (matvecs {runs[labels.index(label)][1]['solves'][solve]['matvecs']})"
            for label in labels))
    print("card:", runs[0][1].get("card", "cpu rehearsal"))


if __name__ == "__main__":
    main()
