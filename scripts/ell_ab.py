#!/usr/bin/env python3
"""A/B timing of the ELL SpMV kernels of checkouts of ``arnoldi_tpu_torch`` on one card.

    python3 scripts/ell_ab.py --checkout parent=build/parent --checkout new=. \\
        [--order ABBA] [--solves] [--out build/ell_ab.json]
    python3 scripts/ell_ab.py --worker --repo DIR [--solves] [--cpu]

The first form runs each checkout in a subprocess of its own (``--worker``),
in turns (``ABBA``: A, B, B, A; with three checkouts A B C C B A), and
prints, for every ELL form, each checkout's median event time, cold device
time and host enqueue time with their spread over its turns, the kernels
one call launched, whether the checkouts' outputs have the same SHA-256,
the bound, and the library call's times; the full records go to ``--out``.
A worker imports ``arnoldi_tpu_torch`` from ``DIR``, builds its kernels
there, and for every form:

- checks the kernel against its plain version (normwise 1e-12 in float64
  and complex128, 1e-5 in float32 and complex64);
- hashes the output's bytes (SHA-256; the inputs come from one seed);
- ``kernels``: the kernel launches a call (profiler events over 10 calls);
- ``ev_ms``: CUDA events around 100 back-to-back launches, after 10;
- ``dev_ms``: the profiler's device time a call over copies of the inputs
  that pass twice the 50 MB L2 together (as a solve finds them: cold);
- ``enqueue_us``: the host clock over 1000 calls (100 for b > 8), read
  before the synchronize: the time the wrapper takes to issue a launch;
- the same three for cuSPARSE's product of the operator's CSR
  (``A_csr @ x``, ``A_csr @ Xt``), the one PyTorch call for the function;
- ``bound_ms``: the nonzeros and their int32 ids read once, x read and y
  written once, at 3.35 TB/s (above the flops at 34 or 67 TFLOP/s).

The forms are the ELL shapes of ``chip_smoke.py``'s main path: the
scattered 2^20-row matrix (``random_scattered(2^20, 24, seed=1,
bandwidth=2^14, block=8)``, L = 25) at b = 1, 2 and 8 in float64 and at b
= 8 in complex128 and complex64 (its values turned by phases from seed 7:
the complex forms' solves run at b = 8); its symmetrization
S (``edge="reflect"``, L = 129, the warp path) at b = 8 in float64;
laplace_3d(48) as ELL (110,592 rows, L = 7) and rank 1 of its 2-rank ring
halo (55,296 rows against a 59,904-entry window), both at the filter's b =
327 (solve 33's s) in float32 and float64.  ``--solves`` also runs solve
33 (``eigsh_filtered(laplace_3d(48) as ELL, nev=10, (-11.80, -11.77),
tol=1e-8, dtype=float32)``, generator seed 1), once to warm up and twice
timed, with its float32 and float64 matvecs, and one float32 sweep at its
geometry under the profiler (``chip_smoke.filter_sweep_split`` of this
script's checkout): device time by kernel family and busy share.  ``--cpu``
rehearses a worker on the CPU at small sizes (checks and hashes, no
times).  Prints the card's name and power limit.  Needs a card otherwise;
exits nonzero without one.
"""

import argparse
import hashlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
L2_BYTES = 50 * 2**20
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 34e12, "complex64": 67e12,
               "complex128": 34e12}
FILTER_B = 327                       # solve 33's s
FILTER_WINDOW_48 = (-11.80, -11.77)


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


def device_events(fn, reps, keep=lambda ev: True):
    """The profiler's device events of ``reps`` calls of ``fn`` that
    ``keep`` accepts (retried twice when it recorded none)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        events = [ev for ev in prof.events()
                  if ev.device_type == DeviceType.CUDA and keep(ev)]
        if events:
            return events
    return []


def device_ms(fn, reps=20):
    """Mean profiler device time of ``fn()`` a call (kernels and copies);
    None when the profiler recorded no device event."""
    us = sum(ev.time_range.elapsed_us() for ev in device_events(fn, reps))
    return us / 1e3 / reps if us > 0 else None


def kernels_per_call(fn, reps=10):
    """The ELL kernel launches the profiler saw over ``reps`` calls of
    ``fn``, a call (it may miss some: a mean below 1 is one a call)."""
    return len(device_events(fn, reps, lambda ev: "spmv_ell" in ev.name)) / reps


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


def phased(A, seed=7):
    """``A`` with every value turned by a phase from ``seed`` (complex128)."""
    import numpy as np

    A = A.tocsr().astype(np.complex128)
    A.data *= np.exp(1j * np.random.default_rng(seed).uniform(0, 2 * np.pi, A.nnz))
    return A


def plain_product(data, cols, X):
    """The plain version, a few columns at a time (its (b, n_rows, L)
    intermediate stays under 2 GB)."""
    import torch

    from arnoldi_tpu_torch.ops.kernels import spmv_ell

    if X.ndim == 1:
        return spmv_ell.ell_matvec_plain(data, cols, X)
    step = max(1, 2**31 // (data.numel() * data.element_size()))
    return torch.cat([spmv_ell.ell_matvec_plain(data, cols, X[j:j + step])
                      for j in range(0, X.shape[0], step)])


def forms(args, dev):
    """``(name, kernel(data, cols, X), (data, cols, X), SciPy matrix, bound
    bytes)`` for every form, built lazily."""
    import numpy as np
    import torch

    from arnoldi_tpu_torch import matrices
    from arnoldi_tpu_torch.linop import EllOperator, cast_operator
    from arnoldi_tpu_torch.ops.kernels import spmv_ell
    from arnoldi_tpu_torch.parallel import Mesh, halo_matvec_closure

    n, g, b_s = (2**12, 12, 37) if args.cpu else (2**20, 48, FILTER_B)
    gen = torch.Generator(device=dev).manual_seed(0)
    scattered = matrices.random_scattered(n, 24, seed=1, bandwidth=min(2**14, n // 4),
                                          block=8)
    R = matrices.random_scattered(n, 24, seed=1, bandwidth=min(2**14, n // 4),
                                  block=8, edge="reflect")
    lap3 = matrices.laplace_3d(g)
    cases = [("scattered", scattered, torch.float64, 1),
             ("scattered", scattered, torch.float64, 2),
             ("scattered", scattered, torch.float64, 8),
             ("scattered", phased(scattered), torch.complex128, 8),
             ("scattered", phased(scattered), torch.complex64, 8),
             ("S", ((R + R.T) / 2).tocsr(), torch.float64, 8),
             ("3d48", lap3, torch.float32, b_s), ("3d48", lap3, torch.float64, b_s)]
    halo = halo_matvec_closure(EllOperator.from_scipy(lap3, device=dev),
                               Mesh(None, 1, 2, dev))
    rows = halo.local.shape[0]
    halo_csr = window_csr(lap3, rows, 2 * rows, halo.halo)
    cases += [("halo", halo_csr, torch.float32, b_s), ("halo", halo_csr, torch.float64, b_s)]
    for tag, A, dtype, b in cases:
        op = (cast_operator(halo.local, dtype) if tag == "halo" else
              EllOperator.from_scipy(A.astype(np.complex128 if dtype.is_complex
                                              else np.float64), device=dev))
        op = cast_operator(op, dtype)
        n_rows, n_cols = op.shape
        X = torch.randn((n_cols,) if b == 1 else (b, n_cols), generator=gen,
                        device=dev, dtype=dtype)
        wrap = spmv_ell.ell_matvec if b == 1 else spmv_ell.ell_matmat
        item = X.element_size()
        yield (f"{tag} b={b} {str(dtype)[6:]}", wrap, (op.data, op.cols, X), A,
               op.nnz * (item + 4) + b * (n_rows + n_cols) * item,
               2 * op.nnz * b * (4 if dtype.is_complex else 1))
        del op, X


def worker(args):
    sys.path.insert(0, str(Path(args.repo).resolve()))
    import torch

    dev = torch.device("cpu" if args.cpu else "cuda")
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("ell_ab: no CUDA card")
    import arnoldi_tpu_torch
    from arnoldi_tpu_torch.ops import kernels

    here = Path(arnoldi_tpu_torch.__file__).resolve()
    if Path(args.repo).resolve() not in here.parents:
        raise SystemExit(f"ell_ab: imported {here}, not from {args.repo}")
    t0 = time.perf_counter()
    if not args.cpu:
        kernels.build()
    out = {"repo": str(Path(args.repo).resolve()), "build_s": time.perf_counter() - t0,
           "forms": {}}
    for name, kernel, inputs, A, bound_bytes, flops in forms(args, dev):
        dtype = inputs[0].dtype
        got, want = kernel(*inputs), plain_product(*inputs)
        limit = 1e-12 if dtype in (torch.float64, torch.complex128) else 1e-5
        err = float((got - want).norm() / want.norm())
        if not err <= limit:
            raise SystemExit(f"ell_ab: {name}: relative error {err:.3e} > {limit:g}")
        rec = {"rel_err": err,
               "sha256": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()}
        del want
        if not args.cpu:
            X = inputs[2]
            rhs = X if X.ndim == 1 else X.T.contiguous()
            W = csr(A, dtype, dev)

            def library(W, rhs):
                return W @ rhs

            calls = 1000 if X.ndim == 1 or X.shape[0] <= 8 else 100
            fn = lambda: kernel(*inputs)          # noqa: E731
            lib = lambda: library(W, rhs)         # noqa: E731
            rate = FLOPS_PER_S[str(dtype)[6:]]
            rec.update(kernels=kernels_per_call(fn), ev_ms=cuda_ms(fn),
                       dev_ms=device_ms(cold(kernel, *inputs)),
                       enqueue_us=enqueue_us(fn, calls),
                       bound_ms=1e3 * max(bound_bytes / HBM_BYTES_PER_S, flops / rate),
                       library_ev_ms=cuda_ms(lib),
                       library_dev_ms=device_ms(cold(library, W, rhs)),
                       library_enqueue_us=enqueue_us(lib, calls))
            del W, rhs
        out["forms"][name] = rec
        del got, inputs
    if not args.cpu:
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    if args.solves:
        out["solves"] = time_solve_33(dev, args.cpu)
    print(json.dumps(out))


def time_solve_33(dev, cpu):
    """Solve 33's walls and matvecs, and one float32 sweep's device split
    (see the module's docstring)."""
    import torch

    from arnoldi_tpu_torch import as_operator, eigsh_filtered, matrices

    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    g, window = (12, (-10.62, -10.41)) if cpu else (48, FILTER_WINDOW_48)
    A = matrices.laplace_3d(g)
    op = as_operator(A, format="ell", device=dev)

    def run():
        return eigsh_filtered(op, 10, window, tol=1e-8, dtype=torch.float32,
                              generator=torch.Generator().manual_seed(1))[2]

    run()
    walls = []
    for _ in range(2):
        if not cpu:
            sync()
        t0 = time.perf_counter()
        hist = run()
        if not cpu:
            sync()
        walls.append(time.perf_counter() - t0)
    geo = hist.geometry
    out = {"wall_s": walls, "float32_matvecs": hist.total_matvecs - geo["f64_matvecs"],
           "float64_matvecs": geo["f64_matvecs"], "s": geo["s"], "degree": geo["degree"]}
    if not cpu:
        out["sweep"] = chip_smoke.filter_sweep_split(
            as_operator(A, format="ell", dtype=torch.float32, device=dev), geo)
    return out


def turns(labels, order):
    """Checkout labels in turns: ABBA gives A B B A (A B C C B A for three)."""
    if order == "ABBA":
        return labels + labels[::-1]
    return list(labels)


KEYS = ("ev_ms", "dev_ms", "enqueue_us", "library_ev_ms", "library_dev_ms",
        "library_enqueue_us")


def summarize(runs, labels):
    """Per form: each label's medians and spreads and kernels a call; the
    SHA-256 agreement; the bound."""
    rows = {}
    for name in runs[0][1]["forms"]:
        row = {"bound_ms": runs[0][1]["forms"][name].get("bound_ms")}
        for label in labels:
            recs = [r["forms"][name] for lab, r in runs if lab == label]
            row[label] = {key: {"median": statistics.median(v), "spread": max(v) - min(v)}
                          for key in KEYS
                          for v in ([r[key] for r in recs if r.get(key) is not None],)
                          if v}
            row[label]["kernels"] = sorted({r.get("kernels") for r in recs}, key=str)
            row[label]["sha256"] = sorted({r["sha256"] for r in recs})
        row["same_bits"] = len({h for label in labels for h in row[label]["sha256"]}) == 1
        rows[name] = row
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--solves", action="store_true")
    ap.add_argument("--checkout", action="append", default=[],
                    help="LABEL=DIR, once per checkout")
    ap.add_argument("--order", choices=("ABBA", "once"), default="ABBA")
    ap.add_argument("--out", default="build/ell_ab.json")
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
            raise SystemExit(f"ell_ab: {label} failed ({proc.returncode}):\n"
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
            cells.append(label + f" x{'/'.join(map(str, r['kernels']))} " + " ".join(
                f"{key.replace('_ms', '').replace('_us', '')} "
                f"{r[key]['median']:.4f}±{r[key]['spread']:.4f}"
                for key in ("ev_ms", "dev_ms", "enqueue_us") if key in r))
        lib = row[labels[0]]
        if "library_ev_ms" in lib:
            cells.append("library " + " ".join(
                f"{key[8:].replace('_ms', '').replace('_us', '')} {lib[key]['median']:.4f}"
                for key in ("library_ev_ms", "library_dev_ms", "library_enqueue_us")
                if key in lib))
        bound = "" if row["bound_ms"] is None else f"bound {row['bound_ms']:.4f}; "
        print(f"{name:<24} same bits {row['same_bits']}; {bound}" + "; ".join(cells))
    for label in labels:
        for lab, r in runs:
            if lab == label and "solves" in r:
                s = r["solves"]
                sweep = s.get("sweep", {})
                print(f"solve 33 {label}: walls {s['wall_s']} s, matvecs "
                      f"{s['float32_matvecs']} + {s['float64_matvecs']}, s {s['s']}, "
                      f"degree {s['degree']}; sweep device "
                      f"{sweep.get('device_ms', 'n/a')} ms, busy {sweep.get('busy', 'n/a')}, "
                      f"by family {sweep.get('by_family_ms', {})}")
    print("card:", runs[0][1].get("card", "cpu rehearsal"))


if __name__ == "__main__":
    main()
