"""Stress-test sweep CLI (reference ``scripts/stress-test.py``).

Counterpart of ``arnoldi_tpu/harness/stress_test.py``: runs a parameter
grid over {krylov-schur (the port's ``partial_schur``), ARPACK, deflated
explicit restarts, the reference implementation} and writes a CSV with
the reference's schema (``stress-test.py:65-67``):

    method,dtype,nev,ncv,tol,max_restarts,p,which,elapsed,matvecs,restarts,match

Every method of a row starts from the same vector, drawn from the seed.

Usage::

    python -m arnoldi_tpu_torch.harness.stress_test mark:100 -o stress.csv
    python -m arnoldi_tpu_torch.harness.stress_test path.mat --quick --device cpu
"""

import argparse
import csv
import sys

import numpy as np

from .suite import (
    EigensolverParameters,
    add_device_argument,
    arnoldi_py_ref_eig,
    arnoldi_tpu_eig,
    arpack_eig,
    check_device,
    deflation_eig,
    eigenvalues_match,
    matrix_from_spec,
    start_vector,
)

#: The reference's 18-config grid (``stress-test.py:29-41``): nev 3..75,
#: ncv 20..100, tol 1e-8, both LM and LR.
PARAMETERS = [
    EigensolverParameters(nev=nev, ncv=ncv, tol=1e-8, max_restarts=100_000,
                          p=None, which=which)
    for which in ("LM", "LR")
    for (nev, ncv) in [
        (3, 20), (5, 20), (5, 40), (10, 40), (10, 60), (25, 60),
        (25, 100), (50, 100), (75, 100),
    ]
]

#: The reference's grid VERBATIM (``stress-test.py:29-41``): explicit fixed
#: truncation sizes p — exercises the reference's fixed-p behavior (our
#: ``p=None`` adaptive policy never sweeps it; the CSV ``p`` column is
#: populated only by this preset).
REFERENCE_PARAMETERS = [
    EigensolverParameters(nev=nev, ncv=ncv, tol=1e-8, max_restarts=100_000,
                          p=p, which=which)
    for which in ("LM", "LR")
    for (nev, ncv, p) in [
        (3, 20, 10), (6, 20, 12), (10, 20, 16), (12, 30, 21), (20, 40, 30),
        (30, 50, 40), (50, 80, 65), (50, 100, 75), (75, 100, 85),
    ]
]

QUICK_PARAMETERS = [
    EigensolverParameters(nev=nev, ncv=ncv, tol=1e-8, max_restarts=10_000,
                          p=None, which=which)
    for which in ("LM", "LR")
    for (nev, ncv) in [(3, 20), (5, 40)]
]

GRIDS = {
    "adaptive": PARAMETERS,
    "ref-fixed-p": REFERENCE_PARAMETERS,
    "quick": QUICK_PARAMETERS,
}


def run_one(method, A, params, seed, device="cuda"):
    """One solve of ``method`` from the seed's start vector (ARPACK's
    Fortran RNG state persists across calls, and on tied-|lambda| clusters
    the converged member depends on the start: one vector for every method
    keeps rows independent of the grid's order)."""
    import torch

    v0 = start_vector(A.shape[0], seed)
    if method == "arpack":
        return arpack_eig(A, params, v0=v0)
    if method == "krylov-schur":
        return arnoldi_tpu_eig(A, params, v0=v0, device=device)
    if method == "deflation":
        return deflation_eig(A, params, device=device,
                             generator=torch.Generator().manual_seed(seed))
    if method == "arnoldi-py-ref":
        return arnoldi_py_ref_eig(A, params, v0=v0)
    raise ValueError(method)


def warmup(methods, A, seed, device="cuda"):
    """One tiny-budget solve per method on the sweep matrix before timing:
    the first solve in a process pays one-time costs (the kernels' build
    or load, the host engine's load, BLAS's thread pool) that are not the
    solver's."""
    params = EigensolverParameters(nev=1, ncv=8, tol=1e-2,
                                   max_restarts=2, p=None, which="LM")
    for method in methods:
        try:
            run_one(method, A, params, seed, device)
        except Exception:
            pass  # a failing/non-converging warmup must not kill the sweep


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("matrix")
    ap.add_argument("-o", "--output", default="stress-test.csv")
    ap.add_argument("--quick", action="store_true",
                    help="4-config grid for smoke testing")
    ap.add_argument("--grid", default="adaptive", choices=sorted(GRIDS),
                    help="parameter preset: 'adaptive' (this framework's "
                    "p=None policy over the reference's (nev,ncv) pairs), "
                    "'ref-fixed-p' (the reference grid VERBATIM, explicit "
                    "p per row — stress-test.py:29-41), 'quick'")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the untimed per-method warmup solve (one-time "
                    "kernel/native/BLAS init then lands in the first grid row)")
    ap.add_argument("--methods", default="krylov-schur,arpack",
                    help="comma list of krylov-schur,arpack,deflation,"
                    "arnoldi-py-ref (the reference implementation itself, "
                    "imported from $ARNOLDI_REF_PATH)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-nev", type=int, default=None,
                    help="skip grid rows with nev above this (the "
                    "explicit-restart deflation method converges one "
                    "eigenpair at a time in complex128, so its large-nev "
                    "rows run at reduced seed counts in separate sweeps)")
    ap.add_argument("--min-nev", type=int, default=None,
                    help="skip grid rows with nev below this (the "
                    "complement of --max-nev for the reduced-seed sweeps)")
    ap.add_argument("--reps", type=int, default=1,
                    help="repetitions per seed; the elapsed recorded for a "
                    "seed is the MIN over reps (steady-state estimate, "
                    "shedding transient system noise); matvec counts are "
                    "deterministic per seed")
    ap.add_argument("--seeds", type=int, default=1,
                    help="seeds per row (start vectors seed..seed+N-1); the "
                    "CSV records PER-FIELD MEDIANS over the seeds and "
                    "match=True only if every seed matches (the start "
                    "vector moves both solvers' matvec counts)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)

    A = matrix_from_spec(args.matrix)
    n = A.shape[0]
    grid = QUICK_PARAMETERS if args.quick else GRIDS[args.grid]
    methods = args.methods.split(",")

    if not args.no_warmup:
        warmup(methods, A, args.seed, device)

    seeds = list(range(args.seed, args.seed + max(args.seeds, 1)))
    rows = []
    for params in grid:
        if params.ncv >= n or params.nev >= n // 2:
            continue
        if args.max_nev is not None and params.nev > args.max_nev:
            continue
        if args.min_nev is not None and params.nev < args.min_nev:
            continue
        ref_vals = {}          # seed -> first method's eigenvalues
        # Methods interleave inside each seed, so adjacent-in-time runs
        # sample the same drift of the host's throughput.
        runs = {m: [] for m in methods}      # method -> per-seed stats
        match = {m: True for m in methods}
        err = {}
        for s in seeds:
            # Reps are the inner loop: the run that follows a heavy method
            # starts cache-cold, so min over reps (--reps >= 2) is the
            # steady-state number when methods of different weight mix.
            for method in methods:
                if method in err:
                    continue
                for rep in range(max(args.reps, 1)):
                    try:
                        vals, vecs, stats = run_one(method, A, params, s,
                                                    device)
                    except Exception as e:  # record failure, keep sweeping
                        err[method] = e
                        break
                    if rep == 0:
                        runs[method].append(stats)
                        if method == methods[0]:
                            # only the FIRST method defines the reference;
                            # if it failed, others must not self-match
                            ref_vals[s] = np.asarray(vals)
                        elif s not in ref_vals:
                            match[method] = None   # reference failed
                        elif match[method]:
                            # Boundary-tie-aware gate: on tied-|lambda|
                            # clusters (mark is symmetric +/-) the cut
                            # member is ambiguous and both solvers are
                            # correct — see eigenvalues_match.
                            match[method] = bool(eigenvalues_match(
                                np.asarray(vals), ref_vals[s],
                                params.which))
                    elif stats.elapsed < runs[method][-1].elapsed:
                        runs[method][-1] = stats   # min over reps
        for method in methods:
            if method in err:
                e = err[method]
                rows.append([
                    method, "-", params.nev, params.ncv, params.tol,
                    params.max_restarts, params.p, params.which,
                    -1, -1, -1, f"error: {type(e).__name__}",
                ])
                print(f"{method:14s} nev={params.nev:3d} ncv={params.ncv:4d} "
                      f"{params.which}: FAILED {e}", file=sys.stderr)
                continue
            rr = runs[method]
            elapsed = float(np.median([r.elapsed for r in rr]))
            matvecs = int(np.median([r.matvecs for r in rr]))
            restarts = int(np.median([r.restarts for r in rr]))
            rows.append([
                method, rr[0].dtype, params.nev, params.ncv, params.tol,
                params.max_restarts, params.p, params.which,
                round(elapsed, 4), matvecs, restarts, match[method],
            ])
            print(f"{method:14s} nev={params.nev:3d} ncv={params.ncv:4d} "
                  f"{params.which}: {elapsed:8.3f}s {matvecs:7d} mv "
                  f"match={match[method]} ({len(rr)} seeds)",
                  file=sys.stderr)

    with open(args.output, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["method", "dtype", "nev", "ncv", "tol", "max_restarts",
                    "p", "which", "elapsed", "matvecs", "restarts", "match"])
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
