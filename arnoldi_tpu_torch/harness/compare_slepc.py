"""SLEPc comparison CLI (reference ``scripts/compare-against-slepc.py``).

Counterpart of ``arnoldi_tpu/harness/compare_slepc.py``: SLEPc's
Krylov-Schur against the port's ``partial_schur`` (``--device``).
Requires petsc4py/slepc4py (see :mod:`.slepc`); PETSc command-line flags
(-eps_*, -st_*, -ksp_*, -pc_*) are passed through to PETSc (reference
``:42-45``).  Runs under ``mpirun -n N`` for distributed SLEPc.
"""

import argparse
import re
import sys

import numpy as np

from .suite import (
    EigensolverParameters,
    add_device_argument,
    arnoldi_tpu_eig,
    check_device,
    find_best_matching,
    matrix_from_spec,
    print_residuals,
)


def parse_args(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    # Strip PETSc flags and hand them to PETSc via sys.argv
    # (reference compare-against-slepc.py:42-45).
    petsc_args, ours = [], []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith(("-eps", "-st", "-ksp", "-pc")):
            petsc_args.append(a)
            # consume the value token unless it is ANOTHER option: a
            # negative number ("-eps_target -0.5") must not leak into our
            # argparse, so only "-<letter>" counts as an option
            if i + 1 < len(argv) and not re.match(r"-[A-Za-z]",
                                                  argv[i + 1]):
                petsc_args.append(argv[i + 1])
                i += 1
        else:
            ours.append(a)
        i += 1

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("matrix")
    p.add_argument("--nev", type=int, default=5)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--max-dim", type=int, default=None, dest="max_dim")
    p.add_argument("--max-it", type=int, default=2000, dest="max_it")
    p.add_argument("--p", type=int, default=None)
    p.add_argument("--which", default="LM", choices=["LM", "LR", "SM", "SR"])
    add_device_argument(p)
    args = p.parse_args(ours)
    return args, petsc_args


def main(argv=None):
    args, petsc_args = parse_args(argv)
    device = check_device(args.device)

    from .slepc import ConvergenceTracker, slepc_eig  # import checks deps

    import petsc4py

    petsc4py.init([sys.argv[0]] + petsc_args)

    A = matrix_from_spec(args.matrix)
    params = EigensolverParameters.from_cli_args(args)

    tracker = ConvergenceTracker()
    s_vals, s_vecs, s_stats = slepc_eig(A, params, monitor=tracker)
    print(f"SLEPc: {s_stats.elapsed:.3f}s, {s_stats.restarts} iterations")

    vals, vecs, stats = arnoldi_tpu_eig(A, params, device=device)
    print(f"arnoldi_tpu_torch: {stats.elapsed:.3f}s, {stats.matvecs} matvecs")

    print_residuals("SLEPc", A, s_vals, s_vecs)
    print_residuals("arnoldi_tpu_torch", A, vals, vecs)

    a, b = find_best_matching(np.asarray(vals), s_vals)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=args.tol * 10)
    print("eigenvalues MATCH")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
