"""ARPACK comparison CLI (reference ``scripts/compare-against-arpack.py``).

Usage::

    python -m arnoldi_tpu_torch.harness.compare_arpack mark:100 --nev 5 --which LR
    python -m arnoldi_tpu_torch.harness.compare_arpack path/to/Problem.mat --nev 20

Reports wall time, matvec counts ("% more/fewer matvecs than ARPACK",
reference ``:139-147``), residuals, and asserts eigenvalue agreement at
``rtol=tol`` (reference ``:154-155``).  Both solvers start from the same
vector, drawn from ``--seed``.
"""

import argparse

import numpy as np

from .suite import (
    EigensolverParameters,
    add_device_argument,
    arnoldi_tpu_eig,
    arpack_eig,
    check_device,
    eigenvalues_match,
    find_best_matching,
    matrix_from_spec,
    print_residuals,
    start_vector,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("matrix", help="matrix spec: generator (mark:100, "
                   "laplace2d:64, grcar:200, clement:200) or .mat/.mtx path")
    p.add_argument("--nev", type=int, default=5)
    p.add_argument("--tol", type=float, default=1e-8)
    p.add_argument("--max-dim", type=int, default=None, dest="max_dim")
    p.add_argument("--max-it", type=int, default=2000, dest="max_it")
    p.add_argument("--p", type=int, default=None)
    p.add_argument("--which", default="LM", choices=["LM", "LR", "SM", "SR", "LI", "SI"])
    p.add_argument("--dtype", default=None,
                   help="solver dtype (float32 refines to tol in float64)")
    p.add_argument("--ortho", default=None)
    p.add_argument("--seed", type=int, default=0)
    add_device_argument(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = check_device(args.device)
    A = matrix_from_spec(args.matrix)
    params = EigensolverParameters.from_cli_args(args)

    print(f"matrix {args.matrix}: n={A.shape[0]}, nnz={A.nnz}")

    # One start vector for both solvers: ARPACK's RNG state persists across
    # calls, and on tied-|lambda| clusters the converged member depends on
    # the start (see suite.eigenvalues_match).
    v0 = start_vector(A.shape[0], args.seed)
    r_vals, r_vecs, r_stats = arpack_eig(A, params, v0=v0)
    print(f"ARPACK: {r_stats.elapsed:.3f}s, {r_stats.matvecs} matvecs, "
          f"~{r_stats.restarts} iterations")

    dtype = np.dtype(args.dtype) if args.dtype else None
    vals, vecs, stats = arnoldi_tpu_eig(A, params, dtype=dtype, ortho=args.ortho,
                                        v0=v0, device=device)
    print(f"arnoldi_tpu_torch [{stats.dtype}] on {device}: "
          f"{stats.elapsed:.3f}s, {stats.matvecs} matvecs, "
          f"{stats.restarts} restarts")

    delta = 100.0 * (stats.matvecs - r_stats.matvecs) / max(r_stats.matvecs, 1)
    word = "more" if delta >= 0 else "fewer"
    print(f"arnoldi_tpu_torch used {abs(delta):.1f}% {word} matvecs than ARPACK")

    print_residuals("ARPACK", A, r_vals, r_vecs)
    print_residuals("arnoldi_tpu_torch", A, vals, vecs)

    a, b = find_best_matching(np.asarray(vals), r_vals)
    try:
        np.testing.assert_allclose(a, b, rtol=max(args.tol, 1e-12) * 100,
                                   atol=args.tol * 10)
        print("eigenvalues MATCH")
    except AssertionError:
        # Tied-|lambda| boundary clusters make the cut member ambiguous;
        # both solvers are correct if they differ only there.
        if not eigenvalues_match(np.asarray(vals), r_vals, args.which,
                                 rtol=max(args.tol, 1e-12) * 100,
                                 atol=args.tol * 10):
            raise
        print("eigenvalues MATCH (modulo a tied boundary cluster)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
