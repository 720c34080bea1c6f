"""Quick partial_schur benchmark CLI
(reference ``scripts/benchmark-partial-schur.py``).

Runs the port's ``partial_schur`` and ARPACK on one matrix, printing wall
time, ms/matvec and ms/iteration (reference ``:111-115``), asserting the
residual gate ``normalized residual < 5*tol`` (reference ``:22,100``) and
eigenvalue agreement (``:122-123``)::

    python -m arnoldi_tpu_torch.harness.bench_partial_schur laplace2d:300 --which LM
"""

import argparse

import numpy as np

from .suite import (
    EigensolverParameters,
    add_device_argument,
    arnoldi_tpu_eig,
    arpack_eig,
    check_device,
    find_best_matching,
    matrix_from_spec,
    print_residuals,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("matrix", nargs="?", default="mark:100")
    ap.add_argument("--nev", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--max-dim", type=int, default=None)
    ap.add_argument("--which", default="LR")
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--warm", action="store_true",
                    help="run ours twice and time the warm run")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = check_device(args.device)

    A = matrix_from_spec(args.matrix)
    params = EigensolverParameters(
        nev=args.nev, ncv=args.max_dim, tol=args.tol, max_restarts=100_000,
        which=args.which,
    )
    dtype = np.dtype(args.dtype) if args.dtype else None

    if args.warm:
        arnoldi_tpu_eig(A, params, dtype=dtype, device=device)
    vals, vecs, stats = arnoldi_tpu_eig(A, params, dtype=dtype, device=device)
    res = print_residuals("partial_schur", A, vals, vecs)
    assert res.max() < 5 * args.tol or (
        dtype is not None and np.dtype(dtype).itemsize <= 4
    ), f"residual gate failed: {res.max()} >= {5 * args.tol}"

    r_vals, r_vecs, r_stats = arpack_eig(A, params)
    print_residuals("ARPACK", A, r_vals, r_vecs)

    for name, s in [("partial_schur", stats), ("ARPACK", r_stats)]:
        print(f"{name:14s} {s.elapsed:8.3f}s  "
              f"{1000 * s.elapsed / max(s.matvecs, 1):8.3f} ms/matvec  "
              f"{1000 * s.elapsed / max(s.restarts, 1):8.3f} ms/iter  "
              f"({s.matvecs} matvecs, {s.restarts} iters)")

    a, b = find_best_matching(np.asarray(vals), r_vals)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=max(args.tol * 10, 1e-10))
    print(f"eigenvalues MATCH (device {device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
