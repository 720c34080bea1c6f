"""Hermitian and SVD workflows on the port: thick-restart block Lanczos,
shift-invert for interior eigenvalues, and a partial SVD.

    PYTHONPATH=. python examples/torch/hermitian_and_svd.py [--device cpu]
"""

import argparse

import numpy as np

from arnoldi_tpu_torch import as_operator, eigsh, partial_eigh, svds
from arnoldi_tpu_torch.matrices import laplace_2d, laplace_2d_eigen


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    tol = 1e-9

    # Smallest eigenvalues of a 2-D Laplacian: block mode finds the
    # degenerate pairs of the square grid that scalar Krylov cannot.
    A = laplace_2d(32)
    vals, vecs, hist = partial_eigh(
        as_operator(A, device=args.device), 6, which="SA",
        stopping_criterion=tol, max_restarts=5000, block_size=4,
    )
    want = np.sort(laplace_2d_eigen(32))[:6]
    print("block Lanczos SA:", np.round(np.sort(vals), 6))
    print("analytic        :", np.round(want, 6))
    assert np.abs(np.sort(vals) - want).max() < 1e-8

    # Interior eigenvalues near sigma by shift-invert (bicgstab inner solves).
    sig = -4.0
    vals2, _ = eigsh(A, 3, sigma=sig, tol=tol, maxiter=5000,
                     inner_solver="bicgstab", device=args.device)
    full = np.sort(laplace_2d_eigen(32))
    nearest = np.sort(full[np.argsort(np.abs(full - sig))[:3]])
    print(f"eigsh sigma={sig}:", np.round(np.sort(vals2), 6))
    print("nearest analytic :", np.round(nearest, 6))
    assert np.abs(np.sort(vals2) - nearest).max() < 1e-7

    # Partial SVD of a random rectangular matrix.
    M = np.random.default_rng(0).standard_normal((300, 120))
    U, s, Vh = svds(M, 5, tol=tol, maxiter=5000, device=args.device)
    ref = np.linalg.svd(M, compute_uv=False)[:5]
    print("svds:", np.round(np.sort(s)[::-1], 5))
    print("ref :", np.round(ref, 5))
    assert np.abs(np.sort(s)[::-1] - ref).max() < 1e-7 * ref[0]
    print("OK")


if __name__ == "__main__":
    main()
