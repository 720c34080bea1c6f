"""Interior eigenpairs without factorizations: Chebyshev filtering.

Shift-invert needs a sparse LU (infeasible for 3-D stencils, fill ~O(n
g^2)); the polynomial-filtered drivers need only matvecs (the b-column
SpMV kernel at b = the subspace on the card):

    PYTHONPATH=. python examples/torch/interior_filtered.py [--device cpu]
"""

import argparse

import numpy as np

from arnoldi_tpu_torch import as_operator, eigsh_filtered, eigsh_window
from arnoldi_tpu_torch.matrices import laplace_3d, laplace_3d_eigen
from arnoldi_tpu_torch.solvers.filtered import estimate_window_count


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--grid", type=int, default=24)
    args = ap.parse_args(argv)

    g = args.grid                          # 3-D grid -> n = g^3
    A = laplace_3d(g)
    op = as_operator(A, device=args.device)
    full = np.sort(laplace_3d_eigen(g))    # analytic ground truth
    window = (-11.0, -10.8)
    inside = full[(full >= window[0]) & (full <= window[1])]

    # how many eigenvalues live in the window? (stochastic KPM count)
    est = estimate_window_count(op, window)
    print(f"window {window}: ~{est:.1f} eigenvalues (true: {inside.size})")

    # a few pairs nearest the window center
    vals, vecs, hist = eigsh_filtered(op, 4, window, tol=1e-9)
    V = vecs.cpu().numpy()
    res = np.linalg.norm(A @ V - vals * V, axis=0)
    print("eigsh_filtered:", np.round(vals, 6),
          f"max residual {res.max():.2e}, {hist.total_matvecs} matvecs")
    assert res.max() < 1e-7
    assert np.abs(vals[:, None] - full[None, :]).min(axis=1).max() < 1e-9

    # all pairs in the window (spectrum slicing)
    vals, vecs, hist = eigsh_window(op, window, tol=1e-9)
    V = vecs.cpu().numpy()
    res = np.linalg.norm(A @ V - vals * V, axis=0)
    err = np.abs(np.sort(vals) - inside).max() if len(vals) == inside.size else np.inf
    print(f"eigsh_window: {len(vals)}/{inside.size} pairs, max residual "
          f"{res.max():.2e}, max eigenvalue error {err:.2e}")
    assert len(vals) == inside.size and err < 1e-9 and res.max() < 1e-7
    print("OK")


if __name__ == "__main__":
    main()
