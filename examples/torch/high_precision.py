"""1e-8 residuals from a float32 solve.

The port's form of ``examples/high_precision_tpu.py``.  Ask a float32
solve for ``stopping_criterion=1e-8`` and the driver runs its float32
phase to ~2e-4, then continues the same restart loop in float64 on the
operator at its own values (Hopper has float64; the JAX package's
double-word arithmetic has no counterpart here).  Refined results come
back in float64.  Build the operator from the float64 source and pass
``dtype=float32``.

    PYTHONPATH=. python examples/torch/high_precision.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from arnoldi_tpu_torch import as_operator, partial_eigh, partial_schur
from arnoldi_tpu_torch.matrices import laplace_2d, laplace_2d_eigen, mark


def hermitian(device):
    nx, ny = 40, 39
    A = laplace_2d(nx, ny)
    vals, vecs, hist = partial_eigh(
        as_operator(A, device=device), 4, which="LA", stopping_criterion=1e-8,
        max_restarts=3000, dtype=np.float32,
        generator=torch.Generator().manual_seed(0),
    )
    want = np.sort(laplace_2d_eigen(nx, ny))[-4:]
    V = vecs.cpu().numpy()
    res = np.linalg.norm(A @ V - V * np.asarray(vals)[None, :], axis=0)
    err = np.abs(np.sort(vals) - want).max()
    print(f"Hermitian (laplace_2d 40x39, float32 then float64, {vecs.dtype}):")
    print("  eigenvalue error against the analytic values:", err)
    print("  true residuals:", res)
    print("  matvecs:", hist.total_matvecs)
    assert vecs.dtype == torch.float64 and err < 1e-9 and res.max() < 1e-7


def non_hermitian(device):
    A = mark(40)  # Saad's Markov matrix, n = 820
    Q, T, hist = partial_schur(
        as_operator(A, device=device), 4, max_dim=24, stopping_criterion=1e-8,
        sort_function="LR", max_restarts=2000, dtype=np.float32, ortho="cgs2",
        generator=torch.Generator().manual_seed(0),
    )
    Qh, Th = Q.cpu().numpy(), T.cpu().numpy()
    res = np.linalg.norm(A @ Qh - Qh @ Th, axis=0)
    print(f"Non-Hermitian (mark(40), float32 then float64, {Q.dtype}):")
    print("  Schur residuals:", res)
    print("  matvecs:", hist.total_matvecs)
    assert Q.dtype == torch.float64 and res.max() < 1e-7


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    hermitian(args.device)
    non_hermitian(args.device)
    print("OK")


if __name__ == "__main__":
    main()
