"""Dominant complex conjugate pairs through the real-arithmetic path.

A real nonsymmetric operator with local circulation has complex
eigenvalues; ``partial_schur`` keeps a real operator in real arithmetic
and carries each conjugate pair as a 2x2 block of a real Schur form, and
the eigenpairs come out complex from the post-processing.

    PYTHONPATH=. python examples/torch/complex_pairs_real_path.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from arnoldi_tpu_torch import (as_operator, eigenpairs_from_partial_schur,
                               partial_schur)
from arnoldi_tpu_torch.matrices import random_scattered_complex_pairs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    # Three dominant conjugate pairs d_j +/- i w_j above a real bulk.
    A = random_scattered_complex_pairs(20_000, 8, coupling=0.02, omega=0.3,
                                       seed=7, bandwidth=512)
    Q, T, hist = partial_schur(
        as_operator(A, device=args.device), 6, max_dim=32,
        stopping_criterion=1e-10, sort_function="LR", max_restarts=2000,
        dtype=np.float64, generator=torch.Generator().manual_seed(0),
    )
    Th = T.cpu().numpy()
    assert not np.iscomplexobj(Th), "real Schur form: 2x2 blocks, no complex"

    vals, vecs = eigenpairs_from_partial_schur(Q, T)
    V = vecs.cpu().numpy()
    res = np.linalg.norm(A @ V - vals * V, axis=0)

    print("real Schur T (first 4x4 block structure):")
    print(np.round(Th[:4, :4], 4))
    print("eigenvalues:", np.round(vals, 5))
    print("max residual:", float(res.max()), f"({hist.total_matvecs} matvecs)")
    assert np.abs(vals.imag).min() > 0.2, "every wanted eigenvalue is complex"
    assert res.max() < 1e-8
    print("OK: complex spectrum recovered entirely in real arithmetic")


if __name__ == "__main__":
    main()
