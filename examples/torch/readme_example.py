"""The reference README example on the port (mark(50), K=5 largest-real,
tol 1e-8), end to end: solve on the device path, eigenpairs from the
Schur form, residual check, ARPACK cross-validation.

Run from the repository's root (the card by default, ``--device cpu`` for
the kernels' plain versions)::

    PYTHONPATH=. python examples/torch/readme_example.py [--device cpu]
"""

import argparse

import numpy as np
from scipy.sparse.linalg import eigs as arpack_eigs

from arnoldi_tpu_torch import (as_operator, eigenpairs_from_partial_schur,
                               partial_schur)
from arnoldi_tpu_torch.matrices import mark


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    A = mark(50)  # n = 1275 Markov walk matrix
    tol = 1e-8
    # An operator on the device runs the device path (SciPy input this
    # small would run on the host tier).
    Q, T, history = partial_schur(
        as_operator(A, device=args.device), 5, max_dim=20,
        stopping_criterion=tol, sort_function="LR", max_restarts=2000,
    )
    vals, vecs = eigenpairs_from_partial_schur(Q, T)
    vecs = vecs.cpu().numpy()
    res = np.linalg.norm(A @ vecs - vals * vecs, axis=0)

    print(f"device: {Q.device}")
    print(f"eigenvalues (largest real): {np.round(np.real(vals), 6)}")
    print(f"residuals: {res}")
    print(f"matvecs: {history.total_matvecs}, "
          f"restarts: {int(history.restarts.max())}")

    r_vals = arpack_eigs(A, 5, which="LR", ncv=40)[0]
    match = np.allclose(np.sort(np.real(vals)), np.sort(np.real(r_vals)),
                        atol=100 * tol)
    print(f"ARPACK agreement: {match}")
    assert res.max() < 5 * tol and match
    print("OK")


if __name__ == "__main__":
    main()
