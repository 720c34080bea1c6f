#!/usr/bin/env python3
"""How M-orthogonal ``eigsh(A, M=)``'s eigenvectors come out, in the JAX
package and in the port, on a pencil with a split double eigenvalue.

    python3 scripts/pencil_orthogonality.py [--side N ...] [--tol T]

For each side N: A = laplace_2d(N), whose grid symmetry makes many of its
eigenvalues double, and M = diag(m), m uniform on [0.5, 1.5] from seed 9
(the lumped mass matrix of ``chip_smoke.py``'s pencil solve), which splits
each double pair.  Both packages solve ``eigsh(A, 5, M=M, sigma=0.01,
tol=T, inner_solver="cg")`` on the CPU in float64 (JAX with x64).  Both
M-normalize the eigenvectors the Krylov-Schur solve returns and neither
M-orthogonalizes them, so a pair split by a small gap keeps an M-inner
product of about tol times the transformed problem's scale over that gap.
Prints one JSON line a side: the five eigenvalues, the smallest gap among
them, and each package's largest diagonal and off-diagonal errors of
``X^T M X = I``.  Needs no card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def m_errors(X, M):
    import numpy as np

    G = X.conj().T @ (M @ X) - np.eye(X.shape[1])
    diag = float(np.abs(np.diag(G)).max())
    return diag, float(np.abs(G - np.diag(np.diag(G))).max())


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--side", type=int, nargs="+", default=[40, 80])
    parser.add_argument("--tol", type=float, default=1e-8)
    args = parser.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import scipy.sparse as sp
    import torch

    from arnoldi_tpu.matrices import laplace_2d
    from arnoldi_tpu.solvers.spectral_transform import eigsh as jax_eigsh
    from arnoldi_tpu_torch import eigsh

    torch.set_num_threads(1)
    for side in args.side:
        A = laplace_2d(side).tocsr()
        n = A.shape[0]
        M = sp.diags(np.random.default_rng(9).uniform(0.5, 1.5, n)).tocsr()
        kw = dict(M=M, sigma=0.01, tol=args.tol, inner_solver="cg")
        jvals, jX = jax_eigsh(A, 5, key=jax.random.key(0), **kw)
        tvals, tX = eigsh(A, 5, generator=torch.Generator().manual_seed(0),
                          device="cpu", **kw)
        jvals = np.sort(np.asarray(jvals))
        gap = float(np.diff(jvals).min())
        jd, jo = m_errors(np.asarray(jX), M)
        td, to = m_errors(tX.numpy(), M)
        print(json.dumps({
            "side": side, "n": n, "tol": args.tol, "eigenvalues": jvals.tolist(),
            "smallest_gap": gap,
            "jax": {"diagonal": jd, "off_diagonal": jo},
            "port": {"diagonal": td, "off_diagonal": to,
                     "eigenvalues": np.sort(tvals).tolist()},
            "platform": "cpu"}), flush=True)


if __name__ == "__main__":
    main()
