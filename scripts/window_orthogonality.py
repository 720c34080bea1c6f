#!/usr/bin/env python3
"""Orthogonality of ``eigsh_window``'s eigenvectors within and across
slices, the JAX package's and the port's, on the CPU.

    python3 scripts/window_orthogonality.py [--tol 1e-8]

For each case it prints, for both packages, the number of slices,
``max |V_i^T V_i - I|`` over the slices (within) and ``max |V_i^T V_j|``
over pairs of slices (across).  Each package cuts its own slices: the
port's ``History.slices`` gives them, and the JAX package's are recorded
by wrapping its ``eigsh_filtered`` for the call.  Needs JAX (on the CPU,
float64) and the port.
"""

import argparse
import os
import sys
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def overlaps(vals, V, cuts):
    """(within, across) for eigenpairs ``vals``/``V`` owned by the slices
    between ``cuts``."""
    G = np.abs(V.T @ V)
    owner = np.searchsorted(np.asarray(cuts)[1:-1], vals, side="right")
    slices = np.unique(owner)
    within = max(np.abs(G[np.ix_(owner == k, owner == k)]
                        - np.eye(int((owner == k).sum()))).max() for k in slices)
    across = max((G[np.ix_(owner == i, owner == j)].max()
                  for i in slices for j in slices if i != j), default=0.0)
    return within, across


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tol", type=float, default=1e-8)
    args = parser.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from arnoldi_tpu.matrices import laplace, laplace_3d
    from arnoldi_tpu.solvers import filtered as jf
    from arnoldi_tpu_torch.solvers import filtered as pf

    torch.set_num_threads(2)
    cases = [("laplace(400)", laplace(400).tocsr(), (-2.6, -1.4), 40),
             ("laplace_3d(16)", laplace_3d(16), (-11.0, -10.7), 16)]
    for label, A, window, max_slice in cases:
        seen, inner = [], jf.eigsh_filtered

        def recorded(*a, **kw):
            seen.append(a[2])
            return inner(*a, **kw)

        jf.eigsh_filtered = recorded
        t0 = time.perf_counter()
        try:
            vals, V, _ = jf.eigsh_window(A, window, tol=args.tol,
                                         max_slice=max_slice, dtype=np.float64,
                                         key=jax.random.key(0))
        finally:
            jf.eigsh_filtered = inner
        cuts = [iv[0] for iv in seen] + [seen[-1][1]]
        w, x = overlaps(vals, np.asarray(V), cuts)
        print(f"{label} {window} tol {args.tol:g}: JAX  {len(seen)} slices, "
              f"{len(vals)} pairs, within {w:.3e}, across {x:.3e} "
              f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        vals, V, hist = pf.eigsh_window(A, window, tol=args.tol,
                                        max_slice=max_slice, dtype=np.float64,
                                        device="cpu")
        cuts = [g["interval"][0] for g in hist.slices] + [hist.slices[-1]["interval"][1]]
        w, x = overlaps(vals, V.numpy(), cuts)
        print(f"{label} {window} tol {args.tol:g}: port {len(hist.slices)} "
              f"slices, {len(vals)} pairs, within {w:.3e}, across {x:.3e} "
              f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
