"""Orthogonalization kernels with the ``(h, w, beta, breakdown)`` contract.

Counterpart of ``arnoldi_tpu/ops/ortho.py`` for the scalar Krylov-Schur
slice.  Every kernel orthogonalizes ``w`` against the first ``n_active``
rows of the transposed basis ``Vt: (m+1, n)`` and returns

* ``h`` -- (m+1,) projection coefficients, zero past ``n_active``;
* ``w`` -- the orthogonalized, not normalized, vector;
* ``beta`` -- ``||w||`` as a 0-d tensor;
* ``breakdown`` -- ``beta < tol`` as a 0-d bool tensor.

All of them are built from the two fused passes of
``ops/kernels/ortho_fused.py``, which launch the CUDA kernels on CUDA
tensors and run their plain PyTorch versions on CPU tensors.  The DGKS
test of :func:`cgs_dgks` is a host ``if`` on a 0-d tensor, so it waits for
the device once per call (the JAX version keeps it on the device with
``lax.cond``).
"""

import math
from functools import partial

import torch

from .kernels.ortho_fused import cgs2_fused, masked_project, project_update_norm

#: DGKS re-orthogonalization threshold, eta = sqrt(1/2).
M_SQRT1_2 = math.sqrt(0.5)


def _project(Vt, w, n_active):
    c = masked_project(Vt, w, n_active)
    w, norm_sq = project_update_norm(Vt, w, c, n_active)
    return c, w, torch.sqrt(norm_sq)


def cgs_dgks(Vt, w, n_active, *, tol=1e-8, eta=M_SQRT1_2):
    """Classical Gram-Schmidt with one DGKS-controlled second pass, taken
    when ``beta1 < eta * ||w||``; ``eta <= 0`` never takes it."""
    c1, w1, beta1 = _project(Vt, w, n_active)
    if eta > 0:
        # ||w|| from the update pass over no rows: w' = w, plus its norm.
        _, beta_before_sq = project_update_norm(Vt, w, c1, 0)
        if bool(beta1 < eta * torch.sqrt(beta_before_sq)):
            c2, w1, beta1 = _project(Vt, w1, n_active)
            c1 = c1 + c2
    return c1, w1, beta1, beta1 < tol


#: Twice-is-enough CGS: both passes always run.
cgs2 = cgs2_fused

#: Registry used by the solver drivers (``ortho=``).  ``"cgs2_pallas"``
#: names the same function as ``"cgs2"``, so one ``ortho=`` value drives
#: both packages in the parity tests.  ``mgs_dgks``, ``mgs`` and
#: ``block_cgs2`` are not ported yet (ROADMAP.md, Queue 1 item 3).
ORTHO_KERNELS = {
    "cgs_dgks": cgs_dgks,
    "cgs2": cgs2,
    "cgs": partial(cgs_dgks, eta=0.0),
    "cgs2_pallas": cgs2,
}


def resolve_ortho(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn in ("mgs_dgks", "mgs"):
        raise NotImplementedError(
            f"ortho={name_or_fn!r} is not ported yet (ROADMAP.md, Queue 1 "
            "item 3)")
    try:
        return ORTHO_KERNELS[name_or_fn]
    except KeyError:
        raise ValueError(
            f"Unknown orthogonalization kernel {name_or_fn!r}; expected one of "
            f"{sorted(ORTHO_KERNELS)} or a callable"
        ) from None
