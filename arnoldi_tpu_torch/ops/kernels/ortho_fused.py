"""Fused classical Gram-Schmidt passes over the transposed basis.

Counterpart of ``arnoldi_tpu/ops/pallas/ortho_fused.py``.  The basis is
``Vt: (m+1, n)``, one Krylov vector per contiguous row, of which the first
``n_active`` are valid; rows past ``n_active`` may hold anything and are
never read (the TPU kernels' 0/1 row mask becomes this row count).

* :func:`masked_project` -- ``c = Vt[:n_active] @ w``, zero-padded to m+1;
* :func:`project_update_norm` -- ``w' = w - c[:n_active] @ Vt[:n_active]``
  and ``||w'||^2`` in the same pass;
* :func:`cgs2_fused` -- twice-is-enough CGS built from the two.

On CUDA tensors the first two launch ``csrc/ortho_fused.cu``; on CPU
tensors they run the ``*_plain`` versions.  Sums accumulate in the operand
dtype (float32 stays float32, float64 stays float64), as the TPU kernels'
``promote_types(dtype, float32)`` does for these two dtypes.
"""

import torch

from . import _build

#: Columns of ``Vt`` one group of 8 warps of the projection pass owns at a
#: time.  Its slice of ``w`` is staged in shared memory (8 KB in float64).
PROJECT_CHUNK = 1024


def masked_project_plain(Vt, w, n_active):
    """Plain PyTorch ``c = Vt[:n_active] @ w`` padded with zeros to m+1."""
    c = torch.zeros(Vt.shape[0], dtype=Vt.dtype, device=Vt.device)
    if n_active:
        c[:n_active] = Vt[:n_active] @ w
    return c


def project_update_norm_plain(Vt, w, c, n_active):
    """Plain PyTorch ``(w - c[:n_active] @ Vt[:n_active], ||.||^2)``."""
    w_new = w - c[:n_active] @ Vt[:n_active] if n_active else w.clone()
    return w_new, torch.dot(w_new, w_new)


def _check_basis(kernel, Vt, w, n_active):
    if Vt.ndim != 2 or w.shape != (Vt.shape[1],):
        raise ValueError(f"{kernel}: Vt {tuple(Vt.shape)}, w {tuple(w.shape)}")
    if not 0 <= n_active <= Vt.shape[0]:
        raise ValueError(f"{kernel}: n_active={n_active} outside "
                         f"[0, {Vt.shape[0]}]")


_TICKETS = {}


def _ticket(device, stream):
    """The two int32 counters of the projection kernel's grid barrier, one
    pair per device and stream: zero between launches (the last block
    resets them), and shared only by launches on one stream, which run in
    order."""
    key = (device, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _TICKETS[key]


def masked_project(Vt, w, n_active):
    """``c[r] = Vt[r] . w`` for ``r < n_active``, 0 after; shape (m+1,).

    One cooperative kernel launch: per-row partials over chunks of
    :data:`PROJECT_CHUNK` columns, a grid-wide barrier, then each row's
    partials summed in a fixed order (the bits of a two-launch split-K)."""
    n_active = int(n_active)
    cuda = _build.on_cuda("masked_project", Vt, w)
    _check_basis("masked_project", Vt, w, n_active)
    if not cuda:
        return masked_project_plain(Vt, w, n_active)
    mp1, n = Vt.shape
    n_chunks = -(-n // PROJECT_CHUNK)
    c = torch.empty(mp1, dtype=Vt.dtype, device=Vt.device)
    fn = _build.kernel_fn("arn_masked_project", Vt.dtype)
    guard, stream = _build.launch_context(Vt.device)
    ticket = _ticket(Vt.device, stream)
    partials = torch.empty(max(n_active, 1) * n_chunks, dtype=Vt.dtype,
                           device=Vt.device)
    with guard:
        rc = fn(Vt.data_ptr(), w.data_ptr(), c.data_ptr(), partials.data_ptr(),
                ticket.data_ptr(), n, mp1, n_active, PROJECT_CHUNK, n_chunks,
                stream)
    _build.check(rc, "masked_project")
    masked_project.launches += 1
    return c


masked_project.launches = 0


def project_update_norm(Vt, w, c, n_active):
    """``(w', ||w'||^2)`` with ``w' = w - sum_{r < n_active} c[r] Vt[r]``.

    ``c`` has shape (m+1,); entries past ``n_active`` are ignored.  The
    squared norm is a 0-d tensor on the operands' device.
    """
    n_active = int(n_active)
    cuda = _build.on_cuda("project_update_norm", Vt, w, c)
    _check_basis("project_update_norm", Vt, w, n_active)
    if c.shape != (Vt.shape[0],):
        raise ValueError(f"project_update_norm: c {tuple(c.shape)}, Vt "
                         f"{tuple(Vt.shape)}")
    if not cuda:
        return project_update_norm_plain(Vt, w, c, n_active)
    n = Vt.shape[1]
    fn = _build.kernel_fn("arn_project_update_norm", Vt.dtype)
    n_blocks = -(-n // _build.library().arn_update_cols_per_block())
    w_new = torch.empty_like(w)
    norm_sq = torch.empty((), dtype=Vt.dtype, device=Vt.device)
    partials = torch.empty(n_blocks, dtype=Vt.dtype, device=Vt.device)
    guard, stream = _build.launch_context(Vt.device)
    with guard:
        rc = fn(Vt.data_ptr(), w.data_ptr(), c.data_ptr(), w_new.data_ptr(),
                partials.data_ptr(), norm_sq.data_ptr(), n, n_active, n_blocks,
                stream)
    _build.check(rc, "project_update_norm")
    project_update_norm.launches += 1
    return w_new, norm_sq


project_update_norm.launches = 0


def cgs2_fused(Vt, w, n_active, *, tol=1e-8, eta=None):
    """Twice-is-enough CGS from the fused passes (``cgs2_pallas``'s
    composition): returns ``(c1 + c2, w2, beta, beta < tol)`` with ``h``
    zero past ``n_active`` and ``beta`` a 0-d tensor.  ``eta`` is accepted
    for the ortho-kernel signature and unused (both passes always run)."""
    c1 = masked_project(Vt, w, n_active)
    w1, _ = project_update_norm(Vt, w, c1, n_active)
    c2 = masked_project(Vt, w1, n_active)
    w2, norm_sq = project_update_norm(Vt, w1, c2, n_active)
    beta = torch.sqrt(norm_sq)
    return c1 + c2, w2, beta, beta < tol
