"""Refinement: a float32 solve continued in float64 below the float32 floor.

Counterpart of ``arnoldi_tpu/solvers/refine.py`` without its double-word
arithmetic.  A plain float32 Krylov process bottoms out near a relative
residual of 1e-6; the JAX package reaches tol 1e-8 on the TPU, which has no
float64, by continuing the float32 solve with every n-sized quantity carried
as a pair of float32 limbs (``ops/df32.py``, ``ops/df32_linop.py``).
Hopper has float64 (``ROADMAP.md``, North star), so the port continues in
plain float64 instead: ``dw_cgs2``, the ``_dw_*`` expansion and truncation,
``_combine_limbs_transposed``, ``build_cast_residual_operator``,
``build_padded_cast_residual``, ``ops/df32.py`` and ``ops/df32_linop.py``
have no counterpart here.

The shape of a refined solve is the JAX package's
(``arnoldi_tpu/solvers/krylov_schur.py:282-306, 904-940``,
``lanczos.py:307-352``): the float32 phase runs to ``max(tol, 2e-4)``, its
converged Schur rows are mixed into one start vector
(:func:`refinement_start_vector`), and a Krylov-Schur solve in a compact
subspace continues from it to the requested tolerance
(:func:`refine_schur`, JAX's loop: p pinned, no locking) on
:func:`exact_operator`, the operator the caller gave at its own values: an
operator built from a float64 source keeps every bit, where JAX adds the
cast residual ``op_lo`` to its float32 operator.
"""

import numpy as np
import torch

from ..linop import FORMAT_OPERATORS, CallableOperator, cast_operator
from ..ops import dense_tier
from ..ops.ortho import vector_norm
from ..utils.profiling import NULL_CLOCK
from .decomposition import default_invariant_tol
from .workspace import DeviceWorkspace

__all__ = ["check_refine", "continue_refined", "exact_operator",
           "refine_schur", "refinement_start_vector", "refines"]

#: The values ``refine=`` takes: "auto", "dw" (always) and the three "off"s.
REFINE_CHOICES = ("auto", "dw", None, "none", False)

#: Below this tolerance a float32 solve is refined under ``refine="auto"``.
AUTO_BELOW = 1e-6

#: The float32 phase's tolerance floor.
FLOAT32_PHASE_TOL = 2e-4


def check_refine(refine):
    """Raise ``ValueError`` for a ``refine=`` value no driver takes."""
    if refine not in REFINE_CHOICES:
        raise ValueError(f"refine={refine!r}: expected 'auto', 'dw' or None")


def has_exact_operator(op):
    """True when a refined solve of ``op`` can continue on exact values: a
    format operator, an operator with a ``cast(dtype)`` method (it casts
    its own values), a :class:`CallableOperator` with ``fn_f64``, or a Gram
    whose legs are format operators."""
    return (isinstance(op, FORMAT_OPERATORS) or hasattr(op, "cast")
            or (isinstance(op, CallableOperator) and op.fn_f64 is not None)
            or getattr(op, "has_dw", False))


def refines(refine, op, wdtype, tol):
    """The JAX package's rule: ``"dw"`` always refines a real solve and
    raises ``ValueError`` for a complex one (JAX asserts the real float32
    path, ``arnoldi_tpu/solvers/krylov_schur.py:305``); ``"auto"`` refines
    a real float32 solve to a tolerance below 1e-6 on an operator
    :func:`has_exact_operator` accepts; None, "none" and False never do.
    ``op`` is None on the host tier, which never refines.  ``refine`` has
    passed :func:`check_refine`."""
    if refine == "dw":
        if wdtype.is_complex:
            raise ValueError(f"refine='dw' refines a real solve; the work "
                             f"dtype is {wdtype}")
        return True
    return (refine == "auto" and op is not None and wdtype == torch.float32
            and tol < AUTO_BELOW and has_exact_operator(op))


def exact_operator(op):
    """The operator a refined solve continues on: ``op`` at its own values
    in float64 (a float32 operator is promoted exactly, so the float32
    matrix is the target), a callable's ``fn_f64``, or a Gram's legs at
    their own values; an operator with a ``cast`` method casts itself."""
    if isinstance(op, CallableOperator):
        if op.fn_f64 is None:
            raise TypeError(
                "this CallableOperator has no float64 matvec (fn_f64) to "
                "refine on; pass fn_f64= or use a format operator")
        return CallableOperator(op.fn_f64, op.shape, torch.float64, op.nnz,
                                device=op.device)
    return cast_operator(op, torch.float64)


def refinement_start_vector(Vt, nev_ret, mesh=None):
    """The continuation's start vector: the first ``nev_ret`` basis rows
    mixed with weights 1/(i+1) (fixed weights keep symmetric components from
    cancelling), normalized, on ``Vt``'s device in its dtype; row 0 alone
    if the mix is zero.  No host read.  Under a ``mesh`` ``Vt`` is this
    rank's columns and the norms are the whole vector's."""
    rows = torch.as_tensor(Vt)[:nev_ret]
    w = 1.0 / (1.0 + torch.arange(rows.shape[0], dtype=rows.dtype,
                                  device=rows.device))
    v0 = (w[:, None] * rows).sum(dim=0)
    nrm = vector_norm(v0, mesh)
    fallback = rows[0] / torch.clamp(vector_norm(rows[0], mesh),
                                     min=torch.finfo(rows.dtype).tiny)
    return torch.where(nrm > 0, v0 / torch.where(nrm > 0, nrm, 1.0), fallback)


def refine_schur(op64, v0, nev, *, max_dim, p, tol, sort_function,
                 max_restarts=100, clock=None, mesh=None):
    """Krylov-Schur in float64 on ``op64`` from ``v0`` until the ``nev``
    wanted pairs all reach relative residual ``tol``: the loop of
    ``refine_schur_dw`` (``arnoldi_tpu/solvers/refine.py:238-423``) in
    plain float64.  The expansion runs on the device workspace with
    ``ortho="cgs2"`` (the fused CGS2 kernels on the card); the ordered
    real Schur form and the truncation geometry are the host's, with p
    pinned (a 1x1 block relocated, or the cut stepped, where a pair would
    straddle it) and no locking: converged pairs keep improving while the
    rest converge.

    Returns ``(Q, T, n_restarts, n_matvecs)``: Q (n, nev_ret) and T
    (nev_ret, nev_ret) float64 tensors on ``op64``'s device (nev_ret = nev
    + 1 when a 2x2 block straddles nev), as the JAX version returns them
    on the host.  ``clock`` times the whole as ``refine.continue``.  Under a
    row ``mesh`` ``op64`` is this rank's sharded operator, ``v0`` and Q
    its rows."""
    from .krylov_schur import _schur_blocks

    clock = NULL_CLOCK if clock is None else clock
    n = op64.shape[0]
    if not nev <= p < max_dim <= n:
        raise ValueError(f"need nev <= p < max_dim <= n, got {nev}, {p}, "
                         f"{max_dim}, {n}")
    inv_tol = default_invariant_tol(torch.float64)
    with clock("refine.continue"):
        ws = DeviceWorkspace(op64, max_dim, 1, "cgs2", clock, mesh=mesh)
        v0 = torch.as_tensor(v0).to(device=op64.device, dtype=torch.float64)
        ws.set_start((v0 / vector_norm(v0, mesh))[None, :])
        m = ws.expand(0, inv_tol)
        total_matvecs = m
        for restart in range(max_restarts):
            happy_breakdown = m != max_dim
            if happy_breakdown and m < nev:
                raise ValueError(f"Invariant subspace of dimension {m} < "
                                 f"nev={nev} in refinement")
            H_host = ws.h_host()
            T2, Q, eigs = dense_tier.ordered_schur_real(
                H_host[:m, :m], sort_function=sort_function)
            starts, sizes, in_block = _schur_blocks(T2)
            pa = min(p, m) if happy_breakdown else p
            if in_block[pa]:
                try:
                    T2, Q = dense_tier.resolve_straddle(T2, Q, pa,
                                                        min_keep=nev)
                    starts, sizes, in_block = _schur_blocks(T2)
                    eigs = dense_tier.real_schur_eigvals(T2)
                except RuntimeError:
                    # No prefix-safe relocation: step the cut, up first.
                    limit = m if happy_breakdown else m - 1
                    if pa + 1 <= limit and not in_block[pa + 1]:
                        pa += 1
                    elif pa - 1 >= nev and not in_block[pa - 1]:
                        pa -= 1
                    else:
                        raise ValueError(
                            "Cannot truncate without splitting a conjugate "
                            "pair; increase max_dim or p") from None
            Qp = Q[:, :pa]
            H_new = np.zeros((max_dim + 1, max_dim))
            H_new[:pa, :pa] = T2[:pa, :pa]
            H_new[pa, :pa] = H_host[m, :m] @ Qp

            last_row = np.abs(Q[m - 1, :])
            for s, sz in zip(starts, sizes):
                if sz == 2:
                    last_row[s] = last_row[s + 1] = np.hypot(
                        Q[m - 1, s], Q[m - 1, s + 1])
            denom = np.abs(eigs)
            rel = (np.abs(H_host[m, m - 1]) * last_row
                   / np.where(denom == 0, 1.0, denom))
            converged = bool(np.all(rel[:nev] < tol))
            if not converged and happy_breakdown and pa >= m:
                raise ValueError(f"refinement saturated at dimension {m} "
                                 "without convergence")
            ws.truncate(Qp, m, pa)
            if converged:
                nev_ret = nev + 1 if in_block[nev] else nev
                T = torch.from_numpy(H_new[:nev_ret, :nev_ret].copy())
                return (ws.rows(nev_ret), T.to(op64.device), restart + 1,
                        total_matvecs)
            ws.set_h(H_new)
            m_new = ws.expand(pa, inv_tol)
            total_matvecs += m_new - pa
            m = m_new
    raise ValueError("Has not converged !")


def continue_refined(op, v0, nev, *, max_dim, tol, sort_function,
                     max_restarts, clock, mesh=None):
    """The float64 continuation of a converged float32 phase on ``op`` (the
    caller's operator, before its float32 cast) from ``v0``: JAX's compact
    subspace, ``max_dim_r = min(max_dim, max(2 nev + 6, 16))`` with ``p_r =
    min(nev + 5, max_dim_r - 1)`` (each of its restarts costs as much as a
    float64 solve's, and the warm start needs few).  Returns what
    :func:`refine_schur` returns."""
    max_dim_r = min(max_dim, max(2 * nev + 6, 16))
    p_r = min(nev + 5, max_dim_r - 1)
    return refine_schur(exact_operator(op), v0, nev, max_dim=max_dim_r,
                        p=p_r, tol=tol, sort_function=sort_function,
                        max_restarts=max_restarts, clock=clock, mesh=mesh)
