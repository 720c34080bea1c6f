"""Arnoldi expansion (the hot loop) and Ritz extraction.

Counterpart of ``arnoldi_tpu/solvers/decomposition.py``: the scalar and
block expansions on a device, the host tier's NumPy expansion
(:func:`host_arnoldi_expand`), the reference-signature driver
:func:`arnoldi_decomposition` and :class:`RitzDecomposition`. The
factorization lives in two tensors updated in place: ``Vt: (m+1, n)`` (the
transposed basis, one Krylov vector per contiguous row) and ``H: (m+1, m)``.
PyTorch runs eagerly and does not compile per shape, so each step projects
against exactly its ``j + 1`` active rows (the JAX version masks a
static-shape workspace and slices it in segments), and a breakdown leaves
the Python loop at once instead of running masked dead steps.
"""

import dataclasses

import numpy as np
import torch

from ..utils import sorting
from ..linop import as_operator, cast_operator
from ..ops.ortho import M_SQRT1_2, block_cgs2, resolve_ortho


def default_invariant_tol(dtype):
    """sqrt(eps) of ``dtype`` (torch or NumPy)."""
    if isinstance(dtype, torch.dtype):
        return float(np.sqrt(torch.finfo(dtype).eps))
    return float(np.sqrt(np.finfo(np.dtype(dtype)).eps))


def _any_breakdown(flags, like):
    """The OR of a step's 0-d bool breakdown flags, on ``like``'s device."""
    if not flags:
        return torch.zeros((), dtype=torch.bool, device=like.device)
    return torch.stack(flags).any()


def arnoldi_expand(op, Vt, H, invariant_tol=None, *, start_dim=0, max_dim=None,
                   ortho="cgs_dgks", stop_at_breakdown=True):
    """Extend the Arnoldi factorization ``(Vt, H)`` of ``op`` in place.

    Rows ``0..start_dim`` of ``Vt`` are valid (row ``start_dim`` is the next
    unit start vector) and columns ``0..start_dim - 1`` of ``H``.  Each step
    ``j`` writes column ``j`` of ``H`` (the projection coefficients in rows
    ``0..j``, the coupling ``beta`` in row ``j + 1``, zeros below) and row
    ``j + 1`` of ``Vt``.  On breakdown (``beta < invariant_tol``) the loop
    stops with ``H[j+1, j] = 0`` and the raw orthogonalized vector in
    ``Vt[j+1]``, the contract of the JAX version's masked loop.

    Returns ``(Vt, H, n_iter)``; ``n_iter < max_dim`` iff the expansion hit
    an invariant subspace (happy breakdown).  That costs one host read of
    the breakdown flag per step.  ``stop_at_breakdown=False`` reads none:
    every step runs, and the third value is a 0-d bool tensor on the
    device, True when a step broke down (the factorization is then not
    valid), for a caller that discards the workspace on breakdown.
    """
    m = Vt.shape[0] - 1
    n = op.shape[0]
    if op.shape[1] != n:
        raise ValueError("A is expected to be a square operator")
    if Vt.shape != (m + 1, n) or H.shape != (m + 1, m):
        raise ValueError(f"Vt {tuple(Vt.shape)} / H {tuple(H.shape)} do not "
                         f"fit an (m+1, n) = ({m + 1}, {n}) workspace")
    if op.dtype != Vt.dtype or H.dtype != Vt.dtype:
        raise TypeError(f"operator {op.dtype}, Vt {Vt.dtype}, H {H.dtype}: "
                        "one dtype expected")
    max_dim = m if max_dim is None else int(max_dim)
    if not 0 <= start_dim <= max_dim <= m:
        raise ValueError(f"need 0 <= start_dim <= max_dim <= {m}, got "
                         f"{start_dim}, {max_dim}")
    if invariant_tol is None:
        invariant_tol = default_invariant_tol(op.dtype)
    ortho_fn = resolve_ortho(ortho)

    flags = []
    for j in range(start_dim, max_dim):
        w = op.matvec(Vt[j])
        h, w, beta, breakdown = ortho_fn(Vt, w, j + 1, tol=invariant_tol)
        H[:, j] = h
        if not stop_at_breakdown:
            flags.append(breakdown)
        elif bool(breakdown):
            H[j + 1, j] = 0
            Vt[j + 1] = w
            return Vt, H, j + 1
        H[j + 1, j] = beta
        torch.div(w, beta, out=Vt[j + 1])
    return Vt, H, max_dim if stop_at_breakdown else _any_breakdown(flags, Vt)


def block_arnoldi_expand(op, Vt, H, invariant_tol, *, start_block, n_blocks, b,
                         stop_at_breakdown=True):
    """Block Arnoldi expansion of ``(Vt, H)`` in place: b vectors per step.

    Counterpart of ``_block_expand_jit`` (its window ``_block_expand_window``).
    Block ``j`` occupies rows ``j*b..(j+1)*b`` of ``Vt: (n_blocks*b + b, n)``;
    on entry the block at ``start_block`` holds orthonormal rows.  Step
    ``j`` applies the operator to block ``j`` (``op.matmat_rows``, the
    b-column kernels, on the rows as they lie), runs :func:`block_cgs2`
    against the ``(j+1)*b`` rows before it, and writes the coefficients into
    column block ``j`` of ``H: (n_blocks*b + b, n_blocks*b)`` with ``R`` in
    rows ``(j+1)*b..(j+2)*b``, and ``Q`` into block ``j + 1`` of ``Vt``.  A
    rank-deficient step (breakdown) writes nothing and ends the loop: one
    host read of the flag per step, where the JAX version runs the
    remaining steps dead.

    Returns ``(Vt, H, n_done_blocks)``; ``n_done_blocks < n_blocks`` iff a
    step broke down.  ``stop_at_breakdown=False`` reads no flag, runs every
    step and returns a 0-d bool tensor in its place, as
    :func:`arnoldi_expand` does.
    """
    n = op.shape[0]
    if op.shape[1] != n:
        raise ValueError("A is expected to be a square operator")
    rows = n_blocks * b + b
    if Vt.shape != (rows, n) or H.shape != (rows, n_blocks * b):
        raise ValueError(f"Vt {tuple(Vt.shape)} / H {tuple(H.shape)} do not "
                         f"fit {n_blocks} blocks of {b} rows, n = {n}")
    if op.dtype != Vt.dtype or H.dtype != Vt.dtype:
        raise TypeError(f"operator {op.dtype}, Vt {Vt.dtype}, H {H.dtype}: "
                        "one dtype expected")
    if not 0 <= start_block <= n_blocks:
        raise ValueError(f"need 0 <= start_block <= {n_blocks}, got {start_block}")
    flags = []
    for j in range(start_block, n_blocks):
        lo, mid, hi = j * b, (j + 1) * b, (j + 2) * b
        W = op.matmat_rows(Vt[lo:mid])
        C, Q, R, breakdown = block_cgs2(Vt, W, mid, tol=invariant_tol)
        if not stop_at_breakdown:
            flags.append(breakdown)
        elif bool(breakdown):
            return Vt, H, j
        H[:, lo:mid] = C
        H[mid:hi, lo:mid] = R
        Vt[mid:hi] = Q
    return Vt, H, n_blocks if stop_at_breakdown else _any_breakdown(flags, Vt)


#: Ortho kernels the host tier mirrors (names shared with ``ops/ortho.py``).
HOST_ORTHO = ("cgs_dgks", "cgs2", "mgs_dgks")


def host_arnoldi_expand(matvec, Vt, H, invariant_tol, *, start_dim, max_dim,
                        ortho="cgs_dgks"):
    """Host (NumPy/BLAS) Arnoldi expansion of the host tier: the contract
    of :func:`arnoldi_expand` on float64 ndarrays, mutated in place;
    returns ``(Vt, H, n_iter)``.

    A copy of the JAX package's NumPy function (whose module imports JAX):
    CGS with the DGKS criterion (one second pass when the norm drops below
    sqrt(1/2) of its value, always for ``cgs2``) or MGS with the same
    criterion (``mgs_dgks``); on breakdown the raw vector is stored with a
    zero coupling.  The coefficients are ``Vj @ w``: only the (n,) vector
    would be conjugated, never the (j+1, n) slab.
    """
    for j in range(start_dim, max_dim):
        w = matvec(Vt[j])
        Vj = Vt[: j + 1]
        if ortho == "mgs_dgks":
            beta_before = np.linalg.norm(w)
            c = np.zeros(j + 1, dtype=Vt.dtype)
            for i in range(j + 1):
                ci = np.vdot(Vj[i], w)
                w = w - ci * Vj[i]
                c[i] = ci
            beta = np.linalg.norm(w)
            if beta < M_SQRT1_2 * beta_before:
                for i in range(j + 1):
                    ci = np.vdot(Vj[i], w)
                    w = w - ci * Vj[i]
                    c[i] += ci
                beta = np.linalg.norm(w)
        else:
            cplx = np.iscomplexobj(Vt)
            beta_before = np.linalg.norm(w)
            c = np.conj(Vj @ np.conj(w)) if cplx else Vj @ w
            w = w - c @ Vj
            beta = np.linalg.norm(w)
            if ortho == "cgs2" or beta < M_SQRT1_2 * beta_before:
                c2 = np.conj(Vj @ np.conj(w)) if cplx else Vj @ w
                w = w - c2 @ Vj
                c = c + c2
                beta = np.linalg.norm(w)
        H[: j + 1, j] = c
        if beta < invariant_tol:
            H[j + 1, j] = 0.0
            Vt[j + 1] = w
            return Vt, H, j + 1
        H[j + 1, j] = beta
        Vt[j + 1] = w / beta
    return Vt, H, max_dim


def _operator_like(A, like):
    """``A`` as an operator on ``like``'s device in its dtype."""
    return cast_operator(as_operator(A, device=like.device), like.dtype)


def arnoldi_decomposition(A, V, H, invariant_tol=None, *, start_dim=0,
                          max_dim=None, ortho="cgs_dgks"):
    """Reference-signature driver: takes and returns the reference's
    ``V: (n, m+1)`` orientation.

    ``V`` and ``H`` are tensors (or arrays, moved to the CPU) holding the
    factorization's first ``start_dim`` columns and the unit start vector
    in column ``start_dim``; ``A`` becomes an operator on ``V``'s device.
    Returns ``(V[:, :n_iter+1], H[:n_iter+1, :n_iter], n_iter)`` as new
    tensors (the inputs are not modified).
    """
    V = torch.as_tensor(V)
    H = torch.as_tensor(H).to(V).clone()
    Vt = V.T.contiguous()
    Vt, H, n_iter = arnoldi_expand(_operator_like(A, Vt), Vt, H, invariant_tol,
                                   start_dim=start_dim, max_dim=max_dim,
                                   ortho=ortho)
    return Vt[: n_iter + 1].T, H[: n_iter + 1, :n_iter], n_iter


@dataclasses.dataclass
class RitzDecomposition:
    """Ritz eigenpair approximations extracted from an Arnoldi factorization.

    ``values`` (host, NumPy), ``vectors`` ((n, n_ritz) tensor on the basis'
    device, complex when the Ritz values are) and ``approximate_residuals``
    ``|h_{m+1,m} s_i[-1]|``, which equal ``||A u_i - lambda_i u_i||``.
    """

    values: np.ndarray
    vectors: torch.Tensor
    approximate_residuals: np.ndarray

    @classmethod
    def from_v_and_h(cls, V, H, n_ritz, *, max_dim=None, sort_function=None):
        """Extract ``n_ritz`` Ritz pairs from ``V: (n, m+1)`` and ``H``,
        either the full workspace with ``max_dim`` its active length or
        truncated reference-style arrays."""
        V = torch.as_tensor(V)
        if max_dim is None:
            max_dim = V.shape[1] - 1
        return cls.from_vt_and_h(V.T, H, n_ritz, max_dim=max_dim,
                                 sort_function=sort_function)

    @classmethod
    def from_vt_and_h(cls, Vt, H, n_ritz, *, max_dim=None, sort_function=None):
        """Like :meth:`from_v_and_h` with the transposed basis
        ``Vt: (m+1, n)``; the vectors still come back as (n, n_ritz)."""
        Vt = torch.as_tensor(Vt)
        if max_dim is None:
            max_dim = Vt.shape[0] - 1
        if not (H.shape[0] > max_dim and H.shape[1] >= max_dim
                and Vt.shape[0] > max_dim and n_ritz <= max_dim):
            raise ValueError(f"Vt {tuple(Vt.shape)} / H {tuple(H.shape)} do "
                             f"not hold {n_ritz} Ritz pairs of dimension "
                             f"{max_dim}")
        sort_function = sorting.sort_function_for(
            sorting.arg_largest_magnitude if sort_function is None
            else sort_function)

        # The small eigenproblem in float64 on the host, whatever the basis
        # dtype: float32 would put ~1e-6 noise on values and residuals.
        H_host = (H.cpu().numpy() if torch.is_tensor(H) else np.asarray(H))
        H_host = H_host.astype(np.complex128 if np.iscomplexobj(H_host)
                               else np.float64)
        eigvals, eigvecs = np.linalg.eig(H_host[:max_dim, :max_dim])
        ind = np.asarray(sort_function(eigvals))[:n_ritz]
        S = eigvecs[:, ind]

        Vt_m = Vt[:max_dim]
        if np.iscomplexobj(S) and not Vt_m.is_complex():
            # Real basis, complex Ritz vectors: two real matmuls.
            vr = torch.from_numpy(np.ascontiguousarray(S.real.T)).to(Vt_m) @ Vt_m
            vi = torch.from_numpy(np.ascontiguousarray(S.imag.T)).to(Vt_m) @ Vt_m
            vectors = torch.complex(vr, vi).T
        else:
            vectors = (torch.from_numpy(np.ascontiguousarray(S.T)).to(Vt_m)
                       @ Vt_m).T
        residuals = np.abs(H_host[max_dim, max_dim - 1] * S[-1])
        return cls(eigvals[ind], vectors, residuals)

    def compute_true_residuals(self, A):
        """``res[i] = ||A v_i - lambda_i v_i||`` (n_ritz matvecs with A)."""
        vecs = self.vectors
        if vecs.is_complex():
            # A real operator applied to the real and imaginary parts.
            op = _operator_like(A, vecs.real)
            AV = torch.complex(op.matmat(vecs.real.contiguous()),
                               op.matmat(vecs.imag.contiguous()))
        else:
            AV = _operator_like(A, vecs).matmat(vecs.contiguous())
        lam = torch.from_numpy(np.asarray(self.values)).to(AV)
        return torch.linalg.vector_norm(AV - vecs * lam[None, :],
                                        dim=0).cpu().numpy()
