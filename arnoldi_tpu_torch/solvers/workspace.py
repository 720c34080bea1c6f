"""Where a restarted solve keeps its Krylov factorization: on the
operator's device, or on the host tier.

Both drivers (``partial_schur`` and ``partial_eigh``) run one restart loop
over either workspace; only the expansion, the truncation and the pull of
the small projected matrix differ.

* :class:`DeviceWorkspace` -- ``V: (m+b, n)`` (the transposed basis, one
  Krylov vector per row), a second buffer for the double-buffered
  truncation, and ``H: (m+b, m)``, all on the operator's device in the work
  dtype; the expansion is :func:`arnoldi_expand` or, for ``b > 1``,
  :func:`block_arnoldi_expand`.
* :class:`HostWorkspace` -- the same arrays as float64 or complex128 NumPy
  arrays: the JAX package's host tier
  (``arnoldi_tpu/solvers/krylov_schur.py:308-358``).  Below a few 10^4 rows
  a solve's per-step launches and syncs cost more than its arithmetic, so
  small SciPy/NumPy problems run in NumPy/BLAS, or in the C++ engine
  (``arnoldi_tpu/native/host_engine.cpp``, float64 only) for sparse input,
  and launch no kernel.  :func:`uses_host_tier` is the routing rule.
"""

import os

import numpy as np
import scipy.sparse as sp
import torch

from ..native import host_engine
from ..device import numpy_dtype, work_dtype
from .decomposition import (HOST_ORTHO, arnoldi_expand, block_arnoldi_expand,
                            host_arnoldi_expand)

#: Host-tier row cap (override with ARNOLDI_HOST_TIER_N): the JAX package's
#: ``_HOST_TIER_MAX_N``.
HOST_TIER_MAX_N = 32768


def uses_host_tier(A, *, device, dtype=None, block_size=1, ortho="cgs_dgks",
                   v0=None):
    """True when a solve of ``A`` runs on the host tier.

    The JAX package's rule (``krylov_schur.py:324-328``, ``lanczos.py:
    367-372``): ``A`` is a SciPy sparse matrix or a 2-D NumPy array, the
    driver is scalar (``block_size == 1``), the work dtype
    (:func:`~..device.work_dtype` of ``A.dtype``, ``dtype`` and ``v0``: int64
    input works in float64) is float64 or complex128, ``ortho`` is one of
    ``HOST_ORTHO``, and either
    n is at most ``ARNOLDI_HOST_TIER_N`` (default 32768) or the target
    ``device`` is the CPU (the port's form of JAX's CPU backend, where the
    tier takes every size).  A torch operator or tensor never qualifies,
    nor does host input without a ``device``.
    """
    if device is None or int(block_size) != 1:
        return False
    if not (sp.issparse(A) or (isinstance(A, np.ndarray) and A.ndim == 2)):
        return False
    if not (isinstance(ortho, str) and ortho in HOST_ORTHO):
        return False
    if work_dtype(A.dtype, dtype, v0) not in (torch.float64, torch.complex128):
        return False
    cap = int(os.environ.get("ARNOLDI_HOST_TIER_N", HOST_TIER_MAX_N))
    return A.shape[0] <= cap or torch.device(device).type == "cpu"


def _truncate(V, V_alt, Qp, m, p, carry):
    """``V_alt[:p] = Qp^T V[:m]`` with the ``carry`` residual rows
    ``V[m:m+carry]`` carried to ``V_alt[p:p+carry]``; returns the swapped
    pair ``(V_alt, V)``.  Rows past ``p + carry`` of the new basis are
    stale: the expansions read the rows before their step only.  Writing
    into the second buffer avoids an (m+b, n) allocation per restart."""
    if isinstance(V, np.ndarray):
        np.matmul(Qp.T, V[:m], out=V_alt[:p])
    else:
        torch.matmul(Qp.T, V[:m], out=V_alt[:p])
    V_alt[p:p + carry] = V[m:m + carry]
    return V_alt, V


class DeviceWorkspace:
    """The factorization on ``op``'s device, in ``op``'s dtype.

    Under a row ``mesh`` ``op`` is this rank's sharded operator: ``V``
    holds the rank's columns of the basis (``op.shape`` is local), ``H`` is
    replicated, the expansions sum their projections and norms over the
    ranks, and the truncation stays a local gemm with no communication."""

    host = False

    def __init__(self, op, max_dim, b, ortho, clock, mesh=None):
        n = op.shape[0]
        self.op, self.max_dim, self.b, self.ortho, self.clock = (
            op, max_dim, b, ortho, clock)
        self.mesh = mesh
        self.np_dtype = numpy_dtype(op.dtype)
        self.V = torch.zeros((max_dim + b, n), dtype=op.dtype, device=op.device)
        self.V_alt = torch.empty_like(self.V)
        self.H = torch.zeros((max_dim + b, max_dim), dtype=op.dtype,
                             device=op.device)

    def _tensor(self, a):
        if torch.is_tensor(a):
            return a
        return torch.from_numpy(np.ascontiguousarray(a, self.np_dtype)).to(
            self.V.device)

    def set_start(self, rows):
        """Rows ``0..len(rows)`` of the basis: the (orthonormal) start block."""
        self.V[:rows.shape[0]] = rows

    def expand(self, start, tol, *, stop_at_breakdown=True):
        """Expand from row ``start`` (a multiple of b) towards ``max_dim``;
        returns the dimension reached (less on breakdown).  With
        ``stop_at_breakdown=False`` no flag is read on the host and the
        return is the expansions' 0-d bool breakdown tensor."""
        with self.clock("expand") as phase:
            if self.b > 1:
                self.V, self.H, jb = block_arnoldi_expand(
                    self.op, self.V, self.H, tol, start_block=start // self.b,
                    n_blocks=self.max_dim // self.b, b=self.b,
                    stop_at_breakdown=stop_at_breakdown, mesh=self.mesh,
                    clock=self.clock)
                phase.count = ((jb if stop_at_breakdown else self.max_dim // self.b)
                               - start // self.b)
                return jb * self.b if stop_at_breakdown else jb
            self.V, self.H, m = arnoldi_expand(
                self.op, self.V, self.H, tol, start_dim=start,
                max_dim=self.max_dim, ortho=self.ortho,
                stop_at_breakdown=stop_at_breakdown, mesh=self.mesh,
                clock=self.clock)
            phase.count = (m if stop_at_breakdown else self.max_dim) - start
            return m

    def h_host(self):
        """A float64 (complex128 for a complex H) NumPy copy of H."""
        with self.clock("h_pull"):
            H = self.H.cpu().numpy()
            return H.astype(np.complex128 if np.iscomplexobj(H) else np.float64)

    def set_h(self, H_new):
        self.H = self._tensor(H_new)

    def truncate(self, Qp, m, p):
        """``V[:p] = Qp^T V[:m]``, carrying the b residual rows to p."""
        with self.clock("truncate"):
            self.V, self.V_alt = _truncate(self.V, self.V_alt,
                                           self._tensor(Qp), m, p, self.b)

    def restart(self, Qp, H_new, m, p):
        """Truncate to p rows and install the truncated H; the next
        :meth:`expand` goes on from p."""
        self.truncate(Qp, m, p)
        self.set_h(H_new)

    def rotate_head(self, Qs, rows):
        """``V[:rows] = Qs^T V[:rows]``."""
        self.V[:rows] = self._tensor(Qs).T @ self.V[:rows]

    def rows(self, k):
        """The first k basis rows as an (n, k) tensor, copied out of the
        workspace."""
        return self.V[:k].clone().T


class HostWorkspace:
    """The factorization of a SciPy/NumPy ``A`` in float64 or complex128
    NumPy arrays (``dtype``).

    Float64 sparse input expands in the C++ engine when it builds (``g++``
    on first use, next to its source) and in NumPy otherwise; ``engine``
    says which.  Complex128 runs in NumPy, as the JAX package's engine takes
    float64 only (``arnoldi_tpu/solvers/krylov_schur.py:353-357``).  Results
    leave it as tensors on ``device``.
    """

    host = True

    def __init__(self, A, max_dim, ortho, clock, device, dtype=np.float64):
        self.max_dim, self.ortho, self.clock = max_dim, ortho, clock
        self.device = torch.device(device)
        self.dtype = np.dtype(dtype)
        if sp.issparse(A):
            A_h = A.astype(self.dtype).tocsr()
        else:
            A_h = np.ascontiguousarray(A, dtype=self.dtype)
        self.matvec = lambda v: A_h @ v
        self.engine = (host_engine.engine_for(A, np.float64, max_dim, ortho)
                       if self.dtype == np.float64 else None)
        self._cycle = None      # a truncation the next expand fuses
        n = A.shape[0]
        self.V = np.zeros((max_dim + 1, n), dtype=self.dtype)
        self.V_alt = np.empty_like(self.V)
        self.H = np.zeros((max_dim + 1, max_dim), dtype=self.dtype)

    def set_start(self, rows):
        self.V[:rows.shape[0]] = rows.cpu().numpy()

    def expand(self, start, tol):
        if self._cycle is not None:
            Qp, m, p = self._cycle
            self._cycle = None
            with self.clock("engine.cycle"):
                out, self.H, m_new = self.engine.cycle(
                    self.V, self.V_alt, self.H, Qp, m=m, pa=p, carry=1,
                    max_dim=self.max_dim, tol=tol, ortho=self.ortho)
            self.V, self.V_alt = out, self.V
            return int(m_new)
        if self.engine is not None:
            with self.clock("engine.expand"):
                self.V, self.H, m = self.engine.expand(
                    self.V, self.H, tol, start_dim=start, max_dim=self.max_dim,
                    ortho=self.ortho)
                return int(m)
        with self.clock("host.expand"):
            self.V, self.H, m = host_arnoldi_expand(
                self.matvec, self.V, self.H, tol, start_dim=start,
                max_dim=self.max_dim, ortho=self.ortho)
            return m

    def h_host(self):
        return self.H.copy()

    def set_h(self, H_new):
        self.H = np.array(H_new, dtype=self.dtype)

    def truncate(self, Qp, m, p):
        self.V, self.V_alt = _truncate(self.V, self.V_alt,
                                       np.asarray(Qp, self.dtype), m, p, 1)

    def restart(self, Qp, H_new, m, p):
        """Truncate to p rows and install the truncated H.  With the engine
        the truncation waits for the next :meth:`expand`, which runs both
        in one fused C call (``CsrEngine.cycle``), as the JAX package's
        host tier does."""
        self.set_h(H_new)
        if self.engine is None:
            self.truncate(Qp, m, p)
        else:
            self._cycle = (Qp, m, p)

    def rotate_head(self, Qs, rows):
        self.V[:rows] = Qs.T @ self.V[:rows]

    def rows(self, k):
        """The first k basis rows as an (n, k) tensor on ``device``: the
        one copy off the host."""
        return torch.from_numpy(np.ascontiguousarray(self.V[:k].T)).to(
            self.device)
