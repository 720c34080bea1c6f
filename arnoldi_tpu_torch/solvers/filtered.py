"""Chebyshev-filtered subspace iteration: interior eigenpairs without
linear solves (``eigsh_filtered``, ``eigsh_window``).

Counterpart of ``arnoldi_tpu/solvers/filtered.py``.  A Jackson-damped
Chebyshev expansion ``p`` of the indicator of the wanted window over the
spectral enclosure ``[lmin, lmax]`` maps wanted eigenvalues near 1 and the
rest near 0; subspace iteration with ``p(A)`` and Rayleigh-Ritz on ``A``
converges to the pairs inside the window, each sweep ``degree`` products
of the operator with the whole ``(s, n)`` row block (``op.matmat_rows``:
the b-column kernels at b = s on the card).

The three-term recurrence runs with Python-float coefficients and no host
read.  On a single-device real DIA operator each degree step is one launch
(``ops/kernels/cheby_banded``: the b-column kernel with the recurrence as
its epilogue); on every other operator it runs in place in eager PyTorch,
one b-column product and four elementwise passes over ``(s, n)`` blocks.
Every ``(s, s)`` Cholesky and ``eigh`` runs on the host in float64
(``_host_whiten``'s escalating shift), as in the JAX package: one ``(s,
s)`` copy a factorization.

The geometry is the JAX package's to the last rung: the filter degree
rounds up to ``_degree_rung``'s ladder (the degree is the polynomial), soft
locking refreshes ``_active_rows``' halving ladder of rows and the ghost
check filters 8-row buckets.  Both fix the iterates and the matvec counts,
so the CPU tests hold the counts equal to JAX's.

The API is the JAX package's with the port's conventions: ``generator=``
(a CPU ``torch.Generator``, drawn in order: the bounds' start vector, the
KPM probes, the subspace) replaces ``key=``, and ``device=`` places SciPy
and NumPy input.  On a card the subspace's start block comes from a card
generator seeded by one int64 draw of the CPU generator (the host draws
one number, not ``s x n``); on the CPU it is drawn from the generator
itself.  Eigenvalues come back as NumPy arrays, eigenvectors as
``(n, k)`` tensors on the operator's device.  ``refine=`` keeps the JAX
package's values; the double-word continuation (``filtered.py:986-1210``)
becomes the same sweep in float64 on the operator at its own values, as
``solvers/refine.py`` does for the extremal drivers.

``mesh=`` (an :class:`~..parallel.Mesh`) runs every driver SPMD over a
row mesh of ``torch.distributed`` ranks, as the JAX package runs them over
a device mesh (``arnoldi_tpu/solvers/filtered.py:77-80, 277-282, 649-655,
799-811, 1250-1255``): every rank calls the driver with the same
arguments and holds its row block of the operator (``shard_operator``'s
all-gather, or a ``HaloOperator`` passed in, whose mesh is the default)
and its columns of every ``(s, n)`` block.  The start block, the bounds'
start vector and the KPM probes are drawn whole on every rank and sliced
(on a card the start block from the one seed, in row chunks of at most
``ceil(s / ranks)`` rows), so a one-rank mesh repeats the unsharded solve
bit for bit.  Every reduction over n (the CholQR2 Grams, the Rayleigh-Ritz
matrix, row norms, the KPM moment vector once a pass) is a sum
all-reduce, so every host decision reads the same numbers on every rank.
Eigenvalues come back on every rank, eigenvectors as the rank's rows.
The row count must divide the mesh: a padded zero row would add the
eigenvalue 0, which a window holding 0 would return.
"""

import numpy as np
import scipy.linalg as sla
import torch

from ..device import check_matmul_precision, solver_dtype, torch_dtype
from ..linop import FORMAT_OPERATORS, BandedOperator, CallableOperator, cast_operator
from ..ops.kernels.cheby_banded import (DTYPES as _FUSED_DTYPES, _affine,
                                        cheby_banded, cheby_recurrence)
from ..ops.ortho import _reduce, block_cgs2
from ..parallel.mesh import local_rows
from ..parallel.sharded import check_operator_mesh, operator_mesh, shard_operator
from ..utils.history import History
from ..utils.profiling import NULL_CLOCK, phase_clock, solve_span
from ..utils.random import rand_normalized_vector
from . import refine as refinement
from .decomposition import arnoldi_expand
from .krylov_schur import check_mesh
from .spectral_transform import _operator

__all__ = [
    "eigsh_filtered",
    "eigsh_window",
    "estimate_window_count",
    "spectral_moments",
    "count_from_moments",
    "spectrum_bounds",
    "jackson_cheby_coeffs",
    "cheby_filter",
]

#: The KPM probe count of every moment pass (the JAX package's).
PROBES = 8


def _filter_operator(A, dtype, device, mesh):
    """``(op, mesh)``: ``A`` as an operator, and under a mesh (``mesh``, or
    that of a sharded ``A``) this rank's row block of it: a sharded
    operator of the mesh as it is, any other format operator through
    :func:`~..parallel.shard_operator` (the all-gather of x) on the mesh's
    device.  Raises ``ValueError`` when the mesh does not divide the row
    count (no silent padding: a zero row adds the eigenvalue 0) and
    ``TypeError`` for a callable."""
    mesh = check_mesh(A, mesh)
    if mesh is None:
        return _operator(A, dtype, device), None
    if check_operator_mesh(A, mesh):
        return (A if dtype is None else cast_operator(A, torch_dtype(dtype))), mesh
    op = _operator(A, dtype, mesh.device if device is None else device)
    if not isinstance(op, CallableOperator) and op.shape[0] % mesh.size:
        raise ValueError(
            f"n={op.shape[0]} does not divide the {mesh.size}-rank mesh; "
            "pad_operator first (the filtered drivers do not pad: a zero "
            "row adds the eigenvalue 0, which a window holding 0 returns)")
    return shard_operator(op, mesh), mesh


def _n_global(op):
    """The whole operator's row count (a sharded operator's ``n_global``)."""
    return getattr(op, "n_global", op.shape[0])


def _columns(W, mesh):
    """This rank's columns of a whole ``(..., n)`` block (``W`` without a
    mesh)."""
    if mesh is None:
        return W
    row0, row1 = local_rows(W.shape[-1], mesh)
    return W[..., row0:row1]


def _row_norms(Y, mesh):
    """The norms of the whole rows of ``Y`` whose columns the ranks hold."""
    nrm = torch.linalg.vector_norm(Y, dim=1)
    return nrm if mesh is None else torch.sqrt(mesh.all_reduce(nrm.square()))


def _generator(generator):
    return torch.Generator().manual_seed(0) if generator is None else generator


def spectrum_bounds(A, m=40, *, generator=None, dtype=None, mesh=None,
                    device=None, _v0=None):
    """Safe enclosure ``[lmin, lmax]`` of a Hermitian operator's spectrum
    from one ``m``-step Lanczos run (``decomposition.arnoldi_expand``:
    the scalar SpMV kernel and the fused CGS passes on the card).

    The extremal Ritz values are widened by their Lanczos residual bounds
    ``|beta u_last|`` plus half a percent of the spread: the Chebyshev
    recurrence diverges on an eigenvalue outside the enclosure.  The start
    vector is a unit Gaussian from ``generator`` (``_v0`` passes one in).
    Under a ``mesh`` the run is the sharded expansion of ``partial_eigh``'s
    (each rank its columns of the basis, the projections all-reduced) from
    the rank's columns of the whole start vector.
    """
    op, mesh = _filter_operator(A, dtype, device, mesh)
    n = _n_global(op)
    m = int(min(m, n - 1))
    if _v0 is None:
        v0 = rand_normalized_vector(n, op.dtype, device=op.device,
                                    generator=_generator(generator))
    else:
        v0 = torch.tensor(np.asarray(_v0), dtype=op.dtype, device=op.device)
    Vt = torch.zeros((m + 1, op.shape[0]), dtype=op.dtype, device=op.device)
    Vt[0] = _columns(v0, mesh)
    H = torch.zeros((m + 1, m), dtype=op.dtype, device=op.device)
    Vt, H, k = arnoldi_expand(op, Vt, H, max_dim=m, mesh=mesh)
    Hh = H.cpu().numpy().astype(np.float64)
    Hk = Hh[:k, :k]
    theta, U = np.linalg.eigh(0.5 * (Hk + Hk.T))
    beta = abs(float(Hh[k, k - 1]))
    spread = max(theta[-1] - theta[0], np.finfo(np.float64).tiny)
    lo_res = beta * abs(float(U[-1, 0]))
    hi_res = beta * abs(float(U[-1, -1]))
    return (float(theta[0] - lo_res - 0.005 * spread),
            float(theta[-1] + hi_res + 0.005 * spread))


def jackson_cheby_coeffs(a, b, lmin, lmax, degree):
    """Jackson-damped Chebyshev coefficients (float64, length ``degree +
    1``) of the indicator of ``[a, b]`` on ``[lmin, lmax]``: the JAX
    package's expansion, ``c_0 = (ta - tb)/pi``, ``c_j = 2 (sin(j ta) -
    sin(j tb)) / (pi j)`` with ``ta = arccos(alpha) >= tb = arccos(beta)``,
    times the kernel-polynomial-method damping factors."""
    N = int(degree)
    if N < 1:
        raise ValueError(f"degree={degree}: the expansion needs degree >= 1")
    c = 0.5 * (lmax + lmin)
    e = 0.5 * (lmax - lmin)
    if not e > 0:
        raise ValueError(f"empty spectral enclosure [{lmin}, {lmax}]")
    alpha = min(max((a - c) / e, -1.0), 1.0)
    beta = min(max((b - c) / e, -1.0), 1.0)
    if not alpha < beta:
        raise ValueError(f"empty window after mapping: [{alpha}, {beta}]")
    ta, tb = np.arccos(alpha), np.arccos(beta)
    j = np.arange(1, N + 1, dtype=np.float64)
    coeffs = np.empty(N + 1, np.float64)
    coeffs[0] = (ta - tb) / np.pi
    coeffs[1:] = 2.0 * (np.sin(j * ta) - np.sin(j * tb)) / (np.pi * j)
    jj = np.arange(0, N + 1, dtype=np.float64)
    den = N + 1.0
    g = ((den - jj) * np.cos(np.pi * jj / den)
         + np.sin(np.pi * jj / den) / np.tan(np.pi / den)) / den
    return coeffs * g


def _edge_sine(a, b, lmin, lmax):
    """``max(sqrt(1 - t^2))`` over the window edges mapped to the
    Chebyshev variable ``t``, floored at 0.01: a damped indicator of degree
    N resolves a transition of half-width ``~2.5 (lmax - lmin) sin / N``
    there, so near-edge windows need a far lower degree."""
    c = 0.5 * (lmax + lmin)
    e = 0.5 * (lmax - lmin)
    s = 0.0
    for x in (a, b):
        t = min(max((x - c) / e, -1.0), 1.0)
        s = max(s, float(np.sqrt(max(1.0 - t * t, 0.0))))
    return max(s, 0.01)


def _degree_rung(N):
    """A filter degree rounded up to the JAX package's ladder (from 16,
    ratio 1.25, multiples of 8).  The degree sets the polynomial, so the
    ladder is kept for equal iterates and counts; a higher degree only
    sharpens the filter."""
    N = int(N)
    rung = 16
    while rung < N:
        rung = -(-int(rung * 1.25) // 8) * 8
    return rung


def _auto_degree(lmin, lmax, sin_eff, delta_half, cap=40000):
    """The smallest ladder degree whose transition half-width is
    ``delta_half`` at edge geometry ``sin_eff``, at most ``cap``."""
    N = 2.5 * (lmax - lmin) * sin_eff / max(delta_half, 1e-300)
    return int(min(_degree_rung(max(N, 16)), cap))


def _fused(op, X):
    """Whether the filter takes the fused route: a single-device DIA
    operator (not a sharded or halo one) of real dtype, ``X`` of its dtype
    on the card."""
    return (type(op) is BandedOperator and op.dtype in _FUSED_DTYPES
            and X.dtype == op.dtype and X.is_cuda)


def cheby_filter(op, X, coeffs, lmin, lmax):
    """``p(A)`` applied to the rows of ``X`` ``(s, n)``
    (``ops/kernels/cheby_banded.cheby_recurrence``); ``X`` is not
    modified.  A single-device real DIA operator with ``X`` on the card
    takes the fused route, ``ops/kernels/cheby_banded`` (one launch a
    degree step), under ``ARNOLDI_PHASES`` in the span ``filter.fused``
    (its count the degree).  Every other operator, and CPU tensors, run
    the eager recurrence over ``op.matmat_rows``."""
    if _fused(op, X):
        with phase_clock()("filter.fused") as phase:
            Y = cheby_banded(op.bands, op.offsets, X.contiguous(), coeffs,
                             lmin, lmax)
            phase.count = len(coeffs) - 1
        return Y
    return cheby_recurrence(op.matmat_rows, X, coeffs, lmin, lmax)


def _rademacher(probes, n, dtype, device, generator, mesh=None):
    """``(probes, n)`` Rademacher probes from ``generator`` (this rank's
    columns of the whole block under a ``mesh``)."""
    Z = _columns(torch.randint(0, 2, (int(probes), n), generator=generator),
                 mesh)
    return Z.to(device=device, dtype=dtype).mul_(2).sub_(1)


def _kpm_moments(op, Z, lmin, lmax, degree, mesh=None):
    """Stochastic Chebyshev moments ``mu_j = mean_z z^T T_j(A~) z``,
    ``j = 0..degree``, in one recurrence pass over the probe block ``Z``;
    a float64 NumPy array read from the device once at the end.  Under a
    ``mesh`` each rank accumulates its columns' partial moments on the
    device and the ``(degree + 1,)`` vector is all-reduced once."""
    c = 0.5 * (lmax + lmin)
    inv_e = 2.0 / (lmax - lmin)
    probes = Z.shape[0]
    z = Z.reshape(-1)
    mu = torch.empty(int(degree) + 1, dtype=Z.dtype, device=Z.device)

    def moment(j, T):
        mu[j] = torch.dot(z, T.reshape(-1)) / probes

    T_prev, T = Z, _affine(op.matmat_rows, Z, c, inv_e)
    moment(0, Z)
    moment(1, T)
    for j in range(2, int(degree) + 1):
        T_next = _affine(op.matmat_rows, T, c, 2.0 * inv_e).sub_(T_prev)
        moment(j, T_next)
        T_prev, T = T, T_next
    return _reduce(mu, mesh).cpu().numpy().astype(np.float64)


def spectral_moments(op, degree, *, bounds, probes=PROBES, generator=None,
                     mesh=None, _Z=None):
    """The float64 Chebyshev moment vector ``(degree + 1,)`` of ``op`` over
    the enclosure ``bounds``, from ``probes`` Rademacher probes drawn from
    ``generator`` (``_Z`` passes the ``(probes, n)`` block in).  Costs
    ``probes * (degree + 1)`` matvecs.  Under a ``mesh`` the probes (and
    ``_Z``) are the whole block, each rank filtering its columns."""
    if mesh is not None or operator_mesh(op) is not None:
        op, mesh = _filter_operator(op, None, None, mesh)
    if int(degree) < 1:
        raise ValueError(f"degree={degree}: the recurrence needs >= 1")
    lmin, lmax = float(bounds[0]), float(bounds[1])
    if _Z is None:
        Z = _rademacher(probes, _n_global(op), op.dtype, op.device,
                        _generator(generator), mesh)
    else:
        Z = _columns(torch.tensor(np.asarray(_Z), dtype=op.dtype), mesh).to(
            op.device)
    return _kpm_moments(op, Z, lmin, lmax, degree, mesh)


def count_from_moments(mu, interval, bounds, degree=None):
    """KPM eigenvalue count of ``interval`` from precomputed moments,
    optionally truncated to a lower ``degree`` (re-damped, not sliced)."""
    lmin, lmax = float(bounds[0]), float(bounds[1])
    M = len(mu) - 1 if degree is None else int(min(degree, len(mu) - 1))
    coeffs = jackson_cheby_coeffs(float(interval[0]), float(interval[1]),
                                  lmin, lmax, M)
    return float(coeffs @ mu[:M + 1])


def estimate_window_count(A, interval, *, bounds=None, degree=120,
                          probes=PROBES, generator=None, dtype=None,
                          bounds_dim=40, mesh=None, device=None):
    """Stochastic estimate of the number of eigenvalues of a Hermitian
    operator inside ``interval`` (the KPM trace estimator over Rademacher
    probes).  Costs ``probes * (degree + 1)`` matvecs, plus the bounds'
    Lanczos run when ``bounds`` is None."""
    op, mesh = _filter_operator(A, dtype, device, mesh)
    generator = _generator(generator)
    if bounds is None:
        lmin, lmax = spectrum_bounds(op, bounds_dim, generator=generator,
                                     mesh=mesh)
    else:
        lmin, lmax = float(bounds[0]), float(bounds[1])
    a = max(float(interval[0]), lmin)
    b = min(float(interval[1]), lmax)
    if not a < b:
        raise ValueError(f"window {interval} lies outside the spectral "
                         f"enclosure [{lmin}, {lmax}]")
    mu = spectral_moments(op, degree, bounds=(lmin, lmax), probes=probes,
                          generator=generator, mesh=mesh)
    return count_from_moments(mu, (a, b), (lmin, lmax))


def _host_whiten(G):
    """float64 inverse-Cholesky factor ``C`` (``C G C^T ~ I``) of an
    ``(s, s)`` Gram, on the host, with an escalating diagonal shift (a
    filtered Gram has numerical rank below s: its gains span many
    decades); an ``eigh`` whitening with a floor as the last resort."""
    Gh = G.cpu().numpy().astype(np.float64) if torch.is_tensor(G) \
        else np.asarray(G, np.float64)
    Gh = 0.5 * (Gh + Gh.T)
    s = Gh.shape[0]
    d = max(float(np.abs(Gh.diagonal()).max()), np.finfo(np.float64).tiny)
    eye = np.eye(s)
    for shift in (0.0, 1e-9, 1e-6, 1e-4, 1e-2):
        try:
            L = np.linalg.cholesky(Gh + (shift * d) * eye)
            return sla.solve_triangular(L, eye, lower=True)
        except np.linalg.LinAlgError:
            continue
    w, W = np.linalg.eigh(Gh)
    w = np.maximum(w, 1e-12 * d)
    return (W / np.sqrt(w)).T


def _to(M, like):
    """The host matrix ``M`` as a tensor on ``like``'s device and dtype."""
    return torch.from_numpy(np.ascontiguousarray(M)).to(device=like.device,
                                                        dtype=like.dtype)


def _index(rows, like):
    return torch.from_numpy(np.asarray(rows, np.int64)).to(like.device)


def _active_rows(res, tol_abs, s):
    """Rows to refresh this sweep under soft locking: the unconverged rows,
    padded with distinct converged rows onto the halving ladder {s, s/2,
    s/4, ..., >= 32} of row counts (the JAX package's, kept: it decides
    which rows a sweep refreshes).  None when everything (or, on the first
    sweep, nothing is known and) all rows are active; empty when all
    rows are locked."""
    if res is None:
        return None
    active = np.nonzero(res > tol_abs)[0]
    if active.size == 0 or active.size >= s:
        return None if active.size else np.empty(0, np.intp)
    sb = s
    while sb > 32 and (sb + 1) // 2 >= active.size:
        sb = (sb + 1) // 2
    sb = min(int(-(-sb // 32) * 32), s)
    if sb >= s:
        return None
    done = np.setdiff1d(np.arange(s), active)
    return np.concatenate([active, done[: sb - active.size]])


def _filter_gains(op, V, coeffs, lmin, lmax, mesh=None):
    """``||p(A) v_i||`` of unit Ritz rows: a true owned pair sits in the
    filter's flat top (gain >= 0.9), a Ritz ghost (a mixture of uncaptured
    directions whose quotient lands in the window) below ~0.1."""
    return _row_norms(cheby_filter(op, V, coeffs, lmin, lmax), mesh)


def _pending_gains(op, X, pending, coeffs, lmin, lmax, mesh=None):
    """:func:`_filter_gains` of the pending rows of ``X``, padded with row 0
    to a multiple of 8 rows (the JAX package's bucket, which the matvec
    count includes)."""
    p = int(pending.size)
    idx = np.concatenate([pending, np.zeros((-p) % 8, pending.dtype)])
    gains = _filter_gains(op, X[_index(idx, X)], coeffs, lmin, lmax, mesh)
    return gains.cpu().numpy().astype(np.float64)[:p]


def _ghost_gate(trace, sweep, pick, inside, res, theta, tol_abs, nev,
                center, scale, gains_fn):
    """Stall-triggered ghost discrimination (the JAX package's): once the
    residual trace stalls with a small pending set, ``gains_fn(pending)``
    drops the pending rows whose filter gain is below 0.5 from the gate
    and from the returned set.  Returns ``(pick, inside, n_ghost,
    n_checked)``, ``n_checked`` the 8-bucketed rows filtered (0 when the
    gate did not fire); rewrites ``trace[-1]`` when ghosts are dropped."""
    stalled = (sweep >= 2 and np.isfinite(trace[-1])
               and trace[-1] > 0.7 * trace[-3])
    if not (stalled and pick.size):
        return pick, inside, 0, 0
    pending = pick[res[pick] > tol_abs]
    if not (0 < pending.size <= max(8, int(np.ceil(0.25 * pick.size)))):
        return pick, inside, 0, 0
    n_checked = int(-(-pending.size // 8) * 8)
    ghost = pending[gains_fn(pending) < 0.5]
    if not ghost.size:
        return pick, inside, 0, n_checked
    inside = inside[~np.isin(inside, ghost)]
    if nev is None:
        pick = inside
    else:
        pick = inside[np.argsort(np.abs(theta[inside] - center))[:nev]]
    trace[-1] = float(res[pick].max() / scale) if pick.size else np.inf
    return pick, inside, int(ghost.size), n_checked


def _ritz(op, Q, mesh=None):
    """Rayleigh-Ritz of ``op`` on the orthonormal rows ``Q``: Ritz rows
    (ascending theta), theta and residual norms (host float64)."""
    AQ = op.matmat_rows(Q)
    S = _reduce(Q @ AQ.T, mesh).cpu().numpy().astype(np.float64)
    theta, U = np.linalg.eigh(0.5 * (S + S.T))
    Ut = _to(U.T, Q)
    V, AV = Ut @ Q, Ut @ AQ
    AV.addcmul_(_to(theta, Q)[:, None], V, value=-1.0)
    res = _row_norms(AV, mesh)
    return V, theta, res.cpu().numpy().astype(np.float64)


def _filter_rr_step(op, X, coeffs, lmin, lmax, active=None, mesh=None):
    """One filtered sweep: filter all rows (or only ``active``, the others
    carried unchanged and the refreshed ones renormalized), CholQR2 with
    host-float64 whitening, Rayleigh-Ritz on ``op``, residual norms.
    Returns ``(V, theta, res, n_filtered)``."""
    if active is None:
        Y = cheby_filter(op, X, coeffs, lmin, lmax)
        n_filtered = X.shape[0]
    elif active.size == 0:
        Y = X        # all locked: re-project without refreshing a row
        n_filtered = 0
    else:
        idx = _index(active, X)
        Ya = cheby_filter(op, X[idx], coeffs, lmin, lmax)
        nrm = _row_norms(Ya, mesh)[:, None]
        Ya.div_(torch.clamp(nrm, min=torch.finfo(Ya.dtype).tiny))
        Y = X.index_copy(0, idx, Ya)
        n_filtered = int(active.size)
    Q1 = _to(_host_whiten(_reduce(Y @ Y.T, mesh)), Y) @ Y
    Q = _to(_host_whiten(_reduce(Q1 @ Q1.T, mesh)), Q1) @ Q1
    V, theta, res = _ritz(op, Q, mesh)
    return V, theta, res, n_filtered


def _finalize_history(history, all_inside, n_found, matvecs, n_sweeps):
    if all_inside and n_found != history.k:
        h2 = History.from_k(max(n_found, 1))
        h2.residual_trace = history.residual_trace
        h2.phases = history.phases
        history = h2
    history.total = matvecs
    history.matvecs[:] = matvecs
    history.restarts[:] = n_sweeps
    return history


def _refine_filtered(op64, X, *, win, own, lmin, lmax, degree, tol, scale,
                     nev, history, min_inside=0, max_sweeps=12, mesh=None):
    """Continue a stalled work-dtype subspace to ``tol`` in float64 on
    ``op64`` (the operator at its own values): the loop of the JAX
    package's ``_refine_filtered_dw`` without its double-word arithmetic.
    Per sweep: the filter of the padded window ``win`` (soft locking, no
    renormalization), one host-float64 whitening, Rayleigh-Ritz on
    ``op64``, the ghost gate; converged when at least ``min_inside`` pairs
    (less this sweep's ghosts) lie in ``own`` at ``tol``.  Returns
    ``(theta, X, res, pick, n_sweeps, matvecs)``."""
    s = X.shape[0]
    a, b = own
    coeffs = jackson_cheby_coeffs(win[0], win[1], lmin, lmax, degree)
    center = 0.5 * (a + b)
    X = X.to(torch.float64)
    matvecs = 0
    res_prev = None
    for sweep in range(int(max_sweeps)):
        act = _active_rows(res_prev, tol * scale, s)
        if act is None:
            X = cheby_filter(op64, X, coeffs, lmin, lmax)
            n_f = s
        elif act.size == 0:
            n_f = 0
        else:
            idx = _index(act, X)
            X = X.index_copy(0, idx, cheby_filter(op64, X[idx], coeffs,
                                                  lmin, lmax))
            n_f = int(act.size)
        matvecs += degree * n_f
        X = _to(_host_whiten(_reduce(X @ X.T, mesh)), X) @ X
        X, theta, res = _ritz(op64, X, mesh)
        matvecs += s
        res_prev = res
        inside = np.nonzero((theta >= a) & (theta <= b))[0]
        if nev is None:
            pick = inside
        else:
            pick = inside[np.argsort(np.abs(theta[inside] - center))[:nev]]
        history.residual_trace.append(
            float(res[pick].max() / scale) if pick.size else np.inf)
        pick, inside, n_ghost, n_chk = _ghost_gate(
            history.residual_trace, sweep, pick, inside, res, theta,
            tol * scale, nev, center, scale,
            lambda pending: _pending_gains(op64, X, pending, coeffs, lmin,
                                           lmax, mesh))
        matvecs += degree * n_chk
        # the collapse guard discounts this sweep's ghosts (per sweep: rows
        # rotate, so one ghost is found again each stalled sweep)
        if (pick.size >= max(nev or 0, min_inside - n_ghost)
                and np.all(res[pick] <= tol * scale)):
            break
    else:
        raise RuntimeError("Has not converged !")
    return theta, X, res, pick, sweep + 1, matvecs


def _work_operators(A, dtype, device, orig, mesh):
    """``(op, op_src, wdtype, mesh)``: the operator in the real work dtype
    and the one at the source's values (``orig`` when given) for a float64
    continuation, this rank's row blocks under a mesh."""
    op, mesh = _filter_operator(A, None, device, mesh)
    op_src = op if orig is None else orig
    wdtype = torch_dtype(dtype) if dtype is not None else solver_dtype(op.dtype)
    if wdtype.is_complex or op_src.dtype.is_complex:
        raise ValueError("eigsh_filtered is the real symmetric driver; "
                         "realify a complex operator first "
                         "(realify_operator)")
    return cast_operator(op, wdtype), op_src, wdtype, mesh


def _refines(refine, op, wdtype, tol):
    refinement.check_refine(refine)
    if refine == "dw":
        return True
    # a sharded operator is a format operator's row block
    return (refine == "auto" and wdtype == torch.float32 and tol < 1e-6
            and (isinstance(op, FORMAT_OPERATORS) or operator_mesh(op) is not None))


def _draws_on_card(X):
    """Whether the start block's Gaussian rows are drawn where ``X``
    lives (a block on the card) rather than on the host."""
    return X.is_cuda


def _card_rows(X, k0, n, generator, mesh):
    """Fill ``X[k0:]`` with Gaussian rows drawn on ``X``'s device, from a
    device generator seeded by one int64 draw of the CPU ``generator``
    (the global CUDA generator is neither seeded nor read).  Under a
    ``mesh`` every rank draws the whole rows from the same seed, in chunks
    of at most ``ceil((s - k0) / mesh.size)`` rows, and keeps its columns:
    one rank draws one chunk, the unsharded block's bits."""
    seed = int(torch.randint(0, 2**62, (), generator=generator))
    g = torch.Generator(device=X.device).manual_seed(seed)
    if mesh is None:
        X[k0:].normal_(generator=g)
        return
    step = -(-(X.shape[0] - k0) // mesh.size)
    for r in range(k0, X.shape[0], step):
        rows = X[r:r + step]
        whole = torch.empty((rows.shape[0], n), dtype=X.dtype, device=X.device)
        rows.copy_(_columns(whole.normal_(generator=g), mesh))


def _start_block(s, n, X0, wdtype, device, generator, mesh=None,
                 clock=NULL_CLOCK):
    """The ``(s, n)`` start block: the rows of ``X0`` first (at most s),
    the rest Gaussian rows, orthonormalized by CholQR2.  On the card the
    rows are drawn there (:func:`_card_rows`, in the span
    ``filter.device_draw`` of ``clock``, its count the rows drawn); on the
    CPU they come from ``generator`` itself.  Under a ``mesh`` this rank's
    columns: the Gaussian rows are drawn whole and sliced, ``X0`` holds the
    whole rows or this rank's columns."""
    k0 = 0 if X0 is None else min(int(X0.shape[0]), s)
    n_local = n if mesh is None else n // mesh.size
    X = torch.empty((s, n_local), dtype=wdtype, device=device)
    if k0:
        W = X0[:k0] if torch.is_tensor(X0) else torch.from_numpy(np.array(X0[:k0]))
        if W.shape[1] == n != n_local:
            W = _columns(W, mesh)
        elif W.shape[1] != n_local:
            raise ValueError(f"X0 has {W.shape[1]} columns; expected {n} (the "
                             f"whole rows) or this rank's {n_local}")
        X[:k0] = W.to(device=device, dtype=wdtype)
    if _draws_on_card(X):
        with clock("filter.device_draw") as phase:
            if k0 < s:
                _card_rows(X, k0, n, generator, mesh)
            phase.count = s - k0
    elif k0 < s:
        X[k0:] = _columns(torch.randn((s - k0, n), generator=generator,
                                      dtype=wdtype), mesh).to(device)
    return block_cgs2(X, X, 0, mesh=mesh)[1]


@solve_span(lambda out: out[2].total_matvecs)
def eigsh_filtered(
    A,
    nev,
    interval,
    *,
    degree=None,
    subspace=None,
    tol=None,
    max_iters=200,
    bounds=None,
    bounds_dim=40,
    dtype=None,
    generator=None,
    refine="auto",
    mesh=None,
    X0=None,
    transition=1.5,
    device=None,
    _orig=None,
    _census_mu=None,
    _extras=False,
    _probes=None,
):
    """``nev`` eigenpairs of a real symmetric operator inside ``interval =
    (a, b)`` by Chebyshev-filtered subspace iteration: no factorization and
    no inner solve, ``degree`` matvecs a subspace row a sweep.

    Parameters
    ----------
    nev : pairs to return, nearest the window's center; None returns all
        pairs inside the window ("spectrum slice" mode, as
        :func:`eigsh_window` runs it): the subspace holds twice the KPM
        count of the window, and convergence needs every inside pair at
        ``tol`` with the inside count stable over two sweeps.
    interval : the owned window; the filter runs on it padded by one
        transition half-width a side, and the subspace holds the pairs of
        the capture window (two half-widths a side).
    degree : the filter's Chebyshev degree; by default the ladder degree
        whose transition half-width is ``transition`` times the window at
        its local Chebyshev geometry.
    subspace : the subspace's rows; by default sized from a KPM count of
        the capture window.
    tol : residual tolerance relative to ``max(|lmin|, |lmax|)``; default
        ``sqrt(eps)`` of the work dtype.
    bounds : the spectral enclosure ``(lmin, lmax)``; by default
        :func:`spectrum_bounds` of a ``bounds_dim``-step Lanczos run.
    dtype : the work dtype (float32 or float64); by default the operator's.
    generator : a CPU ``torch.Generator`` for the bounds' start vector, the
        KPM probes and the start block (default: seeded with 0); on a card
        the start block comes from a card generator seeded by one int64
        draw of it.
    refine : "auto" continues a float32 solve below tol 1e-6 on a format
        operator in float64: the float32 loop runs to ``max(tol, 1e-5)`` or
        its stall, then the same sweep in float64 on the operator at its
        own values (build it from the float64 source); the outputs are
        float64.  "dw" forces the continuation, None disables it.
    mesh : an :class:`arnoldi_tpu_torch.parallel.Mesh` (``make_mesh``): every
        rank calls the driver with the same arguments; the operator is a
        sharded operator of the mesh (``halo_matvec_closure``, the ring
        halo) or is sharded here (``shard_operator``, the all-gather of x),
        and its row count must divide the mesh (``pad_operator``).
    X0 : warm-start rows ``(k0, n)`` (the rest of the block stays random);
        under a mesh the whole rows or this rank's columns.
    device : where SciPy and NumPy input is placed (default the mesh's
        device under a mesh).

    Returns ``(vals, vecs, history)``: eigenvalues ascending (NumPy),
    eigenvectors as ``(n, k)`` columns on the operator's device (under a
    mesh this rank's rows of them, the values on every rank), and a
    :class:`History` with the total matvecs and the per-sweep trace; its
    ``geometry`` attribute holds the owned ``interval``, the ``bounds``,
    the subspace ``s``, the ``degree``, the ``sweeps`` (all phases) and the
    float64 continuation's ``f64_sweeps`` and ``f64_matvecs`` (0 when it
    did not run).
    Raises ``RuntimeError("Has not converged !")`` when the pairs do not
    reach ``tol`` within ``max_iters`` sweeps.
    """
    op, op_src, wdtype, mesh = _work_operators(A, dtype, device, _orig, mesh)
    n = _n_global(op)
    if op.shape[1] != op.shape[0]:
        raise ValueError(f"need a square operator, got {op.shape}")
    a, b = float(interval[0]), float(interval[1])
    if not a < b:
        raise ValueError(f"empty interval {interval}")
    check_matmul_precision(wdtype, op.device)
    generator = _generator(generator)
    probes = dict(_probes or {})
    clock = phase_clock()

    if bounds is None:
        with clock("filter.bounds"):
            lmin, lmax = spectrum_bounds(op, bounds_dim, generator=generator,
                                         mesh=mesh)
    else:
        lmin, lmax = float(bounds[0]), float(bounds[1])
    a_m, b_m = max(a, lmin), min(b, lmax)
    if not a_m < b_m:
        raise ValueError(f"window [{a}, {b}] lies outside the spectral "
                         f"enclosure [{lmin}, {lmax}]")

    # Geometry: the owned window [a_m, b_m] is gated; the filter's window
    # is it padded by one transition half-width delta a side (so owned
    # pairs sit in the flat top); the capture window, padded by 2 delta,
    # is what the subspace must hold (the gain there stays >= ~0.1).
    w_own = b_m - a_m
    sin_eff = _edge_sine(a_m, b_m, lmin, lmax)
    all_inside = nev is None
    matvecs = 0
    expected = None
    cdeg2 = _degree_rung(max(150, _auto_degree(lmin, lmax, sin_eff,
                                               0.25 * w_own, cap=8000)))
    if degree is not None:
        cdeg2 = min(cdeg2, int(degree))
    if all_inside:
        # The owned count arms the empty-window guard; its probes are
        # drawn apart from the sizing count's, so one unlucky draw cannot
        # defeat both.
        with clock("filter.count_probe"):
            mu2 = spectral_moments(op, cdeg2, bounds=(lmin, lmax),
                                   generator=generator, mesh=mesh,
                                   _Z=probes.get("count"))
        matvecs += PROBES * (cdeg2 + 1)
        expected = count_from_moments(mu2, (a_m, b_m), (lmin, lmax))
        if expected < 1.0:
            # (near-)empty window: a sharp filter keeps the capture band
            # as empty as the window
            transition = min(transition, 0.25)
    if degree is None:
        degree = _auto_degree(lmin, lmax, sin_eff, transition * w_own)
    degree = int(degree)
    delta = 2.5 * (lmax - lmin) * sin_eff / degree
    lo_f, hi_f = max(a_m - delta, lmin), min(b_m + delta, lmax)
    lo_c, hi_c = max(a_m - 2 * delta, lmin), min(b_m + 2 * delta, lmax)
    coeffs = jackson_cheby_coeffs(lo_f, hi_f, lmin, lmax, degree)
    cdeg = int(min(degree, _degree_rung(max(150, _auto_degree(
        lmin, lmax, sin_eff, 0.25 * (hi_c - lo_c), cap=8000)))))
    if subspace is not None:
        s = int(subspace)
    else:
        if _census_mu is not None and cdeg <= len(_census_mu) - 1:
            mu = _census_mu     # the moments are window-independent
        else:
            mu = spectral_moments(op, cdeg, bounds=(lmin, lmax),
                                  generator=generator, mesh=mesh,
                                  _Z=probes.get("sizing"))
            matvecs += PROBES * (cdeg + 1)
        # 2x the owned cluster in slice mode (a missed pair is a
        # completeness failure), 1.5x otherwise; 1.25x the transition
        # band's surplus, which need only be present
        count = max(count_from_moments(mu, (lo_c, hi_c), (lmin, lmax)), 0.0)
        if all_inside:
            owned = min(max(expected, 0.0), count)
            s = int(np.ceil(2.0 * owned + 1.25 * (count - owned))) + 8
        else:
            s = max(nev + 6, int(np.ceil(1.5 * count)) + 6)
    s = min(max(s, nev or 1), n)
    if tol is None:
        tol = float(np.sqrt(torch.finfo(wdtype).eps))
    scale = max(abs(lmin), abs(lmax))

    do_refine = _refines(refine, op, wdtype, tol)
    tol_target = tol
    if do_refine:
        tol = max(tol, 1e-5)

    with clock("filter.start_block") as phase:
        X = _start_block(s, n, X0, wdtype, op.device, generator, mesh, clock)
        phase.count = s
    history = History.from_k(nev or 1)
    center = 0.5 * (a_m + b_m)
    prev_inside = -1
    res_prev = None
    for sweep in range(int(max_iters)):
        with clock("filter.sweep") as phase:
            X, theta_h, res_h, n_f = _filter_rr_step(
                op, X, coeffs, lmin, lmax,
                active=_active_rows(res_prev, tol * scale, s), mesh=mesh)
            phase.count = degree * n_f + s
        res_prev = res_h
        matvecs += degree * n_f + s     # the filter and the Rayleigh-Ritz product
        inside = np.nonzero((theta_h >= a_m) & (theta_h <= b_m))[0]
        # the gate tests exactly the pairs that would be returned
        if all_inside:
            pick = inside
        else:
            pick = inside[np.argsort(np.abs(theta_h[inside] - center))[:nev]]
        history.residual_trace.append(
            float(res_h[pick].max() / scale) if pick.size else np.inf)
        trace = history.residual_trace
        with clock("filter.ghost_gate") as phase:
            pick, inside, n_ghost, n_chk = _ghost_gate(
                trace, sweep, pick, inside, res_h, theta_h, tol * scale, nev,
                center, scale,
                lambda pending: _pending_gains(op, X, pending, coeffs, lmin,
                                               lmax, mesh))
            phase.count = degree * n_chk
        matvecs += degree * n_chk
        # An empty stable window is a result only when the KPM count agrees
        # that the window is empty.
        empty_ok = expected is None or expected < 1.0
        stable = (inside.size == prev_inside
                  and (inside.size > 0 or empty_ok)
                  and (all_inside or pick.size >= nev))
        # handoff to the float64 continuation once the work-dtype trace
        # stalls with the inside set stable
        if (do_refine and sweep >= 2 and stable and np.isfinite(trace[-1])
                and trace[-1] < 1e-3 and trace[-1] > 0.7 * trace[-3]):
            break
        if all_inside:
            if stable and np.all(res_h[pick] <= tol * scale):
                break
        elif pick.size >= nev and np.all(res_h[pick] <= tol * scale):
            break
        prev_inside = inside.size
    else:
        raise RuntimeError("Has not converged !")

    n_sweeps = sweep + 1
    vals_h, rows = theta_h, X
    geometry = {"interval": (a_m, b_m), "bounds": (lmin, lmax), "s": s,
                "degree": degree, "sweeps": n_sweeps, "f64_sweeps": 0,
                "f64_matvecs": 0}
    if do_refine:
        with clock("refine.filter") as phase:
            vals_h, rows, _, pick, r_sweeps, r_mv = _refine_filtered(
                refinement.exact_operator(op_src), X, win=(lo_f, hi_f),
                own=(a_m, b_m), lmin=lmin, lmax=lmax, degree=degree,
                tol=tol_target, scale=scale, nev=nev, history=history,
                # sharper float64 Ritz values may move a cut-straddling
                # pair out of the owned window: require most of the
                # coarse inside count, not all of it
                min_inside=(int(np.ceil(0.8 * inside.size)) if all_inside
                            else (nev or 0)), mesh=mesh)
            phase.count = r_mv
        matvecs += r_mv
        n_sweeps += r_sweeps
        geometry.update(f64_sweeps=r_sweeps, f64_matvecs=r_mv)
    pick = pick[np.argsort(vals_h[pick])]       # ascending, as SciPy
    vals = vals_h[pick]
    vecs = rows[_index(pick, rows)].T.contiguous()
    history.phases = clock.report()
    hist = _finalize_history(history, all_inside, len(vals), matvecs,
                             n_sweeps)
    hist.geometry = geometry
    if _extras:
        # the warm-start handoff rows come from the work-dtype phase
        return vals, vecs, hist, (theta_h, X)
    return vals, vecs, hist


def _merge_phases(total, parts):
    merged = dict(total)
    for ph in parts:
        for k_, v_ in ph.items():
            if k_ in merged:
                merged[k_] = {
                    "seconds": round(merged[k_]["seconds"]
                                     + v_.get("seconds", 0.0), 6),
                    "calls": merged[k_].get("calls", 0) + v_.get("calls", 0),
                }
            else:
                merged[k_] = dict(v_)
    return merged


@solve_span(lambda out: out[2].total_matvecs)
def eigsh_window(
    A,
    interval,
    *,
    max_slice=40,
    tol=None,
    degree=None,
    max_iters=200,
    bounds=None,
    bounds_dim=40,
    dtype=None,
    generator=None,
    refine="auto",
    mesh=None,
    transition=1.5,
    device=None,
    _probes=None,
):
    """All eigenpairs of a real symmetric operator inside ``interval`` by
    spectrum slicing: a KPM census over 8 cells sizes the job, the window
    is cut at equal-count quantiles into slices of about ``max_slice``
    eigenvalues, and each slice is solved by :func:`eigsh_filtered` in
    all-inside mode on the operator built once, warm-started with the
    previous slice's rows above its cut.  Slices own half-open intervals
    (the last keeps its right edge); a pair found on a cut by both
    neighbors is merged.  Completeness rests on the KPM counts.

    ``_probes={"census": Z}`` passes the census' ``(8, n)`` probe block in.
    Returns ``(vals, vecs, history)`` as :func:`eigsh_filtered`, with one
    ``History`` over all slices whose ``slices`` attribute lists each
    slice's ``geometry``.  Under a ``mesh`` (as :func:`eigsh_filtered`'s)
    the operator is sharded once, the census runs on the mesh and every
    slice solves on that operator, warm-started with the rank's columns."""
    op, op_src, wdtype, mesh = _work_operators(A, dtype, device, None, mesh)
    a, b = float(interval[0]), float(interval[1])
    if not a < b:
        raise ValueError(f"empty interval {interval}")
    generator = _generator(generator)
    wclock = phase_clock()
    if bounds is None:
        with wclock("filter.bounds"):
            lmin, lmax = spectrum_bounds(op, bounds_dim, generator=generator,
                                         mesh=mesh)
    else:
        lmin, lmax = float(bounds[0]), float(bounds[1])
    a_m, b_m = max(a, lmin), min(b, lmax)
    if not a_m < b_m:
        raise ValueError(f"window [{a}, {b}] lies outside the spectral "
                         f"enclosure [{lmin}, {lmax}]")
    scale = max(abs(lmin), abs(lmax))
    if tol is None:
        tol = float(np.sqrt(torch.finfo(wdtype).eps))

    # Cuts at equal-count quantiles of the KPM census over n_cells cells;
    # the count kernel resolves half a cell at the window's geometry.
    n_cells = 8
    cdeg = _degree_rung(max(150, _auto_degree(
        lmin, lmax, _edge_sine(a_m, b_m, lmin, lmax),
        0.5 * (b_m - a_m) / n_cells, cap=8000)))
    grid = np.linspace(a_m, b_m, n_cells + 1)
    with wclock("filter.census"):
        mu = spectral_moments(op, cdeg, bounds=(lmin, lmax),
                              generator=generator, mesh=mesh,
                              _Z=(_probes or {}).get("census"))
    mv_count = PROBES * (cdeg + 1)
    cell_counts = np.array([
        max(count_from_moments(mu, (grid[i], grid[i + 1]), (lmin, lmax)),
            0.0)
        for i in range(n_cells)])
    total = float(cell_counts.sum())
    n = op.shape[0]         # this rank's rows under a mesh
    if total < 0.5:
        hist = History.from_k(1)
        hist.total = mv_count
        hist.slices = []
        return (np.empty(0), torch.empty((n, 0), dtype=wdtype,
                                         device=op.device), hist)
    n_slices = int(np.ceil(total / max_slice))
    cum = np.concatenate([[0.0], np.cumsum(cell_counts)])
    cuts = np.interp(np.linspace(0.0, total, n_slices + 1), cum, grid)
    cuts[0], cuts[-1] = a_m, b_m

    all_vals, all_vecs = [], []
    matvecs, sweeps = mv_count, 0
    trace, slice_phases, geometries = [], [], []
    carry = None
    for i in range(n_slices):
        lo, hi = float(cuts[i]), float(cuts[i + 1])
        if hi <= lo:
            continue
        vals_i, vecs_i, hist_i, (theta_i, X_i) = eigsh_filtered(
            op, None, (lo, hi), degree=degree, tol=tol, max_iters=max_iters,
            bounds=(lmin, lmax), dtype=wdtype, generator=generator,
            refine=refine, mesh=mesh, X0=carry, transition=transition,
            _orig=op_src, _census_mu=mu, _extras=True)
        # this slice's Ritz rows above its cut lie in the next slice's
        # window: they start it (its own gate verifies them)
        if i + 1 < n_slices:
            up = np.nonzero(theta_i >= hi)[0]
            carry = X_i[_index(up, X_i)] if up.size else None
        matvecs += hist_i.total_matvecs
        sweeps += int(hist_i.restarts.max()) if hist_i.restarts.size else 0
        trace.extend(hist_i.residual_trace)
        slice_phases.append(hist_i.phases or {})
        geometries.append(hist_i.geometry)
        own = (vals_i >= lo) & ((vals_i < hi) | (i == n_slices - 1))
        all_vals.append(vals_i[own])
        all_vecs.append(vecs_i[:, _index(np.nonzero(own)[0], vecs_i)])

    vals = np.concatenate(all_vals) if all_vals else np.empty(0)
    vecs = (torch.cat(all_vecs, dim=1) if all_vecs
            else torch.empty((n, 0), dtype=wdtype, device=op.device))
    order = np.argsort(vals)
    vals, vecs = vals[order], vecs[:, _index(order, vecs)]
    # a pair on a cut found by both neighbors: equal values, parallel vectors
    keep = np.ones(len(vals), bool)
    for i in range(1, len(vals)):
        if (vals[i] - vals[i - 1] <= 16 * tol * scale
                and abs(float(_reduce(torch.dot(vecs[:, i], vecs[:, i - 1]),
                                      mesh))) > 0.9):
            keep[i] = False
    vals, vecs = vals[keep], vecs[:, _index(np.nonzero(keep)[0], vecs)]

    history = History.from_k(max(len(vals), 1))
    history.total = matvecs
    history.matvecs[:] = matvecs
    history.restarts[:] = sweeps
    history.residual_trace = trace
    history.phases = _merge_phases(wclock.report(), slice_phases)
    history.slices = geometries
    return vals, vecs, history
