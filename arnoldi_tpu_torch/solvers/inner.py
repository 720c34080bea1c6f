"""Inner Krylov solvers of the shift-invert operators: ``cg``,
``bicgstab`` and restarted ``gmres``.

The JAX package borrows these from ``jax.scipy.sparse.linalg``
(``_cg_solve``, ``_bicgstab_solve`` and ``gmres`` with
``solve_method="batched"``); this module is the port's copy of the same
recurrences on tensors of one device, with the same tolerance rules:

* cg and bicgstab stop once ``||r||^2 <= max(tol^2 ||b||^2, atol^2)`` or
  after ``maxiter`` iterations (default ``10 n``); cg reads ``gamma``'s
  real part for ``||r||^2`` when there is no preconditioner;
* bicgstab takes JAX's early-exit selects and stops without raising on a
  breakdown (status -10: ``rho = 0``; -11: ``omega = 0`` or ``alpha = 0``);
* gmres restarts every ``min(restart, n)`` Arnoldi steps until
  ``||M r|| <= max(tol ||b||, atol)`` or after ``maxiter`` restarts, and
  solves each restart's least-squares problem by the normal equations
  through a Cholesky factorization (JAX's ``_lstsq``), on the device.

JAX runs each loop as one ``while_loop`` on the device.  Here the host
decides when to stop, so every iteration ends in one host read: the
residual and the breakdown flags of the iteration travel together.  Each
solver returns ``(x, info)`` with :class:`SolveInfo` counting the
iterations and the operator's products, so the callers count inner
matvecs with plain integers.

gmres's Gram-Schmidt step is one classical pass: JAX's
``_iterative_classical_gram_schmidt(max_iterations=2)`` tests for a second
pass only while its pass counter is below ``max_iterations - 1``, which it
no longer is after the first.  That pass is the two fused CGS kernels
(``masked_project``, then ``project_update_norm``, which also returns the
new vector's squared norm) over the basis rows filled so far.
"""

from typing import NamedTuple

import torch

from ..ops.kernels.ortho_fused import masked_project, project_update_norm

__all__ = ["SolveInfo", "bicgstab", "cg", "gmres"]


class SolveInfo(NamedTuple):
    """What one inner solve did: ``iterations`` (restart cycles for
    gmres), ``matvecs`` (products with ``A``, the one of the initial
    residual included) and ``status`` (0, or bicgstab's breakdown code
    -10 or -11)."""

    iterations: int
    matvecs: int
    status: int = 0


def _vdot_real(x, y):
    """``Re(x^H y)`` without the cross terms (JAX's ``_vdot_real_part``):
    the real and imaginary parts taken as one real vector."""
    if x.is_complex():
        return torch.dot(torch.view_as_real(x).reshape(-1),
                         torch.view_as_real(y).reshape(-1))
    return torch.dot(x, y)


def _norm(x):
    return torch.sqrt(_vdot_real(x, x))


def _start(b, x0, maxiter):
    x = torch.zeros_like(b) if x0 is None else x0.to(b)
    return x, (10 * b.numel() if maxiter is None else int(maxiter))


def _squared_tol(b, tol, atol):
    """``max(tol^2 ||b||^2, atol^2)`` as a host float (one read)."""
    return max(tol * tol * _vdot_real(b, b).item(), atol * atol)


def cg(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
    """Conjugate gradients for Hermitian definite ``A`` (a callable on
    tensors); ``M`` an optional preconditioner callable.  Returns
    ``(x, SolveInfo)``."""
    x, maxiter = _start(b, x0, maxiter)
    atol2 = _squared_tol(b, tol, atol)
    precond = M if M is not None else (lambda v: v)
    r = b - A(x)
    p = z = precond(r)
    dtype = p.dtype
    gamma = _vdot_real(r, z).to(dtype)
    k = 0
    while k < maxiter:
        rs = gamma.real if M is None else _vdot_real(r, r)
        if not rs.item() > atol2:         # the iteration's one host read
            break
        Ap = A(p)
        alpha = gamma / _vdot_real(p, Ap).to(dtype)
        x = torch.addcmul(x, alpha, p)            # x + alpha p, one launch
        r = torch.addcmul(r, alpha, Ap, value=-1)
        z = precond(r)
        gamma_ = _vdot_real(r, z).to(dtype)
        p = torch.addcmul(z, gamma_ / gamma, p)
        gamma = gamma_
        k += 1
    return x, SolveInfo(k, k + 1)


def bicgstab(A, b, x0=None, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
    """BiCGStab for general ``A`` (a callable on tensors); ``M`` an
    optional preconditioner callable.  Returns ``(x, SolveInfo)``; two
    products an iteration, the early exit's too."""
    x, maxiter = _start(b, x0, maxiter)
    atol2 = _squared_tol(b, tol, atol)
    precond = M if M is not None else (lambda v: v)
    r = b - A(x)
    rhat = p = q = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    code = None        # the last iteration's breakdown code, on the device
    k = status = 0
    while k < maxiter:
        rs = _vdot_real(r, r)
        if code is None:
            rs_h = rs.item()
        else:                             # one read for both
            rs_h, status = torch.stack([rs, code.to(rs.dtype)]).tolist()
            status = int(status)
        if status or not rs_h > atol2:
            break
        rho_ = torch.vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = torch.addcmul(r, beta, torch.addcmul(p, omega, q, value=-1))
        phat = precond(p)
        q = A(phat)
        alpha = rho_ / torch.vdot(rhat, q)
        s = torch.addcmul(r, alpha, q, value=-1)
        exit_early = _vdot_real(s, s) < atol2
        shat = precond(s)
        t = A(shat)
        omega = torch.vdot(t, s) / torch.vdot(t, t)
        # JAX's selects x + alpha phat or x + (alpha phat + omega shat), and
        # s or s - omega t, as one update with omega zeroed on the early
        # exit (adding 0 * v changes no bit of a finite sum).
        step = torch.where(exit_early, 0.0, omega)
        x = x + torch.addcmul(alpha * phat, step, shat)
        r = torch.addcmul(s, step, t, value=-1)
        code = torch.where(rho_ == 0, -10,
                           torch.where((omega == 0) | (alpha == 0), -11, 0))
        rho = rho_
        k += 1
    return x, SolveInfo(k, 1 + 2 * k, status)


def _safe_normalize(x, thresh, norm=None):
    """``(x / ||x||, ||x||)``, or zeros and 0 when ``||x|| <= thresh`` (a
    0-d tensor or float; JAX's ``_safe_normalize``); ``norm`` is ``||x||``
    when the caller has it.  No host read."""
    norm = _norm(x) if norm is None else norm
    use = norm > thresh
    return torch.where(use, x / norm.to(x.dtype), 0.0), torch.where(use, norm, 0.0)


def _arnoldi_cycle(A, precond, Vt, H, restart, eps):
    """One restart's Arnoldi process (JAX's ``_kth_arnoldi_iteration``
    until ``restart`` steps or a breakdown) on the basis rows ``Vt``, row 0
    set; fills the rows of ``H`` (a (restart, restart + 1) device tensor
    holding the identity).  Returns the steps taken."""
    steps = 0
    for k in range(restart):
        v = precond(A(Vt[k]))
        v_norm_0 = _norm(v)
        v_norm_0 = torch.where(v_norm_0 > eps, v_norm_0, 0.0)   # as JAX's
        h = masked_project(Vt, v, k + 1)
        v, norm_sq = project_update_norm(Vt, v, h, k + 1)
        unit, v_norm_1 = _safe_normalize(v, eps * v_norm_0, torch.sqrt(norm_sq))
        Vt[k + 1] = unit
        h[k + 1] = v_norm_1.to(h.dtype)
        H[k] = h
        steps += 1
        if v_norm_1.item() == 0.0:        # the step's one host read
            break
    return steps


def gmres(A, b, x0=None, *, tol=1e-5, atol=0.0, restart=20, maxiter=None,
          M=None):
    """Restarted GMRES (JAX's ``solve_method="batched"``) for general ``A``
    (a callable on tensors); ``M`` an optional left preconditioner
    callable.  ``maxiter`` counts restart cycles.  Returns
    ``(x, SolveInfo)``.  The basis is ``(restart + 1, n)`` rows on ``b``'s
    device."""
    x, maxiter = _start(b, x0, maxiter)
    n = b.numel()
    restart = min(int(restart), n)
    precond = M if M is not None else (lambda v: v)
    real = b.real.dtype if b.is_complex() else b.dtype
    eps = torch.finfo(real).eps
    atol = max(tol * _norm(b).item(), atol)
    unit, rnorm = _safe_normalize(precond(b - A(x)), eps)
    matvecs = 1
    Vt = torch.empty((restart + 1, n), dtype=b.dtype, device=b.device)
    k = 0
    while k < maxiter:
        rnorm_h = rnorm.item()            # the cycle's one host read
        if not rnorm_h > atol:
            break
        Vt[0] = unit
        H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
        steps = _arnoldi_cycle(A, precond, Vt, H, restart, eps)
        matvecs += steps + 1
        # JAX's _lstsq: the normal equations of min |H^T y - beta e_1|,
        # beta = ||r||, on the device (cholesky_ex: no host read).
        a2 = H.conj() @ H.T
        chol, _ = torch.linalg.cholesky_ex(a2)
        y = torch.cholesky_solve((rnorm.to(H.dtype) * H[:, 0].conj())[:, None],
                                 chol)[:, 0]
        # Rows past the breakdown are zero in JAX's basis: leave them out.
        x = x + y[:steps] @ Vt[:steps]
        unit, rnorm = _safe_normalize(precond(b - A(x)), eps)
        k += 1
    return x, SolveInfo(k, matvecs)
