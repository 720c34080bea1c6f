"""The Chebyshev filter's recurrence over a DIA operator, one launch a degree
step.

:func:`cheby_banded` applies ``p(A) = sum_j coeffs[j] T_j((A - c I) / e)``
(``c``, ``e`` the centre and half-width of ``[lmin, lmax]``) to the rows of
``X`` ``(s, n)``, ``A`` given by its DIA ``bands`` and ``offsets`` (as
:mod:`.spmv_banded` takes them): the recurrence ``T_1 = (A X - c X) / e``,
``T_{j+1} = 2 (A T_j - c T_j) / e - T_{j-1}``, ``Y = sum_j coeffs[j] T_j``
of ``solvers/filtered.cheby_filter``.

On CUDA tensors (float32 or float64) each degree step is one launch of
``arn_cheby_dia`` (``csrc/spmv_banded.cu``): the b-column DIA kernel with
the recurrence as its epilogue, where the eager loop launches the product
and four elementwise passes.  The call allocates three ``(s, n)`` blocks
(``T_1``, ``T_2`` and ``Y``); from the third step on ``T_{j+1}`` overwrites
``T_{j-1}`` in place, and ``X`` is never written.  Degree 0 is ``c_0 X``
with no launch.  On CPU tensors it runs :func:`cheby_banded_plain`: the
eager recurrence (:func:`cheby_recurrence`) over the plain DIA product.

``solvers/filtered.cheby_filter`` routes a single-device ``BandedOperator``
of real dtype with its block on the card here, and runs
:func:`cheby_recurrence` over ``op.matmat_rows`` for every other operator.
"""

import torch

from . import _build
from .spmv_banded import MAX_OFFSETS, banded_matvec_plain, launch_plan

#: The operand dtypes the kernel takes.
DTYPES = (torch.float32, torch.float64)


def _affine(matmat, T, c, scale):
    """``(A T - c T) * scale`` for the row block ``T`` (``matmat(T)`` is
    ``A T``): the b-column product and two in-place passes over its
    output."""
    AT = matmat(T)
    return AT.sub_(T, alpha=c).mul_(scale)


def cheby_recurrence(matmat, X, coeffs, lmin, lmax):
    """``p(A)`` applied to the rows of ``X`` ``(s, n)`` in eager PyTorch
    (``matmat(T)`` is ``A T``): the recurrence ``T_{j+1} = 2 (A T_j - c
    T_j) / e - T_{j-1}``, ``Y += coeffs[j] T_{j+1}``, one product a degree
    over the whole block.  Each step writes into the product's output and
    ``Y`` in place (no other ``(s, n)`` tensor); ``X`` is not modified.
    Degree 0 is ``coeffs[0] X``."""
    coeffs = [float(x) for x in coeffs]
    N = len(coeffs) - 1
    if N == 0:
        return torch.mul(X, coeffs[0])
    c = 0.5 * (lmax + lmin)
    inv_e = 2.0 / (lmax - lmin)
    T_prev, T = X, _affine(matmat, X, c, inv_e)
    Y = torch.mul(X, coeffs[0]).add_(T, alpha=coeffs[1])
    for j in range(2, N + 1):
        T_next = _affine(matmat, T, c, 2.0 * inv_e).sub_(T_prev)
        Y.add_(T_next, alpha=coeffs[j])
        T_prev, T = T, T_next
    return Y


def cheby_banded_plain(bands, offsets, X, coeffs, lmin, lmax):
    """:func:`cheby_recurrence` over the plain DIA product: one product and
    four in-place elementwise passes a step."""
    offsets = tuple(int(o) for o in offsets)
    return cheby_recurrence(lambda T: banded_matvec_plain(bands, T, offsets),
                            X, coeffs, lmin, lmax)


def cheby_banded(bands, offsets, X, coeffs, lmin, lmax):
    """``p(A) X`` for the rows of ``X`` ``(s, n)``: the kernel for CUDA
    tensors, the plain version for CPU tensors.  ``bands``: (k, n);
    ``offsets``: k ints; ``coeffs``: the ``degree + 1`` Chebyshev
    coefficients; ``[lmin, lmax]``: the spectral enclosure.  Returns ``Y``
    ``(s, n)``; ``X`` is not modified."""
    device = _build.operand_device("cheby_banded", bands, X)
    offsets, k, array = launch_plan(tuple(offsets))
    n = bands.shape[-1]
    if bands.ndim != 2 or bands.shape[0] != k or X.ndim != 2 or X.shape[1] != n:
        raise ValueError(f"cheby_banded: bands {tuple(bands.shape)}, X "
                         f"{tuple(X.shape)}, {k} offsets")
    if X.dtype not in DTYPES:
        raise TypeError(f"cheby_banded: float32 or float64 operands, got {X.dtype}")
    coeffs = [float(v) for v in coeffs]
    if not coeffs:
        raise ValueError("cheby_banded: no coefficients")
    if device < 0:
        return cheby_banded_plain(bands, offsets, X, coeffs, lmin, lmax)
    if k > MAX_OFFSETS:
        raise ValueError(f"cheby_banded: the kernel takes at most {MAX_OFFSETS} "
                         f"diagonals, got {k}")
    if len(coeffs) == 1 or X.shape[0] == 0:
        return torch.mul(X, coeffs[0])
    fn = _build.kernel_fn("arn_cheby_dia", X.dtype)
    s = X.shape[0]
    c = 0.5 * (lmax + lmin)
    inv_e = 2.0 / (lmax - lmin)

    def step(T, prev, out, Y, scale, c0, coef, first):
        rc = _build.launch(fn, device, bands.data_ptr(), T.data_ptr(),
                           prev.data_ptr(), out.data_ptr(), Y.data_ptr(), n, k,
                           array, s, c, scale, c0, coef, first)
        if rc:
            _build.check(rc, "cheby_banded")
        _build.count_launch(cheby_banded, X.dtype)

    T, Y = torch.empty_like(X), torch.empty_like(X)
    step(X, X, T, Y, inv_e, coeffs[0], coeffs[1], 1)
    prev = X
    for coef in coeffs[2:]:
        out = torch.empty_like(X) if prev is X else prev   # X stays as it is
        step(T, prev, out, Y, 2.0 * inv_e, 0.0, coef, 0)
        prev, T = T, out
    return Y


cheby_banded.launches = 0
cheby_banded.dtype_launches = {}
