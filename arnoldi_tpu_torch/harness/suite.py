"""Benchmark and comparison harness library.

Counterpart of ``arnoldi_tpu/harness/suite.py`` (itself parity with the
reference's ``scripts/utils.py``): uniform parameters, wall time and
matvec statistics, the ARPACK driver with a matvec counter, Hungarian
eigenvalue matching, residual printing, and the port's own drivers.  The
NumPy/SciPy pieces are copies (the JAX package's module imports JAX on
use); the drivers call the port's ``partial_schur`` and
``explicit_restarts_with_deflation`` on ``device=``, with
``torch.cuda.synchronize()`` inside the timed window on the card.  Start
vectors come from a ``torch.Generator`` (or an explicit ``v0``) where the
JAX package takes a ``jax.random`` key.  The SLEPc comparison is
:mod:`arnoldi_tpu_torch.harness.slepc`.
"""

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import LinearOperator, eigs


@dataclasses.dataclass
class EigensolverParameters:
    """Uniform solver configuration (reference ``scripts/utils.py:37-52``)."""

    nev: int
    ncv: int | None = None  # max Krylov dimension (ARPACK's ncv)
    tol: float = 1e-8
    max_restarts: int = 1000
    p: int | None = None
    which: str = "LM"

    @classmethod
    def from_cli_args(cls, args):
        return cls(
            nev=args.nev, ncv=args.max_dim, tol=args.tol,
            max_restarts=args.max_it, p=args.p, which=args.which,
        )


@dataclasses.dataclass
class Statistics:
    """Per-run measurement record (reference ``scripts/utils.py:29-35``)."""

    elapsed: float
    dtype: str
    matvecs: int
    restarts: int


class MatvecCounter(LinearOperator):
    """SciPy LinearOperator wrapper counting matvecs
    (reference ``scripts/utils.py:55-68``)."""

    def __init__(self, A):
        self.A = A
        self.n_matvecs = 0
        super().__init__(dtype=A.dtype, shape=A.shape)

    def _matvec(self, x):
        self.n_matvecs += 1
        return self.A @ x

    def _rmatvec(self, x):
        # The adjoint is cached: rebuilding csc->csr per call would bill
        # the conversion as matvecs.
        self.n_matvecs += 1
        if not hasattr(self, "_AH"):
            self._AH = self.A.conj().T
            if sp.issparse(self._AH):
                self._AH = sp.csr_matrix(self._AH)
        return self._AH @ x


def find_best_matching(a, b):
    """Hungarian matching of two eigenvalue sets
    (reference ``scripts/utils.py:85-99``)."""
    from scipy.optimize import linear_sum_assignment

    a = np.asarray(a)
    b = np.asarray(b)
    k = min(a.shape[0], b.shape[0])
    cost = np.abs(a[:, None] - b[None, :])
    row_ind, col_ind = linear_sum_assignment(cost)
    return a[row_ind[:k]], b[col_ind[:k]]


#: Sort keys per ARPACK 'which' string, oriented so WANTED values have the
#: LARGEST key (the least-wanted returned value sits at the key minimum).
_WHICH_KEYS = {
    "LM": lambda x: np.abs(x), "SM": lambda x: -np.abs(x),
    "LR": lambda x: np.real(x), "SR": lambda x: -np.real(x),
    "LI": lambda x: np.imag(x), "SI": lambda x: -np.imag(x),
}


def eigenvalues_match(a, b, which="LM", rtol=1e-4, atol=1e-8):
    """Hungarian-matched eigenvalue agreement, tolerant of boundary ties.

    On spectra with exactly tied sort keys (mark's spectrum is symmetric
    +/-lambda) a request that cuts through a tied cluster is ambiguous, so
    two correct solvers may return sets that differ in one element.  A
    mismatched pair is accepted iff the two values share a sort key to
    ``rtol`` and that key lies at the selection boundary (the least-wanted
    key of the returned sets), and neither value duplicates a value its own
    side already matched (a ghost copy, not a tie pick).
    """
    a = np.asarray(a)
    b = np.asarray(b)
    a_m, b_m = find_best_matching(a, b)
    close = np.isclose(a_m, b_m, rtol=rtol, atol=atol)
    if close.all():
        return True
    key = _WHICH_KEYS[which] if isinstance(which, str) else which
    ka, kb = key(a_m), key(b_m)
    boundary = min(key(a).min(), key(b).min())
    matched_a = a_m[close]
    matched_b = b_m[close]
    for i in np.nonzero(~close)[0]:
        scale = max(abs(ka[i]), abs(kb[i]), abs(boundary))
        tied = abs(ka[i] - kb[i]) <= rtol * scale + atol
        at_boundary = (abs(ka[i] - boundary) <= rtol * scale + atol
                       or abs(kb[i] - boundary) <= rtol * scale + atol)
        if not (tied and at_boundary):
            return False
        vscale = max(abs(a_m[i]), abs(b_m[i]), 1e-30)
        if (np.any(np.abs(matched_a - a_m[i]) <= rtol * vscale + atol)
                or np.any(np.abs(matched_b - b_m[i]) <= rtol * vscale + atol)):
            return False
    return True


def settle_with_spectrum(vals, exact, which, rtol=1e-6):
    """How a solver's values ``vals`` stand against the whole exact
    spectrum ``exact`` when the ``len(vals)`` values ``which`` wants ("LM"
    or "LR") were asked for: "wanted" when they are those values counted
    with multiplicity; "copies missed" when each is an eigenvalue (a copy
    used once), every distinct eigenvalue wanted more than the least wanted
    value returned is among them, and so only further copies of multiple
    eigenvalues are missing (a single start vector sees a multiple
    eigenvalue once in exact arithmetic: its other copies enter by
    rounding); None otherwise.  ``rtol`` is relative to each value."""
    key = np.abs if which == "LM" else np.real
    v = np.sort(np.real(np.asarray(vals)))
    e = np.sort(np.asarray(exact, dtype=np.float64))
    used = np.zeros(e.size, dtype=bool)
    for x in v:
        lo, hi = np.searchsorted(e, [x - rtol * abs(x), x + rtol * abs(x)])
        free = np.nonzero(~used[lo:hi])[0]
        if free.size == 0:
            return None
        used[lo + free[0]] = True
    want = np.sort(e[np.argsort(-key(e), kind="stable")[:v.size]])
    if np.allclose(want, v, rtol=rtol, atol=0):
        return "wanted"
    worst = key(v).min()
    better = e[key(e) > worst + rtol * abs(worst)]
    if all(np.abs(v - b).min() <= rtol * abs(b) for b in better):
        return "copies missed"
    return None


def print_residuals(name, A, vals, vecs, file=None):
    """Normalized residual report (reference ``scripts/utils.py:125-133``);
    ``vecs`` a NumPy array or a tensor on any device."""
    vecs = _host(vecs)
    res = np.linalg.norm(A @ vecs - vals * vecs, axis=0) / np.abs(vals)
    print(f"{name}: normalized residuals {res}", file=file)
    return res


def _host(t):
    """A tensor (any device) or array as a NumPy array."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def arpack_eig(A, params: EigensolverParameters, v0=None):
    """ARPACK oracle with matvec counting
    (reference ``scripts/utils.py:136-158``).

    ``v0``: explicit start vector.  Without it ARPACK draws from its own
    Fortran RNG, whose state persists across calls in a process, so on
    tied-|lambda| clusters the converged member can depend on how many
    ARPACK solves ran before; sweeps pass a seeded ``v0``.
    """
    counter = MatvecCounter(A)
    ncv = params.ncv
    t0 = time.perf_counter()
    vals, vecs = eigs(
        counter, params.nev, which=params.which, tol=params.tol,
        ncv=ncv, maxiter=params.max_restarts, v0=v0,
    )
    elapsed = time.perf_counter() - t0
    nev, ncv_eff = params.nev, ncv or min(A.shape[0], max(2 * params.nev + 1, 20))
    iters = max((counter.n_matvecs - ncv_eff) // max(ncv_eff - nev, 1), 1)
    stats = Statistics(elapsed, str(A.dtype), counter.n_matvecs, iters)
    return vals, vecs, stats


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def start_vector(n, seed):
    """The float64 unit start vector of a harness run (NumPy), drawn from
    ``torch.Generator().manual_seed(seed)``: every method of a row starts
    from it."""
    import torch

    from ..utils.random import rand_normalized_vector

    return rand_normalized_vector(n, torch.float64, device="cpu",
                                  generator=torch.Generator().manual_seed(seed)
                                  ).numpy()


def arnoldi_tpu_eig(A, params: EigensolverParameters, *, dtype=None,
                    ortho=None, generator=None, v0=None, device="cuda"):
    """The port's driver under the harness's interface (the JAX package's
    name, kept): ``partial_schur`` on ``device`` (SciPy input at most
    32768 rows runs on the host tier, results on ``device``), eigenpairs
    from its Schur form, and statistics; the timed window ends with
    ``torch.cuda.synchronize()`` on the card."""
    from ..solvers.krylov_schur import (eigenpairs_from_partial_schur,
                                        partial_schur)

    kwargs = dict(
        max_dim=params.ncv, stopping_criterion=params.tol,
        sort_function=params.which, max_restarts=params.max_restarts,
        p=params.p, device=device,
    )
    if dtype is not None:
        kwargs["dtype"] = dtype
    if ortho is not None:
        kwargs["ortho"] = ortho
    if generator is not None:
        kwargs["generator"] = generator
    if v0 is not None:
        kwargs["v0"] = v0

    t0 = time.perf_counter()
    Q, T, history = partial_schur(A, params.nev, **kwargs)
    _sync(device)
    elapsed = time.perf_counter() - t0

    vals, vecs = eigenpairs_from_partial_schur(Q, T)
    stats = Statistics(
        elapsed, str(Q.dtype).removeprefix("torch."), history.total_matvecs,
        int(history.restarts.max()),
    )
    return vals, vecs, stats


def _reference_package():
    """Import the reference implementation (cournape/arnoldi-py) from
    ``$ARNOLDI_REF_PATH`` (its ``src`` directory).  Returns the imported
    package, or None when the variable is unset or the package is not
    there or not importable."""
    import importlib
    import os
    import sys

    path = os.environ.get("ARNOLDI_REF_PATH")
    if not path or not os.path.isdir(os.path.join(path, "arnoldi")):
        return None
    if path not in sys.path:
        sys.path.insert(0, path)
    try:
        return importlib.import_module("arnoldi")
    except ImportError:
        return None


def arnoldi_py_ref_eig(A, params: EigensolverParameters, v0=None):
    """The reference implementation under this harness's interface
    (``scripts/utils.py:161-187``'s ``arnoldi_py_eig``), as the JAX
    package runs it: the operator cast to complex128 and wrapped in a
    matvec counter, ``arnoldi.krylov_schur.partial_schur``, eigenpairs by
    diagonalizing T.  ``v0`` replaces the reference's start-vector draw
    for the call (its module-level ``rand_normalized_vector``), so it
    starts from the vector ARPACK gets.  Raises ``RuntimeError`` when the
    reference is not importable."""
    import importlib

    ref = _reference_package()
    if ref is None:
        raise RuntimeError(
            "reference package not importable (set ARNOLDI_REF_PATH)")
    ref_ks = importlib.import_module("arnoldi.krylov_schur")
    ref_utils = importlib.import_module("arnoldi.utils")

    sort_function = {
        "LM": ref_utils.arg_largest_magnitude,
        "LR": ref_utils.arg_largest_real,
    }[params.which]

    counter = MatvecCounter(sp.csr_matrix(A).astype(np.complex128))
    orig = ref_ks.rand_normalized_vector
    if v0 is not None:
        start = np.asarray(v0)
        start = start / np.linalg.norm(start)

        def rand_normalized_vector(n, dtype=np.float64):
            return start.astype(dtype)

        ref_ks.rand_normalized_vector = rand_normalized_vector
    try:
        t0 = time.perf_counter()
        Q, T, history = ref_ks.partial_schur(
            counter, params.nev, max_dim=params.ncv,
            stopping_criterion=params.tol,
            max_restarts=params.max_restarts,
            sort_function=sort_function, p=params.p,
        )
        elapsed = time.perf_counter() - t0
    finally:
        ref_ks.rand_normalized_vector = orig

    vals, S = np.linalg.eig(T)
    vecs = Q @ S
    idx = sort_function(vals)
    vals = vals[idx]
    vecs = vecs[:, idx]
    stats = Statistics(elapsed, "complex128", counter.n_matvecs,
                       int(np.max(history.restarts)))
    return vals, vecs, stats


def deflation_eig(A, params: EigensolverParameters, *, generator=None,
                  device="cuda"):
    """The explicit-restart-with-deflation driver under the same
    interface, on ``device``."""
    from ..solvers.explicit_restarts import explicit_restarts_with_deflation

    t0 = time.perf_counter()
    vals, vecs, history = explicit_restarts_with_deflation(
        A, params.nev, max_dim=params.ncv, stopping_criterion=params.tol,
        sort_function=params.which, max_restarts=params.max_restarts,
        generator=generator, device=device,
    )
    _sync(device)
    elapsed = time.perf_counter() - t0
    stats = Statistics(
        elapsed, str(vecs.dtype).removeprefix("torch."), history.total_matvecs,
        int(history.restarts.max()),
    )
    return vals, _host(vecs), stats


def matrix_from_spec(spec, dtype=np.float64):
    """Resolve a matrix specification: a path to a SuiteSparse ``.mat`` /
    MatrixMarket ``.mtx`` file, or a generator spec like ``mark:100``,
    ``laplace:512``, ``laplace2d:64``, ``grcar:200``, ``clement:200``."""
    from .. import matrices as M

    if ":" in str(spec):
        name, _, arg = str(spec).partition(":")
        size = int(arg)
        if name == "mark":
            return M.mark(size, dtype=dtype)
        if name == "laplace":
            return sp.csr_matrix(M.laplace(size, dtype=dtype))
        if name == "laplace2d":
            return M.laplace_2d(size, dtype=dtype).astype(dtype)
        if name == "grcar":
            return grcar_matrix(size, dtype=dtype)
        if name == "clement":
            return clement_matrix(size, dtype=dtype)
        raise ValueError(f"Unknown matrix generator {name!r}")
    s = str(spec)
    if s.endswith(".mat"):
        return M.load_suitesparse_mat(s, dtype=dtype)
    if s.endswith((".mtx", ".mtx.gz")):
        return M.load_matrix_market(s, dtype=dtype)
    raise ValueError(f"Cannot interpret matrix spec {spec!r}")


def grcar_matrix(n, dtype=np.float64):
    """Grcar test matrix (reference ``scripts/compare-against-arpack.py:27``):
    -1 on the subdiagonal, 1 on the main and three superdiagonals."""
    diags = [-np.ones(n - 1, dtype=dtype)] + [
        np.ones(n - k, dtype=dtype) for k in range(0, 4)
    ]
    return sp.diags_array(diags, offsets=[-1, 0, 1, 2, 3]).tocsr()


def clement_matrix(n, dtype=np.float64):
    """Clement tridiagonal matrix with eigenvalues ±(n-1), ±(n-3), ...
    (reference ``scripts/compare-against-arpack.py:36``)."""
    k = np.arange(1, n, dtype=dtype)
    sub = np.sqrt(k * (n - k))
    return sp.diags_array([sub, sub], offsets=[-1, 1]).tocsr()


def add_device_argument(parser):
    """The CLIs' ``--device cuda|cpu`` (default ``cuda``)."""
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (default): the card; cpu: the kernels' "
                        "plain PyTorch versions and the host tier")


def check_device(device):
    """Fail a CLI asked for the card where there is none."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is false; "
                         "pass --device cpu to run on the CPU")
    return device
