"""The fused CG route of the shift-invert operators
(``ops/kernels/cg_banded.py``, ``csrc/cg_banded.cu``).

On the CPU: which inner solves take the route (a single-device DIA
operator of real dtype, a real shift, cg, no preconditioner) and that the
route's plain version gives the eager loop's bits; every other case keeps
its solver; the plain version's edge cases; the ``inner.fused`` span and
its reader ``inner.fused_pct``.  On the card (marked ``cuda``; each skips
without one, the ``cuda_device`` fixture decides): the kernel against its
plain version and the eager loop on the same card tensors.  No JAX here,
so the file also runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cg_banded.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import arnoldi_tpu_torch as port
from arnoldi_tpu_torch import matrices
from arnoldi_tpu_torch.linop import CallableOperator, as_operator
from arnoldi_tpu_torch.ops import kernels
from arnoldi_tpu_torch.ops.kernels import cg_banded as cgb
from arnoldi_tpu_torch.solvers import inner
from arnoldi_tpu_torch.solvers import spectral_transform as st
from arnoldi_tpu_torch.utils import profiling
from torch_parity import cuda_device  # noqa: F401 (fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SIGMA = 0.01
TOL = 1e-10


def _rhs(n, dtype=torch.float64, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(dtype)


def _eager(op, sigma, b, *, tol=TOL, maxiter=2000):
    """The eager loop as the shift-invert operator ran it before the route."""
    def shifted_mv(x):
        return torch.add(op.matvec(x), x, alpha=-sigma)

    return inner.cg(shifted_mv, b, tol=tol, maxiter=maxiter)


@pytest.fixture
def spies(monkeypatch):
    """Record the calls of the fused wrapper and of each eager solver."""
    calls = {"cg_banded": [], "cg": [], "bicgstab": [], "gmres": []}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append(out)
            return out
        return wrapped

    monkeypatch.setattr(st, "cg_banded", spy("cg_banded", st.cg_banded))
    for name in ("cg", "bicgstab", "gmres"):
        monkeypatch.setitem(st._SOLVERS, name, spy(name, st._SOLVERS[name]))
    return calls


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_banded_cg_takes_the_route_with_the_eager_bits(spies, dtype):
    op = as_operator(matrices.laplace_2d(20), dtype=dtype, device="cpu")
    b = _rhs(op.shape[0], dtype)
    si = st.shift_invert_operator(op, SIGMA, solver="cg", inner_tol=TOL,
                                  count_inner=True)
    x = si.matvec(b)
    ((x_route, info),) = spies["cg_banded"]
    want, want_info = _eager(op, SIGMA, b)
    assert torch.equal(x, want) and torch.equal(x_route, want)
    assert info == want_info and want_info.iterations > 1
    assert si.inner_stats.solves == 1
    assert si.inner_stats.inner_matvecs == want_info.matvecs


def _jacobi(A):
    return sp.diags(1.0 / A.diagonal())


#: case -> (the operator-like A, the transformed operator built from it,
#: the eager solver it must keep)
BYPASS = {
    "ell": (lambda A: as_operator(A, format="ell", device="cpu"),
            lambda op: st.shift_invert_operator(op, SIGMA, solver="cg"), "cg"),
    "bsr": (lambda A: as_operator(A, format="bsr", device="cpu"),
            lambda op: st.shift_invert_operator(op, SIGMA, solver="cg"), "cg"),
    "dense": (lambda A: as_operator(torch.from_numpy(A.toarray()), device="cpu"),
              lambda op: st.shift_invert_operator(op, SIGMA, solver="cg"), "cg"),
    "callable": (lambda A: (lambda op: CallableOperator(
                     op.matvec, op.shape, op.dtype, device="cpu"))(
                     as_operator(A, device="cpu")),
                 lambda op: st.shift_invert_operator(op, SIGMA, solver="cg"),
                 "cg"),
    "complex_dtype": (lambda A: as_operator(A, dtype=torch.complex128,
                                            device="cpu"),
                      lambda op: st.shift_invert_operator(op, SIGMA, solver="cg"),
                      "cg"),
    "complex_sigma": (lambda A: as_operator(A, device="cpu"),
                      lambda op: st.shift_invert_operator(op, SIGMA + 1e-3j,
                                                          solver="cg"), "cg"),
    "preconditioned": (lambda A: as_operator(A, device="cpu"),
                       lambda op: st.shift_invert_operator(
                           op, SIGMA, solver="cg",
                           M=_jacobi(matrices.laplace_2d(20) - SIGMA * sp.eye(400))),
                       "cg"),
    "pencil": (lambda A: as_operator(A, device="cpu"),
               lambda op: st.generalized_operator(
                   op, sp.diags(np.full(400, 2.0)).tocsr(), SIGMA, solver="cg",
                   device="cpu"), "cg"),
    "bicgstab": (lambda A: as_operator(A, device="cpu"),
                 lambda op: st.shift_invert_operator(op, SIGMA,
                                                     solver="bicgstab"),
                 "bicgstab"),
    "gmres": (lambda A: as_operator(A, device="cpu"),
              lambda op: st.shift_invert_operator(op, SIGMA, solver="gmres"),
              "gmres"),
}


@pytest.mark.parametrize("case", sorted(BYPASS))
def test_every_other_case_keeps_its_solver(spies, case):
    make_op, transform, solver = BYPASS[case]
    op = make_op(matrices.laplace_2d(20).tocsr())
    if case == "pencil":
        # the pencil's diagonal mass is a DIA operator too
        assert type(op).__name__ == "BandedOperator"
    tr = transform(op)
    b = _rhs(400).to(tr.dtype)
    x = tr.matvec(b)
    assert spies["cg_banded"] == []
    assert len(spies[solver]) == 1
    assert torch.equal(x, spies[solver][0][0])


def test_a_complex_vector_through_the_real_route_takes_the_eager_loop(spies):
    """A complex outer solve of the real operator hands the route complex
    vectors: they go to the eager loop, as before the route."""
    op = as_operator(matrices.laplace_2d(20), device="cpu")
    si = st.shift_invert_operator(op, SIGMA, solver="cg", inner_tol=TOL)
    b = torch.complex(_rhs(400, seed=1), _rhs(400, seed=2))
    x = si.matvec(b)
    assert spies["cg_banded"] == [] and len(spies["cg"]) == 1
    assert x.is_complex()


def test_eigsh_shift_invert_takes_the_route_on_the_cpu(spies):
    """A whole eigsh(sigma=) solve: every inner solve takes the route, and
    the values nearest sigma come out (a rectangular grid: no double
    eigenvalue a scalar Krylov space could hold one copy of)."""
    A = matrices.laplace_2d(20, 23)
    op = as_operator(A, device="cpu")
    gen = torch.Generator().manual_seed(5)
    vals, V = port.eigsh(op, k=4, sigma=SIGMA, ncv=20, inner_solver="cg",
                         tol=1e-8, generator=gen)
    assert len(spies["cg_banded"]) > 0 and spies["cg"] == []
    exact = np.sort(np.linalg.eigvalsh(A.toarray()))
    nearest = np.sort(exact[np.argsort(np.abs(exact - SIGMA))[:4]])
    np.testing.assert_allclose(np.sort(vals), nearest, rtol=0, atol=1e-9)


# -- the plain version's edge cases ------------------------------------------

def _diag_plain(n, value):
    return torch.full((1, n), value, dtype=torch.float64), (0,)


def test_plain_zero_rhs_stops_before_the_first_iteration():
    op = as_operator(matrices.laplace_2d(12), device="cpu")
    b = torch.zeros(144, dtype=torch.float64)
    x, info = cgb.cg_banded(op.bands, op.offsets, SIGMA, b, tol=TOL)
    assert torch.count_nonzero(x) == 0
    assert info == inner.SolveInfo(0, 1)


@pytest.mark.parametrize("maxiter", [1, 3, 7])
def test_plain_maxiter_is_honoured(maxiter):
    op = as_operator(matrices.laplace_2d(12), device="cpu")
    b = _rhs(144)
    x, info = cgb.cg_banded(op.bands, op.offsets, SIGMA, b, tol=TOL,
                            maxiter=maxiter)
    assert info == inner.SolveInfo(maxiter, maxiter + 1)
    want, want_info = _eager(op, SIGMA, b, maxiter=maxiter)
    assert torch.equal(x, want) and info == want_info


def test_plain_tol_met_at_the_first_iteration():
    """(3 - 1) I x = b: the first step solves it exactly."""
    bands, offsets = _diag_plain(50, 3.0)
    b = _rhs(50)
    x, info = cgb.cg_banded(bands, offsets, 1.0, b, tol=TOL)
    assert info == inner.SolveInfo(1, 2)
    assert torch.equal(x, b * 0.5)


def test_plain_matches_the_eager_loop_on_a_wide_band():
    """Offsets past n, a lower and an upper band (laplace_2d's +-nx)."""
    op = as_operator(matrices.laplace_2d(9), device="cpu")
    b = _rhs(81, seed=3)
    x, info = cgb.cg_banded(op.bands, op.offsets, SIGMA, b, tol=TOL,
                            maxiter=500)
    want, want_info = _eager(op, SIGMA, b, maxiter=500)
    assert torch.equal(x, want) and info == want_info


def test_wrapper_rejects_what_the_kernel_does_not_take():
    op = as_operator(matrices.laplace_2d(6), device="cpu")
    with pytest.raises(ValueError):
        cgb.cg_banded(op.bands, op.offsets, SIGMA, torch.zeros(35,
                      dtype=torch.float64))
    with pytest.raises(TypeError):
        cgb.cg_banded(op.bands.to(torch.complex128), op.offsets, SIGMA,
                      torch.zeros(36, dtype=torch.complex128))
    with pytest.raises(TypeError):
        cgb.cg_banded(op.bands, op.offsets, SIGMA,
                      torch.zeros(36, dtype=torch.float32))


# -- the span and its reader -------------------------------------------------

@pytest.fixture
def phases_on(monkeypatch):
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    profiling.clear()
    yield
    profiling.clear()


def _sinv_spans():
    op = as_operator(matrices.laplace_2d(30), device="cpu")
    with st.accounting() as seen:
        port.eigsh(op, k=5, sigma=SIGMA, ncv=20, inner_solver="cg", tol=1e-8)
    return list(profiling.spans()), seen


class _Timeline:
    def __init__(self, intervals):
        self.device = intervals


class _Run:
    def __init__(self, timeline):
        self.timeline = timeline


def _reader():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    from portbench.catalog import Catalog

    return Catalog(REPO).metric("inner.fused_pct")


def test_each_fused_solve_is_one_span_inside_its_inner_solve(phases_on):
    spans, seen = _sinv_spans()
    solves = [s for s in spans if s.name == "inner.solve"]
    fused = [s for s in spans if s.name == "inner.fused"]
    assert len(fused) == len(solves) == sum(s.solves for s in seen["stats"])
    for s in fused:
        parent = spans[s.parent]
        assert parent.name == "inner.solve"
        assert s.count == parent.count - 1              # iterations, matvecs
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns


def test_the_reader_counts_the_inner_solves_with_a_fused_child(phases_on):
    spans, _ = _sinv_spans()
    (solve,) = [s for s in spans if s.name == "solve"]
    run = _Run(_Timeline([(solve.start_ns, solve.end_ns)]))
    reader = _reader()
    assert reader.read(run) == 100.0
    assert reader.read(_Run(None)) is None


def test_the_reader_reads_zero_when_no_solve_took_the_route(phases_on):
    op = as_operator(matrices.laplace_2d(30), format="ell", device="cpu")
    port.eigsh(op, k=3, sigma=SIGMA, ncv=20, inner_solver="cg", tol=1e-6)
    spans = list(profiling.spans())
    assert not any(s.name == "inner.fused" for s in spans)
    (solve,) = [s for s in spans if s.name == "solve"]
    run = _Run(_Timeline([(solve.start_ns, solve.end_ns)]))
    assert _reader().read(run) == 0.0


# -- on the card ---------------------------------------------------------------

def _card_system(side, dtype, device, seed=7):
    op = as_operator(matrices.laplace_2d(side), dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    b = torch.randn(op.shape[0], generator=gen, device=device, dtype=dtype)
    return op, b


def _relative(x, want):
    return float(torch.linalg.vector_norm(x - want) / torch.linalg.vector_norm(want))


def _references(op, b, *, maxiter=2000):
    """The plain version and the eager loop on the same card tensors."""
    return {"plain": cgb.cg_banded_plain(op.bands, op.offsets, SIGMA, b, tol=TOL,
                                         maxiter=maxiter),
            "eager": _eager(op, SIGMA, b, maxiter=maxiter)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("side", [64, 724])
def test_kernel_matches_the_plain_version_on_the_card(side, dtype, rtol, cuda_device):
    op, b = _card_system(side, dtype, cuda_device)
    x, info = cgb.cg_banded(op.bands, op.offsets, SIGMA, b, tol=TOL,
                            maxiter=2000)
    assert info.matvecs == info.iterations + 1
    for name, (want, want_info) in _references(op, b).items():
        assert abs(info.iterations - want_info.iterations) <= 1, name
        assert _relative(x, want) <= rtol, name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_honours_maxiter_on_the_card(dtype, cuda_device):
    op, b = _card_system(64, dtype, cuda_device)
    for maxiter in (1, 2, 17):
        x, info = cgb.cg_banded(op.bands, op.offsets, SIGMA, b, tol=TOL,
                                maxiter=maxiter)
        assert info == inner.SolveInfo(maxiter, maxiter + 1)
        for name, (want, _) in _references(op, b, maxiter=maxiter).items():
            assert _relative(x, want) <= (1e-12 if dtype == torch.float64
                                          else 1e-5), name


@pytest.mark.cuda
def test_kernel_takes_a_zero_rhs_on_the_card(cuda_device):
    op, b = _card_system(64, torch.float64, cuda_device)
    x, info = cgb.cg_banded(op.bands, op.offsets, SIGMA, torch.zeros_like(b),
                            tol=TOL)
    assert info == inner.SolveInfo(0, 1)
    assert torch.count_nonzero(x) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("side", [64, 724])
def test_kernel_two_calls_bit_identical_on_the_card(side, cuda_device):
    op, b = _card_system(side, torch.float64, cuda_device)
    x1, info1 = cgb.cg_banded(op.bands, op.offsets, SIGMA, b, tol=TOL,
                              maxiter=2000)
    x2, info2 = cgb.cg_banded(op.bands, op.offsets, SIGMA, b, tol=TOL,
                              maxiter=2000)
    assert info1 == info2 and torch.equal(x1, x2)


@pytest.mark.cuda
def test_one_launch_a_solve_on_the_card(cuda_device):
    op, b = _card_system(64, torch.float64, cuda_device)
    si = st.shift_invert_operator(op, SIGMA, solver="cg", inner_tol=TOL,
                                  count_inner=True)
    before = kernels.launch_counts()["cg_banded"]
    for _ in range(3):
        si.matvec(b)
    assert kernels.launch_counts()["cg_banded"] == before + 3
    assert si.inner_stats.solves == 3


def _banded(n, far):
    """Diagonally dominant and symmetric, with bands at 0, +-1 and +-far."""
    off = [0, 1, -1, far, -far]
    vals = [4.0, -0.9, -0.9, -0.9, -0.9]
    return sp.diags([np.full(n - abs(o), v) for o, v in zip(off, vals)], off,
                    format="csr")


#: plan -> (the matrix, dtype).  Beside laplace_2d(64) and (724) above, each
#: block's rows in registers: a halo reaching over several blocks (500 rows
#: a block, offsets +-3,000); and the direct form: 1M rows (past a thread's
#: registers) and offsets +-20,000 apart (past the shared memory).
PLANS = {"resident_wide_halo": (lambda: _banded(20_000, 3_000), torch.float64),
         "direct_1m_rows_float32": (lambda: matrices.laplace_2d(1000), torch.float32),
         "direct_1m_rows_float64": (lambda: matrices.laplace_2d(1000), torch.float64),
         "direct_far_offsets": (lambda: _banded(40_003, 20_000), torch.float64)}


@pytest.mark.cuda
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_kernel_plans_match_the_plain_version_on_the_card(plan, cuda_device):
    matrix, dtype = PLANS[plan]
    op = as_operator(matrix(), dtype=dtype, format="banded", device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    b = torch.randn(op.shape[0], generator=gen, device=cuda_device, dtype=dtype)
    x, info = cgb.cg_banded(op.bands, op.offsets, SIGMA, b, tol=TOL,
                            maxiter=2000)
    for name, (want, want_info) in _references(op, b).items():
        assert abs(info.iterations - want_info.iterations) <= 1, name
        assert _relative(x, want) <= (1e-12 if dtype == torch.float64
                                      else 1e-5), name
