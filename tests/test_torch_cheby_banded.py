"""The fused route of the Chebyshev filter (``ops/kernels/cheby_banded.py``,
``arn_cheby_dia`` in ``csrc/spmv_banded.cu``).

On the CPU: which operators take the route (a single-device DIA operator
of real dtype, its block on the card) and that its plain version gives
the eager recurrence's bits; every other operator, and CPU tensors, keep
the eager recurrence; ``X`` is never written; the ``filter.fused`` span
and its reader ``filter.fused_pct`` (with the route's decision made as on
a card, so that its plain version runs on CPU tensors).
On the card (marked ``cuda``; each skips without one, the ``cuda_device``
fixture decides): the kernel against its plain version on the same card
tensors, one launch a degree step, repeatable bits.  No JAX here, so the
file also runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cheby_banded.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from arnoldi_tpu_torch import matrices
from arnoldi_tpu_torch.linop import CallableOperator, as_operator
from arnoldi_tpu_torch.ops import kernels
from arnoldi_tpu_torch.ops.kernels import cheby_banded as cb
from arnoldi_tpu_torch.parallel import halo_matvec_closure, make_mesh, shard_operator
from arnoldi_tpu_torch.solvers import filtered as pf
from arnoldi_tpu_torch.utils import profiling
from torch_parity import cuda_device  # noqa: F401 (fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BOUNDS = (-12.2, 0.2)          # an enclosure of laplace_3d's spectrum
WINDOW = (-6.5, -5.5)          # a wide window: p(A) X is of X's size


def _coeffs(degree):
    return pf.jackson_cheby_coeffs(*WINDOW, *BOUNDS, degree)


def _block(s, n, dtype=torch.float64, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((s, n))).to(device=device,
                                                             dtype=dtype)


def _eager(op, X, coeffs, lmin, lmax):
    """The filter as ``cheby_filter`` ran it before the route: one product
    and four in-place elementwise passes a step."""
    coeffs = [float(x) for x in coeffs]
    c = 0.5 * (lmax + lmin)
    inv_e = 2.0 / (lmax - lmin)

    def affine(T, scale):
        return op.matmat_rows(T).sub_(T, alpha=c).mul_(scale)

    T_prev, T = X, affine(X, inv_e)
    Y = torch.mul(X, coeffs[0]).add_(T, alpha=coeffs[1])
    for j in range(2, len(coeffs)):
        T_next = affine(T, 2.0 * inv_e).sub_(T_prev)
        Y.add_(T_next, alpha=coeffs[j])
        T_prev, T = T, T_next
    return Y


class _OnCard:
    """What ``cheby_filter``'s route decision reads of a block, as a card
    tensor of ``X``'s dtype would give it."""
    is_cuda = True

    def __init__(self, X):
        self.dtype = X.dtype


@pytest.fixture
def route_on_cpu(monkeypatch):
    """``cheby_filter`` decides its route as for a block on the card, so
    the route (its plain version) runs on CPU tensors."""
    fused = pf._fused
    monkeypatch.setattr(pf, "_fused", lambda op, X: fused(op, _OnCard(X)))


@pytest.fixture
def spy(monkeypatch):
    """Record the calls of the fused wrapper from ``cheby_filter``."""
    calls = []
    route = pf.cheby_banded

    def wrapped(*args, **kwargs):
        calls.append(args)
        return route(*args, **kwargs)

    monkeypatch.setattr(pf, "cheby_banded", wrapped)
    return calls


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_dia_operator_takes_the_route_with_the_eager_bits(spy, dtype):
    op = as_operator(matrices.laplace_3d(8), dtype=dtype, device="cpu")
    X = _block(11, op.shape[0], dtype)
    X0 = X.clone()
    assert pf._fused(op, _OnCard(X))
    assert not pf._fused(op, X)          # CPU tensors: the eager recurrence
    assert not pf._fused(op, _OnCard(X.to(torch.complex128)))
    want = _eager(op, X0, _coeffs(40), *BOUNDS)
    assert torch.equal(pf.cheby_filter(op, X, _coeffs(40), *BOUNDS), want)
    assert spy == []
    # the route's plain version, which the wrapper runs on CPU tensors
    assert torch.equal(cb.cheby_banded(op.bands, op.offsets, X, _coeffs(40),
                                       *BOUNDS), want)
    assert torch.equal(X, X0)


def _mesh_ops(A):
    mesh = make_mesh(device="cpu")
    dia = as_operator(A, device="cpu")
    return {"sharded": shard_operator(dia, mesh),
            "halo": halo_matvec_closure(dia, mesh)}


#: case -> the operator built from laplace_3d(8), which keeps the eager
#: recurrence
BYPASS = {
    "ell": lambda A: as_operator(A, format="ell", device="cpu"),
    "bsr": lambda A: as_operator(A, format="bsr", device="cpu"),
    "dense": lambda A: as_operator(torch.from_numpy(A.toarray()), device="cpu"),
    "callable": lambda A: (lambda op: CallableOperator(
        op.matvec, op.shape, op.dtype, device="cpu"))(as_operator(A, device="cpu")),
    "complex_dtype": lambda A: as_operator(A, dtype=torch.complex128, device="cpu"),
    "sharded": lambda A: _mesh_ops(A)["sharded"],
    "halo": lambda A: _mesh_ops(A)["halo"],
}


@pytest.mark.parametrize("case", sorted(BYPASS))
def test_every_other_operator_keeps_the_eager_recurrence(spy, case):
    op = BYPASS[case](matrices.laplace_3d(8).tocsr())
    X = _block(9, op.shape[0]).to(op.dtype)
    X0 = X.clone()
    assert not pf._fused(op, _OnCard(X))
    Y = pf.cheby_filter(op, X, _coeffs(24), *BOUNDS)
    assert spy == []
    assert torch.equal(Y, _eager(op, X0, _coeffs(24), *BOUNDS))
    assert torch.equal(X, X0)


@pytest.mark.parametrize("degree", [0, 1, 2, 57])
def test_the_plain_version_gives_the_eager_bits(degree):
    op = as_operator(matrices.laplace_3d(8), device="cpu")
    X = _block(13, op.shape[0], seed=3)
    coeffs = [0.3] if degree == 0 else _coeffs(degree)
    Y = cb.cheby_banded(op.bands, op.offsets, X, coeffs, *BOUNDS)
    want = torch.mul(X, 0.3) if degree == 0 else _eager(op, X, coeffs, *BOUNDS)
    assert torch.equal(Y, want)


def test_eigsh_window_filters_through_the_route_on_the_cpu(route_on_cpu, spy):
    A = matrices.laplace_3d(10)
    vals, V, hist = pf.eigsh_window(as_operator(A, device="cpu"), (-7.0, -6.9),
                                    tol=1e-9, generator=torch.Generator().manual_seed(2))
    assert len(spy) > 0
    exact = np.sort(np.linalg.eigvalsh(A.toarray()))
    inside = exact[(exact >= -7.0) & (exact <= -6.9)]
    np.testing.assert_allclose(np.sort(vals), inside, rtol=0, atol=1e-9)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    op = as_operator(matrices.laplace_3d(4), device="cpu")
    n = op.shape[0]
    with pytest.raises(ValueError):
        cb.cheby_banded(op.bands, op.offsets, _block(3, n - 1), _coeffs(16), *BOUNDS)
    with pytest.raises(ValueError):
        cb.cheby_banded(op.bands, op.offsets, _block(3, n)[0], _coeffs(16), *BOUNDS)
    with pytest.raises(ValueError):
        cb.cheby_banded(op.bands, op.offsets, _block(3, n).T, _coeffs(16), *BOUNDS)
    with pytest.raises(ValueError):
        cb.cheby_banded(op.bands, op.offsets, _block(3, n), [], *BOUNDS)
    with pytest.raises(TypeError):
        cb.cheby_banded(op.bands.to(torch.complex128), op.offsets,
                        _block(3, n).to(torch.complex128), _coeffs(16), *BOUNDS)
    with pytest.raises(TypeError):
        cb.cheby_banded(op.bands, op.offsets, _block(3, n, torch.float32),
                        _coeffs(16), *BOUNDS)


# -- the span and its reader -------------------------------------------------

@pytest.fixture
def phases_on(monkeypatch):
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    profiling.clear()
    yield
    profiling.clear()


def test_each_routed_call_is_one_span_counting_the_degree(phases_on,
                                                         route_on_cpu):
    op = as_operator(matrices.laplace_3d(8), device="cpu")
    X = _block(5, op.shape[0])
    for degree in (1, 16, 40):
        pf.cheby_filter(op, X, _coeffs(degree), *BOUNDS)
    pf.cheby_filter(op, X, [0.5], *BOUNDS)
    pf.cheby_filter(as_operator(matrices.laplace_3d(8), format="ell", device="cpu"),
                    X, _coeffs(16), *BOUNDS)
    assert [s.count for s in profiling.spans() if s.name == "filter.fused"] == [
        1, 16, 40, 0]


def test_the_cpu_opens_no_fused_span(phases_on):
    op = as_operator(matrices.laplace_3d(8), device="cpu")
    pf.cheby_filter(op, _block(5, op.shape[0]), _coeffs(16), *BOUNDS)
    assert not any(s.name == "filter.fused" for s in profiling.spans())


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

    return Catalog(REPO).metric("filter.fused_pct")


def _window_run(fmt):
    A = matrices.laplace_3d(10)
    pf.eigsh_window(as_operator(A, format=fmt, device="cpu"), (-7.0, -6.9),
                    tol=1e-9, generator=torch.Generator().manual_seed(2))
    spans = list(profiling.spans())
    (solve,) = [s for s in spans if s.name == "solve"]
    return spans, _Run(_Timeline([(solve.start_ns, solve.end_ns)]))


def test_the_reader_reads_100_when_every_sweep_took_the_route(phases_on,
                                                             route_on_cpu):
    spans, run = _window_run("banded")
    fused = [s for s in spans if s.name == "filter.fused"]
    sweeps = [s for s in spans if s.name == "filter.sweep"]
    assert sweeps and {spans[s.parent].name for s in fused} >= {"filter.sweep"}
    assert _reader().read(run) == 100.0


def test_the_reader_reads_zero_when_no_sweep_took_the_route(phases_on):
    spans, run = _window_run("ell")
    assert not any(s.name == "filter.fused" for s in spans)
    assert _reader().read(run) == 0.0


def test_the_reader_reads_nothing_without_the_route_or_a_timeline(phases_on,
                                                                   monkeypatch):
    _, run = _window_run("banded")
    reader = _reader()
    assert reader.read(_Run(None)) is None
    monkeypatch.setattr(reader, "_ROUTE", "arnoldi_tpu_torch.ops.kernels.no_route")
    assert reader.read(run) is None


# -- on the card ---------------------------------------------------------------

def _ragged_3d(n, seed=4):
    """Symmetric, with laplace_3d(64)'s offsets (0, +-1, +-64, +-4096) and a
    row count that no row tile divides."""
    rng = np.random.default_rng(seed)
    off = [1, 64, 4096]
    bands = [rng.uniform(-1.0, 0.0, n - o) for o in off]
    return sp.diags([np.full(n, -6.0), *bands, *bands], [0, *off, *(-o for o in off)],
                    format="csr")


#: matrix -> the operator's SciPy matrix
CARD_MATRICES = {"laplace_3d(64)": lambda: matrices.laplace_3d(64),
                 "ragged 262,067": lambda: _ragged_3d(262_067)}
#: rtol of the kernel against the plain version after the degree: the
#: order of rounding only (the kernel's product is one fused multiply-add
#: chain, the plain version's rounds each product).
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CARD_DEGREE = 24


def _relative(x, want):
    return float(torch.linalg.vector_norm((x - want).double())
                 / torch.linalg.vector_norm(want.double()))


def _card_op(name, dtype, device):
    return as_operator(CARD_MATRICES[name](), dtype=dtype, format="banded",
                       device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8, 11, 64, 297, 327])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", sorted(CARD_MATRICES))
def test_kernel_matches_the_plain_version_on_the_card(name, dtype, b, cuda_device):
    op = _card_op(name, dtype, cuda_device)
    X = _block(b, op.shape[0], dtype, seed=b, device=cuda_device)
    X0 = X.clone()
    coeffs = _coeffs(CARD_DEGREE)
    Y = cb.cheby_banded(op.bands, op.offsets, X, coeffs, *BOUNDS)
    assert torch.equal(X, X0)
    want = cb.cheby_banded_plain(op.bands, op.offsets, X, coeffs, *BOUNDS)
    assert _relative(Y, want) <= RTOL[dtype]
    eager = cb.cheby_recurrence(op.matmat_rows, X, coeffs, *BOUNDS)
    assert _relative(Y, eager) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 1, 2, 16])
def test_one_launch_a_degree_step_on_the_card(degree, cuda_device):
    op = _card_op("laplace_3d(64)", torch.float64, cuda_device)
    X = _block(297, op.shape[0], seed=1, device=cuda_device)
    coeffs = [0.3] if degree == 0 else _coeffs(degree)
    kernels.reset_launch_counts()
    Y = pf.cheby_filter(op, X, coeffs, *BOUNDS)
    assert kernels.launch_counts()["cheby_banded"] == degree
    assert kernels.launch_counts()["spmv_dia_cols"] == 0
    want = cb.cheby_banded_plain(op.bands, op.offsets, X, coeffs, *BOUNDS)
    assert _relative(Y, want) <= RTOL[torch.float64]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_two_calls_give_identical_bits_on_the_card(dtype, cuda_device):
    op = _card_op("laplace_3d(64)", dtype, cuda_device)
    X = _block(297, op.shape[0], dtype, seed=2, device=cuda_device)
    coeffs = _coeffs(40)
    Y1 = cb.cheby_banded(op.bands, op.offsets, X, coeffs, *BOUNDS)
    Y2 = cb.cheby_banded(op.bands, op.offsets, X, coeffs, *BOUNDS)
    assert torch.equal(Y1, Y2)


@pytest.mark.cuda
def test_eigsh_window_on_the_card_filters_through_the_route(cuda_device):
    A = matrices.laplace_3d(16)
    kernels.reset_launch_counts()
    vals, V, hist = pf.eigsh_window(as_operator(A, device=cuda_device),
                                    (-7.0, -6.9), tol=1e-9,
                                    generator=torch.Generator().manual_seed(2))
    assert kernels.launch_counts()["cheby_banded"] > 0
    exact = np.sort(np.linalg.eigvalsh(A.toarray()))
    inside = exact[(exact >= -7.0) & (exact <= -6.9)]
    np.testing.assert_allclose(np.sort(vals), inside, rtol=0, atol=1e-9)


@pytest.mark.cuda
def test_the_filter_launches_only_the_fused_kernel_on_the_card(cuda_device):
    """No elementwise pass is left in a routed filter: the profiler sees
    the fused kernel alone, one a degree step (retried: the profiler on
    the card has recorded no device event in a profile before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    op = _card_op("laplace_3d(64)", torch.float64, cuda_device)
    X = _block(64, op.shape[0], seed=3, device=cuda_device)
    pf.cheby_filter(op, X, _coeffs(4), *BOUNDS)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            pf.cheby_filter(op, X, _coeffs(16), *BOUNDS)
            torch.cuda.synchronize()
        names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if names:
            break
    assert 0 < len(names) <= 16          # the profiler may miss events
    assert all("cheby_dia_cols_kernel" in name for name in names), names
