"""Where the filter's start block is drawn (``solvers/filtered.py``
``_start_block``, ``_card_rows``) and the reader of its span,
``filter.device_draw_pct``.

On the CPU: a CPU block keeps the host draw bit for bit (the CholQR2 of
``torch.randn`` from the generator, which ends in the same state); the
card route, decided as for a block on the card so that it runs on CPU
tensors, takes one int64 draw of the generator, keeps the ``X0`` rows
first, counts its rows in ``filter.device_draw`` and tiles one whole
block across a mesh's ranks; the reader reads 100, 0 and nothing.
On the card (marked ``cuda``; each skips without one, the ``cuda_device``
fixture decides): the same contract on card tensors, the global CUDA
generator untouched, and a window solve's exact values.  No JAX here, so
the file also runs on a machine with a card and no JAX:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_start_block.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from arnoldi_tpu_torch import matrices
from arnoldi_tpu_torch.linop import as_operator
from arnoldi_tpu_torch.ops.ortho import block_cgs2
from arnoldi_tpu_torch.parallel import make_mesh
from arnoldi_tpu_torch.parallel.mesh import Mesh
from arnoldi_tpu_torch.solvers import filtered as pf
from arnoldi_tpu_torch.utils import profiling
from torch_parity import cuda_device  # noqa: F401 (fixture)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 12345
WINDOW = (-7.0, -6.9)        # laplace_3d(10)'s and (16)'s window in the tests


def _generator(seed=SEED):
    return torch.Generator().manual_seed(seed)


def _x0(k0, n, dtype=torch.float64, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((k0, n))).to(dtype)


def _host_block(s, n, X0, dtype, generator):
    """The start block as the host draw makes it: the ``X0`` rows, then
    ``torch.randn`` rows from ``generator``, through CholQR2."""
    k0 = 0 if X0 is None else min(X0.shape[0], s)
    X = torch.empty((s, n), dtype=dtype)
    if k0:
        X[:k0] = X0[:k0].to(dtype)
    if k0 < s:
        X[k0:] = torch.randn((s - k0, n), generator=generator, dtype=dtype)
    return block_cgs2(X, X, 0)[1]


def _one_seed_drawn(generator):
    """``generator`` advanced by the card route's one int64 draw."""
    g = torch.Generator()
    g.set_state(generator.get_state())
    torch.randint(0, 2**62, (), generator=g)
    return g


@pytest.fixture
def phases_on(monkeypatch):
    monkeypatch.setenv("ARNOLDI_PHASES", "1")
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def draw_on_cpu(monkeypatch):
    """``_start_block`` decides its route as for a block on the card, so
    the card route runs on CPU tensors (its device generator a CPU one)."""
    monkeypatch.setattr(pf, "_draws_on_card", lambda X: True)


@pytest.fixture
def spy(monkeypatch):
    """Record the block ``_start_block`` hands to CholQR2."""
    seen = []
    orthonormalize = pf.block_cgs2

    def wrapped(Vt, W, *args, **kwargs):
        seen.append(W.clone())
        return orthonormalize(Vt, W, *args, **kwargs)

    monkeypatch.setattr(pf, "block_cgs2", wrapped)
    return seen


# -- the host draw: a CPU block keeps its bits --------------------------------

@pytest.mark.parametrize("k0", [0, 5, 24])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh", [None, "one-rank"])
def test_a_cpu_block_keeps_the_host_draw_bit_for_bit(k0, dtype, mesh, phases_on):
    s, n = 24, 300
    X0 = _x0(k0, n) if k0 else None
    g, g_want = _generator(), _generator()
    got = pf._start_block(s, n, X0, dtype, "cpu", g,
                          make_mesh(device="cpu") if mesh else None,
                          profiling.WallClock())
    assert torch.equal(got, _host_block(s, n, X0, dtype, g_want))
    assert torch.equal(g.get_state(), g_want.get_state())
    assert not any(sp.name == "filter.device_draw" for sp in profiling.spans())


# -- the card route, run on CPU tensors ---------------------------------------

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_card_route_takes_one_seed_and_repeats_from_it(draw_on_cpu, dtype):
    s, n = 16, 257
    g1, g2 = _generator(), _generator()
    Q1 = pf._start_block(s, n, None, dtype, "cpu", g1)
    Q2 = pf._start_block(s, n, None, dtype, "cpu", g2)
    assert torch.equal(Q1, Q2) and Q1.dtype == dtype
    want = _one_seed_drawn(_generator())
    assert torch.equal(g1.get_state(), want.get_state())
    # the rows of a generator seeded by that one draw, through CholQR2
    seed = int(torch.randint(0, 2**62, (), generator=_generator()))
    X = torch.empty((s, n), dtype=dtype).normal_(generator=_generator(seed))
    assert torch.equal(Q1, block_cgs2(X, X, 0)[1])


def test_the_card_route_keeps_x0_first_and_counts_its_rows(draw_on_cpu, spy,
                                                           phases_on):
    s, n, k0 = 20, 400, 7
    X0 = _x0(k0, n)
    g = _generator()
    Q = pf._start_block(s, n, X0, torch.float64, "cpu", g,
                        clock=profiling.WallClock())
    (X,) = spy
    assert torch.equal(X[:k0], X0)
    rows = X[k0:]
    assert abs(float(rows.mean())) < 0.02 and abs(float(rows.std()) - 1) < 0.02
    eye = torch.eye(s, dtype=torch.float64)
    assert float((Q @ Q.T - eye).abs().max()) < 1e-13
    (draw,) = [sp for sp in profiling.spans() if sp.name == "filter.device_draw"]
    assert draw.count == s - k0


def test_a_block_carried_whole_draws_nothing(draw_on_cpu, phases_on):
    s, n = 8, 100
    X0 = _x0(12, n)
    g = _generator()
    state = g.get_state()
    pf._start_block(s, n, X0, torch.float64, "cpu", g, clock=profiling.WallClock())
    assert torch.equal(g.get_state(), state)
    assert [sp.count for sp in profiling.spans()
            if sp.name == "filter.device_draw"] == [0]


def test_a_one_rank_mesh_repeats_the_unsharded_card_draw(draw_on_cpu):
    s, n = 16, 300
    X0 = _x0(3, n)
    want = pf._start_block(s, n, X0, torch.float64, "cpu", _generator())
    got = pf._start_block(s, n, X0, torch.float64, "cpu", _generator(),
                          make_mesh(device="cpu"))
    assert torch.equal(got, want)


@pytest.mark.parametrize("size", [2, 4])
def test_the_ranks_columns_tile_one_whole_block(size, monkeypatch):
    """Every rank draws the whole rows from the one seed, in chunks of at
    most ceil((s - k0) / size) rows, and keeps its columns."""
    s, k0, n = 19, 4, 96
    widest = []
    empty = torch.empty

    def counted(shape, **kwargs):
        widest.append(shape[0])
        return empty(shape, **kwargs)

    monkeypatch.setattr(pf.torch, "empty", counted)
    parts = []
    for rank in range(size):
        X = torch.zeros((s, n // size), dtype=torch.float64)
        pf._card_rows(X, k0, n, _generator(), Mesh(None, rank, size,
                                                     torch.device("cpu")))
        parts.append(X)
    assert max(widest) == -(-(s - k0) // size)
    whole = torch.cat(parts, dim=1)
    assert not whole[:k0].any() and whole[k0:].all()
    # the chunks, drawn whole with every column kept
    step = -(-(s - k0) // size)
    g = _generator(int(torch.randint(0, 2**62, (), generator=_generator())))
    want = torch.cat([empty((min(step, s - r), n), dtype=torch.float64).normal_(generator=g)
                      for r in range(k0, s, step)])
    assert torch.equal(whole[k0:], want)


# -- the reader, filter.device_draw_pct ---------------------------------------

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

    return Catalog(REPO).metric("filter.device_draw_pct")


def _window_run():
    A = matrices.laplace_3d(10)
    pf.eigsh_window(as_operator(A, device="cpu"), WINDOW, tol=1e-9,
                    generator=torch.Generator().manual_seed(2))
    spans = list(profiling.spans())
    (solve,) = [s for s in spans if s.name == "solve"]
    return spans, _Run(_Timeline([(solve.start_ns, solve.end_ns)]))


def test_the_reader_reads_100_when_every_block_drew_on_the_card(phases_on,
                                                               draw_on_cpu):
    spans, run = _window_run()
    draws = [s for s in spans if s.name == "filter.device_draw"]
    blocks = [s for s in spans if s.name == "filter.start_block"]
    assert len(draws) == len(blocks) > 0
    assert all(spans[s.parent].name == "filter.start_block" for s in draws)
    assert all(0 < d.count <= spans[d.parent].count for d in draws)
    assert _reader().read(run) == 100.0


def test_the_reader_reads_zero_when_the_host_drew(phases_on):
    spans, run = _window_run()
    assert not any(s.name == "filter.device_draw" for s in spans)
    assert _reader().read(run) == 0.0


def test_the_reader_reads_nothing_without_the_route_or_a_timeline(phases_on,
                                                                   draw_on_cpu,
                                                                   monkeypatch):
    _, run = _window_run()
    reader = _reader()
    assert reader.read(_Run(None)) is None
    monkeypatch.setattr(reader, "_ROUTE", ("arnoldi_tpu_torch.solvers.filtered",
                                           "_no_card_rows"))
    assert reader.read(run) is None


def test_the_reader_reads_nothing_when_no_block_drew_rows(monkeypatch):
    """Synthetic spans: two start blocks that carried all their rows in."""
    S = profiling.Span
    spans = [S("solve", 0, 100, None, 0, 10),
             S("filter.start_block", 10, 20, 0, 0, 8),
             S("filter.device_draw", 11, 12, 1, 0, 0),
             S("filter.start_block", 30, 40, 0, 0, 8),
             S("filter.device_draw", 31, 32, 3, 0, 0)]
    monkeypatch.setattr(profiling, "spans", lambda: tuple(spans))
    reader = _reader()
    run = _Run(_Timeline([(0, 100)]))
    assert reader.read(run) is None
    # one of them drew 5 rows on the card, the other drew on the host
    spans[2] = S("filter.device_draw", 11, 12, 1, 0, 5)
    del spans[4]
    assert reader.read(run) == 50.0


# -- on the card ---------------------------------------------------------------

CARD_N = 262_144            # laplace_3d(64)'s rows
#: Q Q^T - I at the dtype's limit for s = 64 rows of CARD_N
ORTH = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_card_draws_one_seed_and_repeats_from_it(dtype, cuda_device):
    s = 64
    state = torch.cuda.get_rng_state()
    g1, g2 = _generator(), _generator()
    Q1 = pf._start_block(s, CARD_N, None, dtype, cuda_device, g1)
    Q2 = pf._start_block(s, CARD_N, None, dtype, cuda_device, g2)
    assert Q1.is_cuda and Q1.dtype == dtype
    assert torch.equal(Q1, Q2)
    assert torch.equal(g1.get_state(), _one_seed_drawn(_generator()).get_state())
    assert torch.equal(torch.cuda.get_rng_state(), state)
    eye = torch.eye(s, dtype=dtype, device=cuda_device)
    assert float((Q1 @ Q1.T - eye).abs().max()) < ORTH[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_card_keeps_x0_first_and_counts_its_rows(dtype, cuda_device, spy,
                                                     phases_on):
    s, k0 = 64, 9
    X0 = _x0(k0, CARD_N, dtype)
    Q = pf._start_block(s, CARD_N, X0, dtype, cuda_device, _generator(),
                        clock=profiling.WallClock())
    (X,) = spy
    assert torch.equal(X[:k0].cpu(), X0)
    rows = X[k0:].double()
    assert abs(float(rows.mean())) < 1e-3 and abs(float(rows.std()) - 1) < 1e-3
    eye = torch.eye(s, dtype=dtype, device=cuda_device)
    assert float((Q @ Q.T - eye).abs().max()) < ORTH[dtype]
    (draw,) = [sp for sp in profiling.spans() if sp.name == "filter.device_draw"]
    assert draw.count == s - k0


@pytest.mark.cuda
def test_a_one_rank_mesh_repeats_the_unsharded_draw_on_the_card(cuda_device):
    s = 48
    X0 = _x0(5, CARD_N)
    want = pf._start_block(s, CARD_N, X0, torch.float64, cuda_device, _generator())
    got = pf._start_block(s, CARD_N, X0, torch.float64, cuda_device, _generator(),
                          make_mesh(device=cuda_device))
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_eigsh_window_on_the_card_draws_its_blocks_there(cuda_device, phases_on):
    A = matrices.laplace_3d(16)
    state = torch.cuda.get_rng_state()
    vals, V, hist = pf.eigsh_window(as_operator(A, device=cuda_device), WINDOW,
                                    tol=1e-9, generator=_generator(2))
    assert torch.equal(torch.cuda.get_rng_state(), state)
    exact = np.sort(np.linalg.eigvalsh(A.toarray()))
    inside = exact[(exact >= WINDOW[0]) & (exact <= WINDOW[1])]
    np.testing.assert_allclose(np.sort(vals), inside, rtol=0, atol=1e-9)
    spans = list(profiling.spans())
    draws = [s for s in spans if s.name == "filter.device_draw"]
    assert len(draws) == len(hist.slices) > 0
    assert all(0 < d.count <= spans[d.parent].count for d in draws)
