"""What the benchmark's own tests need for the cells added after they
were written, kept apart from them until their files take it in.

``tests/conftest.py`` cuts the benchmark to test size by name
(``TINY_CONFIGS``, ``TINY_TRAFFIC``) in the copy that ``make_tiny_root``
makes.  pytest loads this file first, for every test under this folder:
it adds the later names to those tables (:data:`TINY_CONFIGS`,
:data:`TINY_TRAFFIC`), and has the copy's stored spectrum of a cut
configuration written again for its cut matrix (by
``reference/spectrum.py``, with the wants and ``k`` of the stored one),
since a spectrum holds one matrix only.

``tests/test_portbench_control.py`` judges every cell with the grid
:class:`~portbench.reference.judge.Judge`, which knows the grid
Laplacians only; :func:`_cell_judge_in_the_control_tests` gives its
``_judge`` the judge the harness gives a cell
(:func:`~portbench.reference.judge.cell_judge`: the same grid judge for a
Laplacian, the stored spectrum's for any other matrix).
"""

import json

import pytest

from portbench.catalog import Catalog
from portbench.reference import spectrum as _spectrum
from portbench.reference.judge import cell_judge
from portbench.tests import conftest as _tests

#: Configurations cut to test size: ``mark(60)``, n = 1,830.  The mark
#: cell's limits are set from readings at m = 1000, where ``value_err``
#: reads at most 8.7e-11 against its 3e-9 limit; at m = 40 two starts of
#: twelve read up to 3.6e-9, at m = 60 at most 1.3e-9 (CPU, seeds 0-11).
TINY_CONFIGS = {"mark-1000": {"m": 60}}
#: Traffic at test size: the float32 window as ``window-60``'s tiny one.
TINY_TRAFFIC = {
    "window-60-f32": {"args": {"interval": [-11.0, -10.5]},
                      "want": {"want": "window", "interval": [-11.0, -10.5]}},
}

_tests.TINY_CONFIGS.update(TINY_CONFIGS)
_tests.TINY_TRAFFIC.update(TINY_TRAFFIC)
_make_tiny_root = _tests.make_tiny_root


def make_tiny_root(dest):
    """``tests/conftest.py``'s tiny copy, each cut configuration's stored
    spectrum written again for its cut matrix."""
    dest = _make_tiny_root(dest)
    for name in TINY_CONFIGS:
        path = dest / _tests.BENCH.name / "spectra" / f"{name}.json"
        wants = json.loads(path.read_text())["wants"]
        path.unlink()
        for stored in wants.values():
            assert _spectrum.main(["--config", name, "--want", stored["want"]["want"],
                                   "--k", str(stored["k"]), "--root", str(dest)]) == 0, name
    return dest


_tests.make_tiny_root = make_tiny_root


def _judge(root, cell):
    """``test_portbench_control._judge`` with the cell's own judge."""
    cat = Catalog(root)
    wl = cat.workload(cell)
    kind = cat.entry(cat.traffic(wl["traffic"])["entry"]).KIND
    return cell_judge(cat, wl), kind, wl["limits"]


@pytest.fixture(autouse=True)
def _cell_judge_in_the_control_tests(request, monkeypatch):
    if request.module.__name__.endswith(".test_portbench_control"):
        monkeypatch.setattr(request.module, "_judge", _judge)
