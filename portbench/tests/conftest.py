"""The benchmark's own CPU tests: ``python -m pytest portbench/tests -q``.

They import neither JAX nor the JAX package.  A run is driven on the CPU
through ``harness.run(..., device="cpu", require_card=False)`` on a copy of
the benchmark whose configurations and traffic are cut to test size
(:func:`tiny_root`); what needs the card is marked ``cuda`` and decides in
the ``cuda_device`` fixture.
"""

import json
import shutil
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

#: Test sizes: the grids cut, the Krylov dimensions and the window with
#: them (laplace_3d(12) holds 12 eigenvalues in (-11.0, -10.5)).
TINY_CONFIGS = {"laplace2d-724": {"nx": 30}, "laplace3d-64": {"nx": 12}}
TINY_TRAFFIC = {
    "window-60": {"args": {"interval": [-11.0, -10.5]},
                  "want": {"want": "window", "interval": [-11.0, -10.5]}},
    "schur-lm-k5-m80": {"args": {"max_dim": 20}},
    "eigh-la-k5-m80": {"args": {"max_dim": 20}},
    "sinv-cg-k5-ncv40": {"args": {"ncv": 20}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one (the "
        "cuda_device fixture decides)")
    torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def make_tiny_root(dest):
    """A copy of the checkout's benchmark (``BENCHMARK.json`` and the
    folder) under ``dest``, cut to test size."""
    dest = Path(dest)
    shutil.copytree(BENCH, dest / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for name, args in TINY_CONFIGS.items():
        path = dest / BENCH.name / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["args"].update(args)
        path.write_text(json.dumps(cfg))
    for name, upd in TINY_TRAFFIC.items():
        path = dest / BENCH.name / "traffic" / f"{name}.json"
        tr = json.loads(path.read_text())
        tr["args"].update(upd["args"])
        if "want" in upd:
            tr["want"] = upd["want"]
        path.write_text(json.dumps(tr))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
