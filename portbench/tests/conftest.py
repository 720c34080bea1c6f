"""The benchmark's own CPU tests: ``python -m pytest portbench/tests -q``.

They import neither JAX nor the JAX package.  A run is driven on the CPU
through ``harness.run(..., device="cpu", require_card=False)`` on a copy of
the benchmark whose configurations and traffic are cut to test size
(:func:`tiny_root`); what needs the card is marked ``cuda`` and decides in
the ``cuda_device`` fixture.
"""

import json
import shutil
import subprocess
import sys
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


#: A configuration that brings its own generator and spectrum, as a new
#: deployment does: ``mark(40)`` (n = 820) as ELL, ``partial_schur`` LR nev 5.
#: Its limits lie 60 % of the way up, in log scale, from the program's
#: largest reading on the CPU (14 seeds: value_err 4.20e-9, residual
#: 9.29e-9, orth 1.58e-14) to the float32 control's (2.16e-8, 3.32e-8,
#: 1.31e-8).
MARK = {
    "configs/mark-40.json": {
        "name": "mark-40", "source": "Saad NMLEP 2nd ed. 2.5.1, Matrix Market NEP MARKOV",
        "generator": "mark", "args": {"m": 40}, "format": "ell", "dtype": "float64",
        "reduced": ["m"]},
    "traffic/schur-lr-k5-m40.json": {
        "entry": "partial_schur",
        "args": {"nev": 5, "sort_function": "LR", "max_dim": 40,
                 "stopping_criterion": 1e-08, "ortho": "cgs2", "max_restarts": 1000},
        "warmup": {"stopping_criterion": 0.01},
        "want": {"want": "LR", "k": 5}},
    "workloads/mark40-schur-lr.json": {
        "config": "mark-40", "traffic": "schur-lr-k5-m40", "chips": 1,
        "why": "mark(40) ELL, partial_schur LR k 5 m 40: a non-symmetric solve",
        "limits": {"value_err": 1e-08, "residual": 2e-08, "orth": 6e-11, "missing": 0}},
}
MARK_CELL = "mark40-schur-lr"


def make_mark_root(dest):
    """:func:`make_tiny_root` with the files of :data:`MARK` added and the
    configuration's spectrum written by ``reference/spectrum.py``."""
    dest = make_tiny_root(dest)
    for name, data in MARK.items():
        (dest / BENCH.name / name).write_text(json.dumps(data))
    p = subprocess.run([sys.executable, str(BENCH / "reference" / "spectrum.py"),
                        "--config", "mark-40", "--want", "LR", "--k", "15",
                        "--root", str(dest)], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return dest


@pytest.fixture(scope="session")
def mark_root(tmp_path_factory):
    return make_mark_root(tmp_path_factory.mktemp("mark"))
