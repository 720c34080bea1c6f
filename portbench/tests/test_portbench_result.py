"""The result line and the standard error of a run, driven on the CPU;
the command's refusal without a card."""

import io
import json
import subprocess
import sys

import pytest

from portbench.catalog import Catalog
from portbench.harness import run

from .conftest import MARK_CELL, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def _run(root, cell, trace, seed=2**33 + 1):
    out, err = io.StringIO(), io.StringIO()
    rc = run(cell, seed, 0.01, trace, root=root, device="cpu",
             require_card=False, out=out, err=err)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_untraced_line(tiny_root, cell):
    rc, line, err = _run(tiny_root, cell, False)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert DEVICE_KEYS <= set(line["device"])
    want = [m["name"] for m in Catalog(ROOT).cell_metrics(cell, "end_to_end")]
    assert list(line["metrics"]) == want
    for m in SPEC["end_to_end"]:
        if cell in m.get("workloads", [cell]):
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for text, (name, c) in zip(tail, line["checks"].items()):
        assert text == f"check {name} {c['value']!r} limit {c['limit']!r}"


def test_traced_line(tiny_root):
    cell = "l2d724-schur-lm"
    rc, line, _ = _run(tiny_root, cell, True)
    assert rc == 0 and line["correct"] is True
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    allowed = {m["name"] for m in Catalog(ROOT).cell_metrics(cell, "per_layer")}
    assert set(line["metrics"]) <= allowed
    # counters and host spans read on any device; device shares need the card
    assert {"solver.matvecs_per_solve", "host_dense.schur_ms_per_restart"} <= set(line["metrics"])
    assert list(line)[-1] == "checks"


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "l2d724-eigh-la", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "no CUDA device" in p.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(cuda_device):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "l2d724-eigh-la", "--seed", "5", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.mark.cuda
def test_the_tiny_mark_cell_on_the_card(cuda_device, mark_root):
    out = io.StringIO()
    assert run(MARK_CELL, 2**33 + 5, 0.01, False, root=mark_root, out=out,
               err=io.StringIO()) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
