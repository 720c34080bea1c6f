"""The import rule: no module named ``jax``, ``jaxlib``, ``flax`` or
``arnoldi_tpu`` (whole top-level names) in a run, and nothing of the
program in the reference."""

import json
import subprocess
import sys

from portbench.harness import banned_modules

from .conftest import ROOT


def test_whole_top_level_names():
    assert banned_modules({"arnoldi_tpu_torch": 1, "arnoldi_tpu_torch.linop": 1,
                           "jaxtyping": 1, "numpy": 1}) == []
    assert banned_modules({"arnoldi_tpu.ops.ortho": 1, "jax._src.api": 1,
                           "flax": 1}) == ["arnoldi_tpu", "flax", "jax"]


def _modules_after(code):
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys, torch; torch.set_num_threads(2)\n"
            "sys.path.insert(0, 'portbench/tests')\n"
            "from conftest import make_tiny_root\n"
            "from portbench.harness import run\n"
            f"root = make_tiny_root({str(tmp_path)!r})\n"
            "for cell in ('l2d724-schur-lm', 'l3d64-window'):\n"
            "    assert run(cell, 3, 0.01, True, root=root, device='cpu',\n"
            "               require_card=False) == 0\n")
    loaded = _modules_after(code)
    assert "arnoldi_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "arnoldi_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _modules_after("import portbench.reference.judge, "
                            "portbench.reference.control, portbench.reference.stencil, "
                            "portbench.reference.sparse, portbench.reference.spectrum")
    assert not loaded & {"arnoldi_tpu_torch", "arnoldi_tpu", "jax", "torch"}
