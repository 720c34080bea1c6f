"""Every example of the port (``examples/torch/*.py``) runs on the CPU
(``--device cpu``) at its small size, asserts its own result and exits 0,
one of each JAX example (``examples/*.py``)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch"
#: Extra arguments of an example's small size on the CPU.
SMALL = {"interior_filtered.py": ["--grid", "12"]}
#: The JAX example each port example stands for.
COUNTERPART = {"high_precision.py": "high_precision_tpu.py"}


def test_one_example_each():
    ported = sorted(p.name for p in EXAMPLES.glob("*.py"))
    jax = sorted(COUNTERPART.get(p, p) for p in ported)
    assert jax == sorted(p.name for p in (REPO / "examples").glob("*.py"))


@pytest.mark.parametrize("name", sorted(p.name for p in EXAMPLES.glob("*.py")))
def test_example_runs_on_the_cpu(name):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, str(EXAMPLES / name), "--device",
                           "cpu", *SMALL.get(name, [])], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "OK" in proc.stdout
