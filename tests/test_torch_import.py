"""``arnoldi_tpu_torch`` imports and solves (scalar, and block over BSR-8)
where JAX cannot be imported, and a CPU solve never builds or loads the
CUDA kernel library."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_SCRIPT = """
import json, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import arnoldi_tpu_torch
from arnoldi_tpu_torch import partial_schur
from arnoldi_tpu_torch._host import matrices
from arnoldi_tpu_torch.ops import kernels
from arnoldi_tpu_torch.ops.kernels import _build
A = matrices.mark(12)
Q, T, hist = partial_schur(A, 3, sort_function="LR", device="cpu")
res = np.linalg.norm(A @ Q.numpy() - Q.numpy() @ T.numpy(), axis=0).max()
op = arnoldi_tpu_torch.as_operator(A, format="bsr", device="cpu")
Q, T, hist = partial_schur(op, 3, sort_function="LR", block_size=2)
res = max(res, np.linalg.norm(A @ Q.numpy() - Q.numpy() @ T.numpy(), axis=0).max())
print(json.dumps({
    "residual": float(res),
    "jax_modules": sorted(m for m, mod in sys.modules.items()
                          if mod is not None and (
                              m == "jax" or m.startswith(("jax.", "jaxlib")))),
    "reference_package_imported": "arnoldi_tpu" in sys.modules,
    "kernel_library_loaded": _build.is_loaded(),
    "launches": kernels.launch_counts(),
}))
"""


def test_imports_and_solves_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["residual"] < 1e-6
    assert out["jax_modules"] == []
    assert not out["reference_package_imported"]
    assert not out["kernel_library_loaded"]
    assert set(out["launches"].values()) == {0}
