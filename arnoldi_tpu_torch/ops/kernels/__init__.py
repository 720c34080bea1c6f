"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors, and counts its launches in a ``launches``
attribute (and by operand dtype in ``dtype_launches``).  :data:`KERNELS`
lists them with the TPU kernel each replaces;
a ``*_cols`` entry is the b-column form (b columns as the rows of a
``(b, n)`` array, each stored matrix value read once for all b) that the
block driver uses.  ``cg_banded`` replaces no Pallas kernel: it is the
whole CG solve of a shifted DIA operator in one launch, where the JAX
package runs ``jax.scipy.sparse.linalg.cg``.  Nor does ``cheby_banded``:
the Chebyshev filter's degree step over a DIA operator in one launch (the
b-column kernel with the recurrence as its epilogue), a fusion the JAX
package gets from XLA.
"""

from . import cg_banded, cheby_banded, ortho_fused, spmv_banded, spmv_bsr, spmv_ell
from ._build import build

_DIA = ("arnoldi_tpu_torch/csrc/spmv_banded.cu",
        "arnoldi_tpu/ops/pallas/spmv_banded.py:82")
_ELL = ("arnoldi_tpu_torch/csrc/spmv_ell.cu",
        "arnoldi_tpu/ops/pallas/spmv_ell.py:67")
_BSR = ("arnoldi_tpu_torch/csrc/spmv_bsr.cu",
        "arnoldi_tpu/ops/pallas/spmv_bsr.py:92")
_BSR_WINDOW = ("arnoldi_tpu_torch/csrc/spmv_bsr.cu",
               "arnoldi_tpu/ops/pallas/spmv_bsr.py:269")

#: name -> (wrapper, CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "spmv_dia": (spmv_banded.banded_matvec, *_DIA),
    "spmv_dia_cols": (spmv_banded.banded_matmat, *_DIA),
    # the shard form: a row range of a row block against an x window (the
    # ring-halo and all-gather SpMV under a device mesh)
    "spmv_dia_ext": (spmv_banded.banded_matvec_ext, *_DIA),
    "spmv_dia_ext_cols": (spmv_banded.banded_matmat_ext, *_DIA),
    "spmv_ell": (spmv_ell.ell_matvec, *_ELL),
    "spmv_ell_cols": (spmv_ell.ell_matmat, *_ELL),
    "spmv_bsr": (spmv_bsr.bsr_matvec, *_BSR),
    "spmv_bsr_cols": (spmv_bsr.bsr_matmat, *_BSR),
    "spmv_bsr_window": (spmv_bsr.bsr_window_matvec, *_BSR_WINDOW),
    "spmv_bsr_window_cols": (spmv_bsr.bsr_window_matmat, *_BSR_WINDOW),
    "masked_project": (ortho_fused.masked_project,
                       "arnoldi_tpu_torch/csrc/ortho_fused.cu",
                       "arnoldi_tpu/ops/pallas/ortho_fused.py:106"),
    "project_update_norm": (ortho_fused.project_update_norm,
                            "arnoldi_tpu_torch/csrc/ortho_fused.cu",
                            "arnoldi_tpu/ops/pallas/ortho_fused.py:161"),
    "cg_banded": (cg_banded.cg_banded, "arnoldi_tpu_torch/csrc/cg_banded.cu",
                  "none (jax.scipy.sparse.linalg.cg)"),
    "cheby_banded": (cheby_banded.cheby_banded, _DIA[0],
                     "none (XLA fuses the recurrence: "
                     "arnoldi_tpu/solvers/filtered.py:181)"),
}


def reset_launch_counts():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
        wrapper.dtype_launches = {}
    spmv_bsr.bsr_matmat.gather8_launches = 0
    spmv_bsr.bsr_window_matmat.walk_launches = 0


def launch_counts():
    """Launches of each kernel since the last reset, all dtypes together."""
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}


def dtype_launch_counts():
    """Launches of each kernel since the last reset by operand dtype:
    ``{name: {"float64": n, "complex128": n, ...}}``."""
    return {name: dict(wrapper.dtype_launches)
            for name, (wrapper, _, _) in KERNELS.items()}


__all__ = ["KERNELS", "build", "dtype_launch_counts", "launch_counts",
           "reset_launch_counts"]
