"""Hand-written CUDA kernels of the port, with their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors, and counts its launches in a ``launches``
attribute.  :data:`KERNELS` lists them with the TPU kernel each replaces.
"""

from . import ortho_fused, spmv_banded, spmv_ell
from ._build import build

#: name -> (wrapper, CUDA source, the Pallas kernel it replaces)
KERNELS = {
    "spmv_dia": (spmv_banded.banded_matvec,
                 "arnoldi_tpu_torch/csrc/spmv_banded.cu",
                 "arnoldi_tpu/ops/pallas/spmv_banded.py:82"),
    "spmv_ell": (spmv_ell.ell_matvec,
                 "arnoldi_tpu_torch/csrc/spmv_ell.cu",
                 "arnoldi_tpu/ops/pallas/spmv_ell.py:67"),
    "masked_project": (ortho_fused.masked_project,
                       "arnoldi_tpu_torch/csrc/ortho_fused.cu",
                       "arnoldi_tpu/ops/pallas/ortho_fused.py:106"),
    "project_update_norm": (ortho_fused.project_update_norm,
                            "arnoldi_tpu_torch/csrc/ortho_fused.cu",
                            "arnoldi_tpu/ops/pallas/ortho_fused.py:161"),
}


def reset_launch_counts():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def launch_counts():
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}


__all__ = ["KERNELS", "build", "launch_counts", "reset_launch_counts"]
