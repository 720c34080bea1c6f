"""arnoldi_tpu_torch: the Krylov-Schur eigensolver in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch/CUDA port of ``arnoldi_tpu`` (which stays the JAX reference).
It imports ``torch``, ``numpy`` and ``scipy``, never ``jax``.  Every tensor
lives on an explicit device: CUDA tensors go through the kernels in
``csrc/`` (built with ``nvcc`` at first use), CPU tensors through their
plain PyTorch versions.
"""

from .linop import (BandedOperator, BsrOperator, DenseOperator, EllOperator,
                    as_operator)
from .solvers.krylov_schur import eigenpairs_from_partial_schur, partial_schur

__all__ = [
    "BandedOperator",
    "BsrOperator",
    "DenseOperator",
    "EllOperator",
    "as_operator",
    "eigenpairs_from_partial_schur",
    "partial_schur",
]
