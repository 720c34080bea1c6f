"""arnoldi_tpu_torch: the Krylov-Schur and thick-restart Lanczos
eigensolvers in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch/CUDA port of ``arnoldi_tpu`` (which stays the JAX reference).
It imports ``torch``, ``numpy`` and ``scipy``, never ``jax``.  Every tensor
lives on an explicit device: CUDA tensors go through the kernels in
``csrc/`` (built with ``nvcc`` at first use), CPU tensors through their
plain PyTorch versions.  Small SciPy/NumPy problems run on the host tier
(NumPy/BLAS or the C++ engine) and return their results on the device.
"""

from .linop import (BandedOperator, BsrOperator, CallableOperator,
                    DenseOperator, EllOperator, GramOperator, LinearOperator,
                    as_operator, pad_operator, rmatmat, rmatvec)
from .solvers.decomposition import RitzDecomposition, arnoldi_decomposition
from .solvers.krylov_schur import eigenpairs_from_partial_schur, partial_schur
from .solvers.lanczos import partial_eigh
from .solvers.svd import gram_companions, svds

__all__ = [
    "BandedOperator",
    "BsrOperator",
    "CallableOperator",
    "DenseOperator",
    "EllOperator",
    "GramOperator",
    "LinearOperator",
    "RitzDecomposition",
    "arnoldi_decomposition",
    "as_operator",
    "eigenpairs_from_partial_schur",
    "gram_companions",
    "pad_operator",
    "partial_eigh",
    "partial_schur",
    "rmatmat",
    "rmatvec",
    "svds",
]
