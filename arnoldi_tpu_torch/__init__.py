"""arnoldi_tpu_torch: the Krylov-Schur and thick-restart Lanczos
eigensolvers in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch/CUDA port of ``arnoldi_tpu`` (which stays the JAX reference).
It imports ``torch``, ``numpy`` and ``scipy``, never ``jax``.  Every tensor
lives on an explicit device: CUDA tensors go through the kernels in
``csrc/`` (built with ``nvcc`` at first use), CPU tensors through their
plain PyTorch versions.  Small SciPy/NumPy problems run on the host tier
(NumPy/BLAS or the C++ engine) and return their results on the device.
"""

from ._version import __version__
from . import parallel
from .linop import (BandedOperator, BsrOperator, CallableOperator,
                    DenseOperator, EllOperator, GramOperator, LinearOperator,
                    as_operator, pad_operator, rmatmat, rmatvec)
from .parallel import (banded_matvec_halo, bsr_matvec_halo, ell_matvec_halo,
                       halo_matvec_closure, make_mesh, replicated_sharding,
                       row_sharding, shard_operator, shard_workspace,
                       sharded_partial_schur, sparsity_bandwidth)
from .solvers.decomposition import RitzDecomposition, arnoldi_decomposition
from .solvers.explicit_restarts import (explicit_restarts_with_deflation,
                                        naive_explicit_restarts)
from .solvers.filtered import eigsh_filtered, eigsh_window
from .solvers.krylov_schur import eigenpairs_from_partial_schur, partial_schur
from .solvers.lanczos import partial_eigh
from .solvers.spectral_transform import (eigs, eigs_realified, eigsh,
                                         generalized_operator,
                                         realify_operator,
                                         shift_invert_operator)
from .solvers.svd import gram_companions, svds
from .utils.history import History

__all__ = [
    "BandedOperator",
    "BsrOperator",
    "CallableOperator",
    "DenseOperator",
    "EllOperator",
    "GramOperator",
    "History",
    "LinearOperator",
    "RitzDecomposition",
    "arnoldi_decomposition",
    "as_operator",
    "banded_matvec_halo",
    "bsr_matvec_halo",
    "eigenpairs_from_partial_schur",
    "eigs",
    "eigs_realified",
    "eigsh",
    "eigsh_filtered",
    "eigsh_window",
    "ell_matvec_halo",
    "explicit_restarts_with_deflation",
    "generalized_operator",
    "halo_matvec_closure",
    "make_mesh",
    "naive_explicit_restarts",
    "gram_companions",
    "pad_operator",
    "parallel",
    "partial_eigh",
    "partial_schur",
    "realify_operator",
    "replicated_sharding",
    "rmatmat",
    "rmatvec",
    "row_sharding",
    "shard_operator",
    "shard_workspace",
    "sharded_partial_schur",
    "shift_invert_operator",
    "sparsity_bandwidth",
    "svds",
    "__version__",
]
