"""The benchmark and comparison harness on the port.

Counterpart of ``arnoldi_tpu/harness/``: the suite library, and the CLIs
``bench_partial_schur``, ``compare_arpack``, ``stress_test``,
``scaling_bench``, ``plot_stress`` and ``compare_slepc``, each run as
``python -m arnoldi_tpu_torch.harness.<name> ... [--device cuda|cpu]``
(default ``cuda``: the card; ``cpu``: the kernels' plain versions).
"""

from .suite import (
    EigensolverParameters,
    Statistics,
    arnoldi_tpu_eig,
    arpack_eig,
    find_best_matching,
    matrix_from_spec,
    print_residuals,
)

__all__ = [
    "EigensolverParameters",
    "Statistics",
    "arpack_eig",
    "arnoldi_tpu_eig",
    "find_best_matching",
    "matrix_from_spec",
    "print_residuals",
]
