"""Sharded execution over a row mesh of ``torch.distributed`` ranks.

Counterpart of ``arnoldi_tpu/parallel/`` (its double-word halo products
are not ported): the mesh and its collectives, the sharded operators (the
all-gather of ``x``, and the ring halo for banded, ELL and BSR
operators), the multi-process helpers and ``sharded_partial_schur``.  The
drivers take the mesh as ``mesh=``: ``partial_schur``, ``partial_eigh``
and the filtered drivers (``solvers/filtered.py``).
"""

from .halo_spmv import (HaloOperator, banded_matvec_halo, bsr_matvec_halo,
                        ell_matvec_halo, halo_matvec_closure,
                        sparsity_bandwidth)
from .mesh import (Mesh, gather_rows, local_rows, make_mesh,
                   replicated_sharding, row_sharding)
from .sharded import (ShardedOperator, shard_operator, shard_workspace,
                      sharded_partial_schur)

__all__ = [
    "HaloOperator",
    "Mesh",
    "ShardedOperator",
    "banded_matvec_halo",
    "bsr_matvec_halo",
    "ell_matvec_halo",
    "gather_rows",
    "halo_matvec_closure",
    "local_rows",
    "make_mesh",
    "replicated_sharding",
    "row_sharding",
    "shard_operator",
    "shard_workspace",
    "sharded_partial_schur",
    "sparsity_bandwidth",
]
