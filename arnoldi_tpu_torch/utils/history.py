"""Per-eigenvalue convergence history.

The port's copy of ``arnoldi_tpu/utils/history.py``, unchanged but for this
paragraph.

Record parity with the reference's ``History`` dataclass
(``src/arnoldi/explicit_restarts.py:13-28``): per-eigenvalue matvec and
restart counts plus a total.  Extended with an optional per-restart residual
trace (the reference README flags convergence tracking as the unstable part
of its API; here it is a first-class output).
"""

import dataclasses

import numpy as np


@dataclasses.dataclass
class History:
    matvecs: np.ndarray
    restarts: np.ndarray
    #: optional per-restart max relative residual over the wanted window
    residual_trace: list = dataclasses.field(default_factory=list)
    #: solver-wide matvec count, set by drivers whose per-eigenvalue entries
    #: are cumulative snapshots (Krylov-Schur) rather than disjoint budgets
    #: (deflated explicit restarts); when unset, the disjoint sum is used.
    total: int | None = None
    #: host wall-clock per solver phase ({phase: {seconds, calls}}), filled
    #: when the ``ARNOLDI_PHASES`` environment variable is set (see
    #: ``utils.profiling.phase_clock``); empty otherwise.
    phases: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_k(cls, k):
        return cls(np.zeros(k, np.int32), np.zeros(k, np.int32))

    @property
    def k(self):
        return self.matvecs.shape[0]

    @property
    def total_matvecs(self):
        if self.total is not None:
            return int(self.total)
        return int(self.matvecs.sum())
