"""Solver phase stopwatch.

Counterpart of the phase clock in ``arnoldi_tpu/utils/profiling.py``, with
the same ``ARNOLDI_PHASES`` contract: when the variable is set, the solver
times its phases on the host clock and reports them on ``History.phases``.
A phase that ends without a device synchronisation measures the time to
enqueue its work, not to finish it.  Device tracing (``trace``/``annotate``)
is not ported yet.
"""

import contextlib
import os
import time


class WallClock:
    """Tiny phase stopwatch for host-side instrumentation.

    >>> clock = WallClock()
    >>> with clock("expand"): ...
    >>> clock.totals
    {'expand': 0.0123}
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def __call__(self, phase):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[phase] = self.totals.get(phase, 0.0) + dt
            self.counts[phase] = self.counts.get(phase, 0) + 1

    def report(self):
        return {
            phase: {"seconds": round(t, 6), "calls": self.counts[phase]}
            for phase, t in sorted(self.totals.items())
        }


class _NullClock:
    """No-op stand-in so hot paths can call ``with clock(...)``
    unconditionally."""

    @contextlib.contextmanager
    def __call__(self, phase):
        yield

    def report(self):
        return {}


NULL_CLOCK = _NullClock()


def phase_clock():
    """A :class:`WallClock` when ``ARNOLDI_PHASES`` is set, else the shared
    no-op."""
    return WallClock() if os.environ.get("ARNOLDI_PHASES") else NULL_CLOCK
