"""Solver phase clock and span recorder.

Counterpart of the phase clock in ``arnoldi_tpu/utils/profiling.py``, with
the same ``ARNOLDI_PHASES`` contract: when the variable is set, the solver
times its phases on the host clock and reports them on ``History.phases``
(``{phase: {seconds, calls}}``).  A phase that ends without a device
synchronisation measures the time to enqueue its work, not to finish it.

Each phase is also one span of the process-wide log :data:`LOG`, read with
:func:`spans`: its name, its start and end in Unix-epoch nanoseconds
(``time.time_ns()``, the clock of ``torch.profiler``'s kineto events, so a
reader can lay each device operation of a profiled solve inside or outside
it), the index of the span open around it on its thread, the id of the
public call it belongs to, and the work it did where it counts any.  A
public driver's call is one ``solve`` span (:func:`solve_span`); a driver
called inside another joins the outer call.  The log keeps the first
:data:`CAPACITY` spans to close and counts the rest as dropped.

The spans are not ``torch.profiler.record_function`` ranges: those get a
device-side copy, which a trace reader would count as device work.

With the variable unset, :func:`phase_clock` returns the shared no-op
clock, whose every phase is one shared null context, and nothing is
recorded.
"""

import functools
import itertools
import os
import threading
import time
from typing import NamedTuple, Optional

#: The spans the log keeps; later ones are counted in ``LOG.dropped``.
CAPACITY = 1 << 19


def enabled():
    """True when ``ARNOLDI_PHASES`` is set."""
    return bool(os.environ.get("ARNOLDI_PHASES"))


class Span(NamedTuple):
    """One closed span of the log."""

    name: str
    start_ns: int
    end_ns: int
    #: index in :func:`spans` of the span open around it on its thread
    parent: Optional[int]
    #: id shared by every span of one public call (None outside one)
    solve: Optional[int]
    #: the work it did (matvecs, steps, ...), where it counts any
    count: Optional[int]


class _Thread(threading.local):
    """One thread's open spans (their slots, innermost last) and solve."""

    def __init__(self):
        self.stack, self.solve, self.matvecs = [], None, 0


class SpanLog:
    """A bounded, thread-safe log of spans.  A span takes an id when it
    opens, which its children keep as their parent, and is written when it
    closes, as a plain tuple (the garbage collector stops tracking those,
    so a long log does not slow its collections); :meth:`snapshot` puts
    the spans in the order they opened.  Spans that close once the log
    holds ``capacity`` are counted in ``dropped``."""

    def __init__(self, capacity=CAPACITY):
        self.capacity = capacity
        self.dropped = 0
        self._records = []
        self._ids = itertools.count()
        self._floor = 0             # clear(): spans with a lower id are void
        self._solves = itertools.count()
        self._lock = threading.Lock()
        self._local = _Thread()

    def open(self):
        """The slot of a span opening now on this thread."""
        local = self._local
        stack = local.stack
        slot = (next(self._ids), stack[-1][0] if stack else None, local.solve)
        stack.append(slot)
        return slot

    def close(self, slot, name, start_ns, end_ns, count=None):
        """Write the span of ``slot``, the innermost open one."""
        self._local.stack.pop()
        ident, parent, solve = slot
        if ident < self._floor:
            return
        records = self._records
        if len(records) < self.capacity:
            records.append((ident, name, start_ns, end_ns, parent, solve, count))
        else:
            with self._lock:
                self.dropped += 1

    def begin_solve(self):
        """Open a solve id on this thread for a public call; False when one
        is open already (the call joins it)."""
        local = self._local
        if local.solve is not None:
            return False
        local.solve = next(self._solves)
        local.matvecs = 0
        return True

    def add_matvecs(self, n):
        """Add a nested driver call's products to the open solve."""
        self._local.matvecs += int(n)

    def end_solve(self):
        """Close this thread's solve id; returns the nested calls' products."""
        local = self._local
        local.solve = None
        return local.matvecs

    def snapshot(self):
        """The closed spans as :class:`Span`, in the order they opened; a
        parent still open, dropped or cleared reads None."""
        records = sorted(self._records)
        index = {r[0]: i for i, r in enumerate(records)}
        return tuple(Span(name, t0, t1, index.get(parent), solve, count)
                     for _, name, t0, t1, parent, solve, count in records)

    def clear(self):
        """Empty the log; spans open now are not written."""
        with self._lock:
            self._floor = next(self._ids)
            self._records = []
            self.dropped = 0


#: The process-wide span log.
LOG = SpanLog()


def spans():
    """The closed spans, in the order they opened: a tuple of
    :class:`Span`."""
    return LOG.snapshot()


def dropped():
    """Spans not recorded because the log was full."""
    return LOG.dropped


def clear():
    """Empty the span log."""
    LOG.clear()


class _Phase:
    """One phase of a :class:`WallClock`, as a context: its host-clock
    total and its span.  Set ``count`` inside it to record the work done."""

    __slots__ = ("_clock", "_name", "count", "_slot", "_t0")

    def __init__(self, clock, name):
        self._clock, self._name, self.count = clock, name, None

    def __enter__(self):
        self._slot = LOG.open()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        name, clock = self._name, self._clock
        LOG.close(self._slot, name, self._t0, t1, self.count)
        clock.totals[name] = clock.totals.get(name, 0.0) + (t1 - self._t0) / 1e9
        clock.counts[name] = clock.counts.get(name, 0) + 1
        return False


class WallClock:
    """Phase stopwatch for host-side instrumentation; every phase is also
    a span of :data:`LOG`.

    >>> clock = WallClock()
    >>> with clock("expand") as phase:
    ...     phase.count = 40
    >>> clock.report()
    {'expand': {'seconds': 0.0123, 'calls': 1}}
    """

    def __init__(self):
        self.totals = {}
        self.counts = {}

    def __call__(self, phase):
        return _Phase(self, phase)

    def report(self):
        return {
            phase: {"seconds": round(t, 6), "calls": self.counts[phase]}
            for phase, t in sorted(self.totals.items())
        }


class _NullPhase:
    """The shared no-op phase: ``count`` may be set and is never read."""

    __slots__ = ("count",)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PHASE = _NullPhase()


class _NullClock:
    """No-op stand-in so hot paths can call ``with clock(...)``
    unconditionally: every phase is one shared null context."""

    def __call__(self, phase):
        return _NULL_PHASE

    def report(self):
        return {}


NULL_CLOCK = _NullClock()


def phase_clock():
    """A :class:`WallClock` when ``ARNOLDI_PHASES`` is set, else the shared
    no-op."""
    return WallClock() if enabled() else NULL_CLOCK


def solve_span(matvecs=None):
    """Decorator of a public driver: with ``ARNOLDI_PHASES`` set, a call
    outside any other driver's is one ``solve`` span and opens the solve id
    that every span inside it carries; a call inside another driver's
    joins that one.  ``matvecs(result)`` gives the products a call made:
    the outer call's sets the span's count, and where the outer driver
    gives none, the nested calls' sum does."""

    def wrap(fn):
        @functools.wraps(fn)
        def driver(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            if not LOG.begin_solve():           # inside another driver's call
                out = fn(*args, **kwargs)
                if matvecs is not None:
                    LOG.add_matvecs(matvecs(out))
                return out
            slot = LOG.open()
            t0 = time.time_ns()
            count = None
            try:
                out = fn(*args, **kwargs)
                if matvecs is not None:
                    count = matvecs(out)
                return out
            finally:
                nested = LOG.end_solve()
                LOG.close(slot, "solve", t0, time.time_ns(),
                          (nested or None) if count is None else count)

        return driver

    return wrap
