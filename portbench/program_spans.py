"""The program's own spans against the device's busy time.

With ``ARNOLDI_PHASES`` set (a traced run sets it) the program records a
span at each layer boundary (``arnoldi_tpu_torch.utils.profiling.spans()``:
name, start and end, parent, solve id, count) on the clock of
``torch.profiler``'s kineto events.  :func:`traced_solve` takes the spans of
the program's ``solve`` that holds most of the busy time of the traced
run's device-only solve (``RunData.timeline``); :class:`SolveSpans` splits
that solve's idle time by span.  A program that records no spans, or a run
with no device timeline, leaves the readers nothing to read (None).

The readers (``metrics/<name>.py``), each of the device's idle time in
that solve:

* ``expand.idle_pct``: the share of the ``expand`` spans' wall;
* ``restart.idle_ms_per_restart``: inside the ``restart`` spans (the host
  turn of a restart), over their number;
* ``inner.idle_pct``: the share of the ``inner.solve`` spans' wall;
* ``filter.idle_pct``: the share of the ``filter.sweep`` and
  ``filter.ghost_gate`` spans' wall;
* ``device.idle_unspanned_pct``: the share of the solve's idle time in no
  span below ``solve``.
"""


def program_spans():
    """The program's closed spans, or None when it records none."""
    try:
        from arnoldi_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return list(read()) or None


def merged(intervals):
    """Sorted ``(start, end, ...)`` intervals as a sorted list of disjoint
    ``(start, end)``."""
    out = []
    for start, end, *_ in intervals:
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        elif end > start:
            out.append([start, end])
    return [tuple(iv) for iv in out]


def overlap_ns(a, b):
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def length_ns(intervals):
    return sum(end - start for start, end in intervals)


class SolveSpans:
    """One solve's spans, its ``solve`` span among them, against the
    device's busy intervals ``busy`` (sorted, disjoint)."""

    def __init__(self, spans, busy):
        self.solve = next(s for s in spans if s.name == "solve")
        self.spans = [s for s in spans if s is not self.solve]
        self.busy = busy

    def named(self, names):
        return [s for s in self.spans if s.name in names]

    def union(self, spans):
        return merged(sorted((s.start_ns, s.end_ns) for s in spans))

    def idle_ns(self, intervals):
        """The device's idle time inside ``intervals`` (disjoint)."""
        return length_ns(intervals) - overlap_ns(intervals, self.busy)

    def idle_pct(self, names):
        """Percent of the wall inside the spans ``names`` (their union)
        during which the device was idle; None when they never opened."""
        ivs = self.union(self.named(names))
        wall = length_ns(ivs)
        return 100.0 * self.idle_ns(ivs) / wall if wall else None

    def idle_per_span_ms(self, name):
        """Milliseconds of device idle time inside the spans ``name``, over
        their number; None when none opened."""
        spans = self.named((name,))
        if not spans:
            return None
        return self.idle_ns(self.union(spans)) / 1e6 / len(spans)

    def unspanned_idle_pct(self):
        """Percent of the solve's idle time that falls in no span below
        ``solve``; None when the device never idled in it."""
        whole = [(self.solve.start_ns, self.solve.end_ns)]
        idle = self.idle_ns(whole)
        if idle <= 0:
            return None
        return 100.0 * (idle - self.idle_ns(self.union(self.spans))) / idle


def traced_solve(run):
    """:class:`SolveSpans` of the program's solve that holds most of the
    device-only solve's busy time, or None."""
    timeline = getattr(run, "timeline", None)
    if timeline is None or not timeline.device:
        return None
    spans = program_spans()
    if not spans:
        return None
    busy = merged(timeline.device)
    best, held = None, 0
    for s in spans:
        if s.name == "solve":
            inside = overlap_ns([(s.start_ns, s.end_ns)], busy)
            if inside > held:
                best, held = s, inside
    if best is None:
        return None
    return SolveSpans([s for s in spans if s.solve == best.solve], busy)
