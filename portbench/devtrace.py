"""Reading ``torch.profiler`` traces in memory.

:class:`Timeline` reads a solve profiled with device activity alone (the
busy share); :class:`Trace` one profiled with host activity too (the
spans, and what the host did while the device was idle).  Nothing is
written to disk.  The raw kineto events are read once (torch's
``FunctionEvent`` list took 100 s to build for half a million kernels
with an H100's host).  A device operation (kernel, memcpy, memset) is laid
to the host call that launched it through the CUDA runtime's correlation
id, or failing that through the op the profiler linked it to; a span owns
the device operations launched while it was open on its thread.
"""

import bisect

from .spans import PREFIX

#: Idle gaps shorter than this are summed under one name, not labelled.
SHORT_GAP_NS = 20_000


def _is_runtime(name):
    """A CUDA runtime or driver call on the host (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ...), which carries the correlation id of the
    device operation it started (torch 2.11's events have no
    ``activity_type`` to say so)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _device_ops(prof):
    """The device operations of a profile: ``(start_ns, end_ns, name,
    correlation id, linked correlation id)``, sorted, without the device
    copies of the benchmark's spans."""
    from torch.autograd import DeviceType

    return sorted((ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(),
                   ev.correlation_id(), ev.linked_correlation_id())
                  for ev in prof.profiler.kineto_results.events()
                  if ev.device_type() == DeviceType.CUDA
                  and not ev.name().startswith(PREFIX))


def union_ns(intervals):
    """The total length of the union of sorted ``(start, end, ...)``
    intervals."""
    total, reach = 0, None
    for start, end, *_ in intervals:
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total


class Timeline:
    """The device's busy time over one profiled solve, recorded with device
    activity only: the union of its operations' intervals against the
    solve's wall on the host clock (``window_s``)."""

    def __init__(self, prof, window_s):
        self.device = _device_ops(prof)
        self.window_s = window_s
        self.busy_s = union_ns(self.device) / 1e9

    def device_ops(self, top=10):
        """``[[name, seconds], ...]``: the device operations that took most
        time, summed by name."""
        by = {}
        for start, end, name, *_ in self.device:
            by[name] = by.get(name, 0) + (end - start)
        best = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:160], ns / 1e9] for name, ns in best]


class Trace:
    """The device operations, host ops and spans of one traced window."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        host, launch_at, op_at, spans = [], {}, {}, {}
        for ev in prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                continue
            name = ev.name()
            start, end, tid = ev.start_ns(), ev.end_ns(), ev.start_thread_id()
            if _is_runtime(name):
                launch_at[ev.correlation_id()] = (start, tid)
                continue
            op_at[ev.correlation_id()] = (start, tid)
            if name.startswith(PREFIX) and ev.is_user_annotation():
                spans.setdefault(name[len(PREFIX):], []).append((start, end, tid))
            host.append((start, end, tid, name))
        self.spans = {k: sorted(v) for k, v in spans.items()}
        windows = self.spans.pop("window", [])
        if not windows:
            raise RuntimeError("the trace holds no window span")
        self.t0 = min(w[0] for w in windows)
        self.t1 = max(w[1] for w in windows)
        self.main_tid = windows[0][2]
        self.device = _device_ops(prof)
        self.linked = 0
        self.launch = []       # (launch time, tid, duration) per device op
        for start, end, name, corr, linked in self.device:
            at = launch_at.get(corr)
            if at is None and linked > 0:
                at = op_at.get(linked)
                self.linked += at is not None
            if at is not None:
                self.launch.append((at[0], at[1], end - start))
        self.launch.sort()
        self.unlaid = len(self.device) - len(self.launch)
        self.host = sorted(h for h in host if h[2] == self.main_tid)

    # -- the device's busy time -------------------------------------------
    def busy_intervals(self):
        """The union of the device operations' intervals, cut to the
        window: a sorted list of disjoint ``(start, end)``."""
        out = []
        for start, end, *_ in self.device:
            start, end = max(start, self.t0), min(end, self.t1)
            if end <= start:
                continue
            if out and start <= out[-1][1]:
                if end > out[-1][1]:
                    out[-1][1] = end
            else:
                out.append([start, end])
        return [tuple(iv) for iv in out]

    # -- spans ---------------------------------------------------------------
    def span_device_s(self, span):
        """Seconds of device operations launched inside the span ``span``
        (None when the span never opened)."""
        ivs = self.spans.get(span)
        if not ivs:
            return None
        total = 0
        times = [l[0] for l in self.launch]
        for start, end, tid in ivs:
            i = bisect.bisect_left(times, start)
            j = bisect.bisect_right(times, end)
            total += sum(d for t, th, d in self.launch[i:j] if th == tid)
        return total / 1e9

    # -- what the host did while the device was idle -------------------------
    def idle_gaps(self, top=10):
        """``[[label, seconds], ...]``: the device's idle time in the
        window, summed by what the host was doing at each gap's middle (the
        innermost benchmark span and the innermost host op open then);
        gaps under 20 us are summed as one entry."""
        busy = self.busy_intervals()
        edges = [self.t0] + [t for iv in busy for t in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        by = {}
        short = 0
        labelled = []
        for start, end in gaps:
            if end - start < SHORT_GAP_NS:
                short += end - start
            else:
                labelled.append(((start + end) // 2, end - start))
        labelled.sort()
        # host ops on one thread nest: sweep them with a stack
        stack, k, host = [], 0, self.host
        for mid, length in labelled:
            while k < len(host) and host[k][0] <= mid:
                while stack and stack[-1][1] < host[k][0]:
                    stack.pop()
                stack.append(host[k])
                k += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            op = next((h[3] for h in reversed(stack)
                       if not h[3].startswith(PREFIX)), "none")
            span = next((h[3][len(PREFIX):] for h in reversed(stack)
                         if h[3].startswith(PREFIX)), "none")
            label = f"{span} | {op}"[:160]
            by[label] = by.get(label, 0) + length
        best = sorted(by.items(), key=lambda kv: -kv[1])[: top - 1]
        out = [[label, ns / 1e9] for label, ns in best]
        if short:
            out.append([f"gaps under {SHORT_GAP_NS // 1000} us", short / 1e9])
        return out
