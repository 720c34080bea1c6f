"""The device's idle share of a solve: one minus the union of its kernel,
memcpy and memset intervals over its wall, in the traced run's first
solve, profiled with device activity only (host activity tracing would
slow the host and inflate the share)."""

UNIT = "%"
LAYER = "Device"
MOVES = "solve_s"
SOURCE = "device_trace"
BETTER = "lower"
SPANS = {}


def read(run):
    timeline = run.timeline
    if timeline is None or timeline.window_s <= 0 or not timeline.device:
        return None
    return 100.0 * (1.0 - timeline.busy_s / timeline.window_s)
