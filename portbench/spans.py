"""Spans around calls into the program's layers, recorded from the
benchmark's own files.

A per-layer metric names the functions it wraps as targets
``"package.module:attr"``, ``"package.module:Class.method"`` or
``"package.module:MAPPING[key]"`` (a function held in a dict, as the
drivers' ortho registry holds the kernels).  In a traced run the harness
replaces each target by a wrapper that opens a ``torch.profiler``
``record_function`` span named ``pb:<span>`` and, while recording is on,
keeps what the metric's ``capture`` takes from the call's arguments (the
shapes that its byte count needs).  A target that no longer exists leaves
the metric nothing to read; the run goes on.
"""

import functools
import importlib
import re

_TARGET = re.compile(r"^([\w.]+):([\w.]+)(?:\[(\w+)\])?$")

PREFIX = "pb:"


def resolve(target):
    """``(holder, key, function)``: where ``target`` lives and what it is
    now, or None when the module, attribute or key is gone."""
    m = _TARGET.match(target)
    if not m:
        raise ValueError(f"malformed span target {target!r}")
    module, path, key = m.groups()
    try:
        holder = importlib.import_module(module)
    except ImportError:
        return None
    *parents, last = path.split(".")
    for name in parents:
        holder = getattr(holder, name, None)
        if holder is None:
            return None
    if key is None:
        fn = getattr(holder, last, None)
        return None if fn is None else (holder, last, fn)
    mapping = getattr(holder, last, None)
    if not isinstance(mapping, dict) or key not in mapping:
        return None
    return (mapping, key, mapping[key])


class Recorder:
    """The wrapped targets of one run and what their calls captured."""

    def __init__(self):
        self.on = False
        self.calls = {}         # span name -> [what capture returned, ...]
        self._depth = {}        # span name -> calls open now
        self.installed = {}     # span name -> [target, ...]
        self._undo = []

    def wrap(self, span, target, capture=None):
        """Wrap ``target`` in the span ``span``; False when it is gone."""
        found = resolve(target)
        if found is None:
            return False
        holder, key, fn = found
        from torch.profiler import record_function

        name = PREFIX + span
        calls = self.calls.setdefault(span, [])
        depth = self._depth
        depth.setdefault(span, 0)
        recorder = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            # a call inside an open call of the same span (a product that
            # goes through another) is the outer call's work
            if not recorder.on or depth[span]:
                return fn(*args, **kwargs)
            if capture is not None:
                calls.append(capture(*args, **kwargs))
            depth[span] += 1
            try:
                with record_function(name):
                    return fn(*args, **kwargs)
            finally:
                depth[span] -= 1

        self._set(holder, key, wrapper)
        self._undo.append((holder, key, fn))
        self.installed.setdefault(span, []).append(target)
        return True

    @staticmethod
    def _set(holder, key, value):
        if isinstance(holder, dict):
            holder[key] = value
        else:
            setattr(holder, key, value)

    def restore(self):
        """Put every wrapped target back."""
        for holder, key, fn in reversed(self._undo):
            self._set(holder, key, fn)
        self._undo.clear()
