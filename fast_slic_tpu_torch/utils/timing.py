"""Timing report with the reference's nested-JSON shape, spans on the
profiler's clock, and the counters of host-device traffic and launches.

The reference wraps every pipeline phase in an fstimer::Scope and
serializes the section tree to nested JSON
``{"name": ..., "duration": <micros>, "children": [...]}``
(``src/timer.{h,cpp}``), surfaced as ``slic_model.last_timing_report``.

On a CUDA device each section is timed with CUDA events recorded on the
current stream, so a duration is device time between the two points and
the timer adds no synchronisation; :meth:`Timer.report` synchronises once.
Elsewhere the host clock is used.

:func:`span` (and the decorator :func:`spanned`) records a host range
``fstt.<name>`` that ``torch.profiler`` sees as an operator event, on the
same clock as the device's kernels (CUPTI); every :meth:`Timer.scope` opens
one, of its own name unless it is given another.  Spans nest on the host thread, so the outermost one
of a public call stands for the call.  With no profiler running a span
stores nothing.

:data:`COUNTS` counts what crosses between the host and a CUDA device
(:func:`to_device`, :func:`to_host`: ``h2d_bytes``, ``d2h_bytes`` and
``host_syncs``, each a wait of the host on the device) and the kernel
launches (``launch.<entry point>``, ``kernels._lib.launch``), and the
runner's candidate-overflow re-runs (``runner.reruns``).  A timer's
top-level section carries the call's ``host_syncs``, ``h2d_bytes`` and
``d2h_bytes`` under ``"counters"`` in the report.
"""

from __future__ import annotations

import collections
import functools
import json
import time
from contextlib import contextmanager

import torch

# the process's counters, by name (module docstring)
COUNTS = collections.Counter()
# the counters a report's top-level section carries
REPORTED = ("host_syncs", "h2d_bytes", "d2h_bytes")

_RecordFunctionFast = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context manager: the host range ``fstt.<name>``, recorded as an
    operator event (not a user annotation, which the profiler would also
    place on the device's timeline) when a profiler runs."""
    return _RecordFunctionFast("fstt." + name)


def spanned(name: str):
    """A decorator: each call of the function inside :func:`span`
    ``name``."""
    full = "fstt." + name

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _RecordFunctionFast(full):
                return fn(*args, **kwargs)
        return inner
    return wrap


def to_device(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """``t.to(device, dtype)``; a host tensor that crosses to a CUDA device
    counts its bytes and one host sync (a blocking copy from pageable
    memory waits for the stream)."""
    out = t.to(device=device, dtype=dtype)
    if out.is_cuda and not t.is_cuda and out.numel():
        COUNTS["h2d_bytes"] += out.numel() * out.element_size()
        COUNTS["host_syncs"] += 1
    return out


def to_host(t: torch.Tensor, read=None):
    """``t.cpu()``, or ``read(t)`` (``bool``, ``int``, ``Tensor.item``) for
    a value; a CUDA tensor counts its bytes and one host sync."""
    if t.is_cuda and t.numel():
        COUNTS["d2h_bytes"] += t.numel() * t.element_size()
        COUNTS["host_syncs"] += 1
    return t.cpu() if read is None else read(t)


class Timer:
    """Stack-based section timer producing the reference JSON shape.

    device: a torch device (or None); CUDA devices time with events on
    the device's current stream."""

    def __init__(self, device=None):
        device = None if device is None else torch.device(device)
        self._cuda = device is not None and device.type == "cuda"
        self._device = device
        self._stack = []
        self._last = None
        self._counts0 = self._counts = None

    def _mark(self):
        if self._cuda:
            ev = torch.cuda.Event(enable_timing=True)
            if self._device.index in (None, torch._C._cuda_getDevice()):
                ev.record()
            else:  # another card than the current one
                ev.record(torch.cuda.current_stream(self._device))
            return ev
        return time.perf_counter()

    def begin(self, name: str):
        if not self._stack:
            self._counts0 = {k: COUNTS[k] for k in REPORTED}
        self._stack.append({"name": name, "start": self._mark(),
                            "children": []})

    def end(self):
        if not self._stack:
            return
        sec = self._stack.pop()
        sec["stop"] = self._mark()
        if self._stack:
            self._stack[-1]["children"].append(sec)
        else:
            self._last = sec
            self._counts = {k: COUNTS[k] - self._counts0[k]
                            for k in REPORTED}

    @contextmanager
    def scope(self, name: str, span_name: str = None):
        """The section ``name`` inside :func:`span` ``span_name`` (by
        default ``name``)."""
        with span(name if span_name is None else span_name):
            self.begin(name)
            try:
                yield
            finally:
                self.end()

    def _resolve(self, sec):
        start, stop = sec.pop("start", None), sec.pop("stop", None)
        if start is not None:
            if self._cuda:
                secs = start.elapsed_time(stop) / 1e3
            else:
                secs = stop - start
            sec["duration"] = int(secs * 1e6)
        for child in sec["children"]:
            self._resolve(child)
        return sec

    def report(self) -> str:
        """The last finished top-level section as JSON (durations in
        microseconds; ``counters``: the counts while it ran), or "" if none
        finished.  This method's synchronisation is not counted: it comes
        after the section, whose last reads have drained the stream."""
        if self._last is None:
            return ""
        if self._cuda:
            torch.cuda.synchronize(self._device)
        sec = self._resolve(self._last)
        sec["counters"] = self._counts
        return json.dumps(sec)
