"""Timing report with the reference's nested-JSON shape.

The reference wraps every pipeline phase in an fstimer::Scope and
serializes the section tree to nested JSON
``{"name": ..., "duration": <micros>, "children": [...]}``
(``src/timer.{h,cpp}``), surfaced as ``slic_model.last_timing_report``.

On a CUDA device each section is timed with CUDA events recorded on the
current stream, so a duration is device time between the two points and
the timer adds no synchronisation; :meth:`Timer.report` synchronises once.
Elsewhere the host clock is used.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager

import torch


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

    @contextmanager
    def scope(self, name: str):
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
        microseconds), or "" if none finished."""
        if self._last is None:
            return ""
        if self._cuda:
            torch.cuda.synchronize(self._device)
        return json.dumps(self._resolve(self._last))
