"""The program's spans and counters, as the per-layer metrics read them.

Spans: host ranges ``fstt.<name>`` that ``fast_slic_tpu_torch`` records
(``utils/timing.span``), operator events of the profiled slice on the
device trace's clock.  Every idle microsecond of the device in the slice
(outside the union of its kernels, copies and memsets) is charged once,
to the innermost span open then; idle time outside every span is charged
to none.

Counters: the ``"counters"`` of each timed call's ``last_timing_report``
(``host_syncs``, ``h2d_bytes``, ``d2h_bytes``).
"""

from __future__ import annotations

import collections
import json

PREFIX = "fstt."


def innermost(spans):
    """The spans (name, start, end) as pieces [(start, end, chain)] in time
    order, ``chain`` the names of the spans open over the piece, outermost
    first.  Spans nest (one host thread); where one outlasts its parent,
    its end is cut to the parent's."""
    pieces, stack, t = [], [], None     # stack: [(end, chain)]

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            end, chain = stack.pop()
            if end > t:
                pieces.append((t, end, chain))
                t = end

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close(s)
        if stack and s > t:
            pieces.append((t, s, stack[-1][1]))
        chain = (stack[-1][1] if stack else ()) + (name,)
        stack.append((min(e, stack[-1][0]) if stack else e, chain))
        t = s
    close(float("inf"))
    return pieces


def idle_intervals(sl):
    """The device's idle intervals [(start, end)] (us) within the slice's
    events: between the first and the last event, outside the union of
    the device's."""
    busy = sl.busy_intervals()
    events = [(s, e) for _, s, e in sl.host_events] + [
        (s, e) for _, s, e in sl.device_events]
    if not events:
        return []
    t, hi = min(s for s, _ in events), max(e for _, e in events)
    out = []
    for s, e in busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def idle_by_chain(sl):
    """Idle microseconds of the slice by the chain of spans open at them
    (:func:`innermost`); ``()`` is idle time outside every span.  None when
    the slice has no span."""
    spans = [h for h in sl.host_events if h[0].startswith(PREFIX)]
    if not spans:
        return None
    pieces = innermost(spans)
    acc = collections.Counter()
    i = 0
    for a, b in idle_intervals(sl):
        covered = 0.0
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            s, e, chain = pieces[j]
            part = min(b, e) - max(a, s)
            if part > 0:
                acc[chain] += part
                covered += part
            j += 1
        acc[()] += (b - a) - covered
    return acc


def idle_ms(rec, keep):
    """Idle ms a frame of the profiled slice where the chain of open spans
    is one that ``keep(chain)`` accepts; None without a device trace or
    when the program records no span."""
    sl = rec.slice
    acc = idle_by_chain(sl) if sl is not None and sl.device_events else None
    if acc is None:
        return None
    return sum(us for chain, us in acc.items()
               if chain and keep(chain)) / 1e3 / sl.frames


def counter_per_call(reports, key):
    """Mean ``counters[key]`` of the reports' top-level sections; None
    when no report carries counters."""
    values = []
    for rep in filter(None, reports):
        counters = json.loads(rep).get("counters")
        if counters is not None:
            values.append(counters[key])
    return sum(values) / len(values) if values else None
