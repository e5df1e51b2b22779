"""Idle ms a frame of the device in the profiled slice under the
program's preemptive grid step (``pipeline.py``: ``fstt.loop.preemptive``
and the ``preemptive.cooldown`` and ``preemptive.mask`` spans inside it):
the host glue of the grid that the device waits through; None without a
device trace or where the program records no such span."""

from spans import idle_ms

SPAN = "fstt.loop.preemptive"


def read(rec, roofline):
    s = rec.slice
    if s is None or not any(h[0] == SPAN for h in s.host_events):
        return None
    return idle_ms(rec, lambda chain: SPAN in chain)
