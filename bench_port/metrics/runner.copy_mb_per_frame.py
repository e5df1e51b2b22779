"""MB copied between the host and the device a frame (``runner.py``: the
image, the state, tables, labels and flags), the mean ``h2d_bytes`` +
``d2h_bytes`` of each timed call's ``last_timing_report`` counters."""

from spans import counter_per_call


def read(rec, roofline):
    h2d = counter_per_call(rec.reports, "h2d_bytes")
    d2h = counter_per_call(rec.reports, "d2h_bytes")
    return None if h2d is None else (h2d + d2h) / 1e6
