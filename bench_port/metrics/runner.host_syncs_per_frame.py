"""Waits of the host on the device a frame (``runner.py``: each blocking
copy or read between the host and the device), the mean ``host_syncs``
of each timed call's ``last_timing_report`` counters."""

from spans import counter_per_call


def read(rec, roofline):
    return counter_per_call(rec.reports, "host_syncs")
