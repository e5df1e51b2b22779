"""Idle ms a frame of the device in the profiled slice inside the
program's ``enforce_connectivity`` section (``pipeline.py``,
``ops/cca.py``, any span below it): the connectivity pass's host time
that the device waits through."""

from spans import idle_ms


def read(rec, roofline):
    return idle_ms(rec, lambda chain: "fstt.enforce_connectivity" in chain)
