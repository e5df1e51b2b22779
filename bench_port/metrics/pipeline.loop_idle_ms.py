"""Idle ms a frame of the device in the profiled slice inside the
program's ``iteration_loop`` section (``pipeline.py``, any span below it):
the host time of the assign/update loop that the device waits through."""

from spans import idle_ms


def read(rec, roofline):
    return idle_ms(rec, lambda chain: "fstt.iteration_loop" in chain)
