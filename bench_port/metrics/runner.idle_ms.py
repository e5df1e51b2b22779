"""Idle ms a frame of the device in the profiled slice while the innermost
open span of the program is the runner's (``runner.py``, and the batch's
upload and resolve): its ``iterate``, ``write_to_buffer`` and
``write_back`` sections, the overflow check, the tie escalation and the
copies of the labels and the state to the host."""

from spans import idle_ms

SECTIONS = ("fstt.iterate", "fstt.write_to_buffer", "fstt.write_back")


def read(rec, roofline):
    return idle_ms(rec, lambda chain: chain[-1] in SECTIONS or chain[-1]
                   .startswith(("fstt.runner.", "fstt.batch.")))
