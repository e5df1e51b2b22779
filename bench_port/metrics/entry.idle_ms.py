"""Idle ms a frame of the device in the profiled slice while the innermost
open span of the program is a public entry's (``fstt.entry.*``: the
classes' ``__init__``, ``iterate``, host seeding, ``BatchedSlic.iterate``),
the host's own work in ``models/slic.py``, ``model.py`` and
``parallel/batch.py``."""

from spans import idle_ms


def read(rec, roofline):
    return idle_ms(rec, lambda chain: chain[-1].startswith("fstt.entry."))
