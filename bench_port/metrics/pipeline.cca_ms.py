"""Mean ``enforce_connectivity`` section a call (ms): the connectivity
pass of ``pipeline.py``, from each timed call's
``last_timing_report``."""

from sections import section_ms


def read(rec, roofline):
    return section_ms(rec.reports, "enforce_connectivity")
