"""Mean ``write_back`` section a call (ms): the tie escalation and the
copies of the labels and the state to the host (``runner.py``), from each timed call's
``last_timing_report``."""

from sections import section_ms


def read(rec, roofline):
    return section_ms(rec.reports, "write_back")
