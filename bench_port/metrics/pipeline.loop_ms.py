"""Mean ``iteration_loop`` section a call (ms): the subsampled
assign/update loop of ``pipeline.py``, from each timed call's
``last_timing_report``."""

from sections import section_ms


def read(rec, roofline):
    return section_ms(rec.reports, "iteration_loop")
