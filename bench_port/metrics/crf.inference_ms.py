"""Mean ``crf_inference`` section a call (ms): ``SimpleCRF.inference``
(``models/crf.py``: the window's staging, its energies and the mean
field), from the CRF's ``last_timing_report`` after each timed call; None
where the program reports none."""

from sections import section_ms


def read(rec, roofline):
    return section_ms(rec.reports, "crf_inference")
