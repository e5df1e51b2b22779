"""Candidate-overflow re-runs a frame (``runner.py``: a cell with more
candidate clusters than slots re-runs the frame with 3x the slots), from
the ``iteration_loop`` sections of each timed call's
``last_timing_report`` beyond the first."""

from sections import count_per_call


def read(rec, roofline):
    loops = count_per_call(rec.reports, "iteration_loop")
    return None if loops is None else loops - 1
