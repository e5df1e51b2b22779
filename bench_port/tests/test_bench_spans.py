"""The readers of the program's spans and counters (``spans.py``) on
hand-built slices: each idle microsecond charged once, to the innermost
span open then, and nothing for idle time outside every span."""

import json

import pytest

import devtrace
import harness
import spans

IDLE = ("entry.idle_ms", "runner.idle_ms", "pipeline.loop_idle_ms",
        "pipeline.cca_idle_ms")
COUNTERS = ("runner.host_syncs_per_frame", "runner.copy_mb_per_frame")


def read(name, sl=None, reports=()):
    rec = harness.Records({}, {})
    rec.slice, rec.reports = sl, list(reports)
    return harness.metric_reader(name)(rec, None)


def ms(*events):
    """(name, start, end) with times in ms, as the trace's us."""
    return [(n, 1e3 * s, 1e3 * e) for n, s, e in events]


# one call (times in ms): the entry's own host work, the runner's
# sections, the loop with a candidate build, the connectivity pass with its
# selection, the write-back
NESTED = ms(("fstt.entry.iterate", 0, 100), ("fstt.iterate", 5, 95),
            ("fstt.iteration_loop", 10, 60), ("fstt.loop.candidates", 12, 30),
            ("fstt.enforce_connectivity", 65, 80), ("fstt.cca.select", 70, 78),
            ("fstt.write_back", 82, 94), ("aten::empty", 13, 14))
BUSY = ms(("k", 0, 2), ("k", 20, 25), ("k", 40, 50), ("k", 66, 67),
          ("k", 90, 100))


@pytest.mark.parametrize("frames", [1, 4])
def test_nested_spans_charge_the_innermost(frames):
    """The idle gaps [2, 20], [25, 40], [50, 66] (across the loop, the
    runner's iterate and the connectivity pass) and [67, 90]."""
    sl = devtrace.Slice(BUSY, NESTED, frames, 0.1)
    got = {n: read(n, sl) for n in IDLE}
    want = {"entry.idle_ms": 3, "runner.idle_ms": 5 + 5 + 2 + 8,
            "pipeline.loop_idle_ms": 2 + 8 + 5 + 10 + 10,
            "pipeline.cca_idle_ms": 1 + 3 + 8 + 2}
    assert got == pytest.approx({n: v / frames for n, v in want.items()})
    # every idle ms of the slice lies in some span here, and none twice
    idle = (1e3 * sl.wall_s - 1e-3 * sum(e - s for s, e in
                                         sl.busy_intervals())) / frames
    assert sum(got.values()) == pytest.approx(idle)


def test_a_gap_across_two_siblings():
    """One idle gap over the labels' and the state's copies, and the
    batch's upload: all the runner's, split at the siblings' seam."""
    sl = devtrace.Slice(
        ms(("k", 0, 2), ("k", 18, 20), ("k", 24, 30)),
        ms(("fstt.write_back", 0, 20), ("fstt.runner.labels_to_host", 1, 10),
           ("fstt.runner.state_to_host", 10, 19),
           ("fstt.batch.upload", 20, 30)), 1, 0.03)
    acc = spans.idle_by_chain(sl)
    assert acc[("fstt.write_back", "fstt.runner.labels_to_host")] == 8e3
    assert acc[("fstt.write_back", "fstt.runner.state_to_host")] == 8e3
    assert read("runner.idle_ms", sl) == pytest.approx(8 + 8 + 4)
    assert read("entry.idle_ms", sl) == 0


def test_idle_outside_every_span_counts_for_none():
    sl = devtrace.Slice(ms(("k", 0, 1), ("k", 50, 51)),
                        ms(("fstt.iteration_loop", 10, 20),
                           ("aten::add", 30, 40)), 1, 0.051)
    assert spans.idle_by_chain(sl)[()] == pytest.approx(39e3)
    assert read("pipeline.loop_idle_ms", sl) == pytest.approx(10)
    assert sum(read(n, sl) for n in IDLE) == pytest.approx(10)


def test_a_span_that_outlasts_its_parent_is_cut():
    sl = devtrace.Slice(ms(("k", 0, 1), ("k", 30, 31)),
                        ms(("fstt.enforce_connectivity", 0, 10),
                           ("fstt.cca.relabel", 5, 20)), 1, 0.031)
    acc = spans.idle_by_chain(sl)
    assert acc[("fstt.enforce_connectivity", "fstt.cca.relabel")] == 5e3
    assert acc[()] == 20e3
    assert read("pipeline.cca_idle_ms", sl) == pytest.approx(9)


def test_a_program_without_spans_reads_nothing():
    """The parent's trace: operator events, no ``fstt.`` span."""
    sl = devtrace.Slice(BUSY, ms(("aten::empty", 3, 4)), 1, 0.1)
    assert all(read(n, sl) is None for n in IDLE)
    assert all(read(n) is None for n in IDLE)
    # the CPU's trace has no device events: no idle time to charge
    assert all(read(n, devtrace.Slice([], NESTED, 1, 0.1)) is None
               for n in IDLE)


def report(**counters):
    rep = {"name": "iterate", "children": [], "duration": 1}
    if counters:
        rep["counters"] = counters
    return json.dumps(rep)


def test_counters_are_a_mean_a_call():
    reps = [report(host_syncs=20, h2d_bytes=3_000_000, d2h_bytes=4_000_000),
            report(host_syncs=30, h2d_bytes=1_000_000, d2h_bytes=2_000_000),
            None]
    assert read("runner.host_syncs_per_frame", reports=reps) == 25
    assert read("runner.copy_mb_per_frame", reports=reps) == 5.0


def test_a_report_without_counters_reads_nothing():
    for name in COUNTERS:
        assert read(name, reports=[report(), None]) is None
        assert read(name) is None
