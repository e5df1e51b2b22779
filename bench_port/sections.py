"""Sections of the program's timing reports (``last_timing_report``: nested
JSON ``{"name", "duration" (us), "children"}``)."""

import json


def _named(report, name):
    """The sections called ``name`` in one report."""
    stack = [json.loads(report)]
    while stack:
        sec = stack.pop()
        if sec["name"] == name:
            yield sec
        stack.extend(sec.get("children", []))


def section_ms(reports, name):
    """Mean ms a call of the sections called ``name`` (a call that runs
    one twice, as a candidate-overflow re-run does, counts both), over the
    calls that have one; None when none has."""
    total, calls = 0, 0
    for rep in filter(None, reports):
        secs = list(_named(rep, name))
        total += sum(s.get("duration", 0) for s in secs)
        calls += bool(secs)
    return total / calls / 1e3 if calls else None


def count_per_call(reports, name):
    """Mean number of sections called ``name`` a call, or None."""
    counts = [len(list(_named(rep, name))) for rep in filter(None, reports)]
    return sum(counts) / len(counts) if counts else None
