"""The preemptive grid's work as the cell ``slic1080.preemptive`` reads
it: the activity the program reports for each traced call
(``SlicModel.last_preemptive_activity``, carried in the driver's report
as ``"preemptive_activity"``: a row an iteration, the clusters active
after its step and the pixels its masked update added), and the least
time of a call's masked updates on one NVIDIA H100 (``roofline.py``'s
memory rate).
"""

from __future__ import annotations

import json
import re

import roofline

# a launch of the masked update: slic_update_kernel<kMasked = true, ...>
_MASKED_UPDATE = re.compile(r"\bslic_update_kernel<\s*true\b")


def activity(reports) -> list:
    """The activity rows [[active, pixels added], ...] of each report that
    carries them; [] where none does (a program that keeps no count)."""
    out = []
    for rep in filter(None, reports):
        rows = json.loads(rep).get("preemptive_activity")
        if rows is not None:
            out.append(rows)
    return out


def visited_px(H: int, W: int, stride: int, iters: int) -> int:
    """Pixels of the rows a call's ``iters`` subsampled updates visit."""
    return W * sum(roofline.rows(H, stride, i % stride)
                   for i in range(iters))


def masked_update(H: int, W: int, K: int, stride: int, rows) -> float:
    """Seconds: the least time of a call's masked updates, whose activity
    is ``rows``: the assignment and the mask of every visited row's
    pixels read (5 B a pixel), the three LAB planes of the pixels the mask
    passed (12 B), six int32 sums a cluster written (24 B), at the card's
    memory rate."""
    added = sum(px for _, px in rows)
    moved = (5 * visited_px(H, W, stride, len(rows)) + 12 * added
             + 24 * K * len(rows))
    return moved / roofline.HBM_BYTES_PER_S


def is_masked_update(name: str) -> bool:
    """Whether a device event's (demangled) name is a masked update's."""
    return _MASKED_UPDATE.search(name) is not None
