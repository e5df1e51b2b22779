"""MB copied between the host and the device a frame by the CRF
(``models/crf.py``: the KNN graph of the frame pushed, the window's
staging and the posteriors' download), the mean ``h2d_bytes`` +
``d2h_bytes`` of the ``crf_cycle`` section's counters in the window
driver's report of each timed call; None where no report has one (a
program that does not count the CRF's transfers)."""

import json


def read(rec, roofline):
    moved = []
    for rep in filter(None, rec.reports):
        for sec in json.loads(rep).get("children", []):
            if sec["name"] == "crf_cycle":
                c = sec["counters"]
                moved.append(c["h2d_bytes"] + c["d2h_bytes"])
    return sum(moved) / len(moved) / 1e6 if moved else None
