"""The pixels the masked updates added, over the pixels of the rows they
visited (%), over the traced calls' preemptive activity
(``roofline_preemptive.activity``): 100 where the grid masks nothing; it
shows that the cell still exercises the grid.  None where the program
reports no activity."""

import roofline_preemptive as rp


def read(rec, roofline):
    c = rec.cfg
    added = visited = 0
    for rows in rp.activity(rec.reports):
        added += sum(px for _, px in rows)
        visited += rp.visited_px(c["height"], c["width"],
                                 c["subsample_stride"], len(rows))
    return 100.0 * added / visited if visited else None
