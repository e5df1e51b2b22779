"""The masked update's share of its roofline (%): the least time of a
frame's masked updates (``roofline_preemptive.masked_update``, from the
traced calls' mean activity) over the device time a frame of the
``slic_update_kernel<true, ...>`` launches in the profiled slice.  None
without a device trace, without such a launch, or where the program
reports no activity."""

import roofline_preemptive as rp


def read(rec, roofline):
    s = rec.slice
    calls = rp.activity(rec.reports)
    if s is None or not calls:
        return None
    spent = sum(e - b for n, b, e in s.device_events
                if rp.is_masked_update(n)) * 1e-6
    if spent <= 0:
        return None
    c = rec.cfg
    least = sum(rp.masked_update(c["height"], c["width"],
                                 c["num_components"], c["subsample_stride"],
                                 rows) for rows in calls) / len(calls)
    return 100.0 * s.frames * least / spent
