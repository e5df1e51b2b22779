"""The mean field's share of its roofline (%): the least time of a call's
``crf_iters`` rounds over a full window of T frames, C classes, N nodes
and D = ``knn`` neighbours, at the card's memory rate, over the mean
``crf_meanfield`` section of the CRF's reports.  A round must read and
write q [T, C, N] once and read the unaries [T, C, N], the spatial weights
and neighbour indices [T, N, D] and the two temporal weights [T - 1, N]
once, all 4-byte; what today's torch ops move beyond that is not counted.
None where the program reports no such section."""

from sections import section_ms


def read(rec, roofline):
    ms = section_ms(rec.reports, "crf_meanfield")
    if not ms:
        return None
    c = rec.cfg
    T, C, N, D = c["window"], c["num_classes"], c["num_components"], c["knn"]
    moved = 4 * (3 * T * C * N + 2 * T * N * D + 2 * (T - 1) * N)
    least = c["crf_iters"] * moved / roofline.HBM_BYTES_PER_S
    return 100.0 * least / (ms / 1e3)
