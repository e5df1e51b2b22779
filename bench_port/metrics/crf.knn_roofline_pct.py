"""The KNN's share of its roofline (%): the least time of a frame's KNN
graph (``csrc/knn.cu``: the K centres' y and x read, the K lists of
``knn`` neighbours and the K counts written, int32 and float32, at the
card's memory rate) over the device time of the ``knn_buckets_kernel``
and ``knn_kernel`` launches in the profiled slice."""

import devtrace

KERNELS = frozenset({"knn_buckets_kernel", "knn_kernel"})


def read(rec, roofline):
    s = rec.slice
    if s is None:
        return None
    spent = sum(e - b for n, b, e in s.device_events
                if devtrace.kernel_id(n) in KERNELS) * 1e-6
    if spent <= 0:
        return None
    K, m = rec.cfg["num_components"], rec.cfg["knn"]
    moved = 4 * (2 * K + K * m + K)
    return 100.0 * s.frames * moved / roofline.HBM_BYTES_PER_S / spent
