"""100 - the device's busy share (%) of the profiled slice's wall time
(busy: the union of its kernels', copies' and memsets' intervals)."""


def read(rec, roofline):
    s = rec.slice
    if s is None or not s.device_events:
        return None
    return 100.0 - 100.0 * s.busy_s() / s.wall_s
