"""Device launches (kernels, copies, memsets) a frame in the profiled
slice."""


def read(rec, roofline):
    s = rec.slice
    if s is None or not s.device_events:
        return None
    return len(s.device_events) / s.frames
