"""Idle ms a frame of the device in the profiled slice under a span of the
CRF or of the graph functions (``fstt.crf.*``: the push with its KNN
graph, the inference with the window's staging, the energies and the mean
field, the posteriors' download; ``fstt.graph.*``: the KNN, the classes'
broadcast to the pixels); None without a device trace or where the
program records no such span."""

from spans import idle_ms

PREFIXES = ("fstt.crf.", "fstt.graph.")


def read(rec, roofline):
    s = rec.slice
    if s is None or not any(h[0].startswith(PREFIXES)
                            for h in s.host_events):
        return None
    return idle_ms(rec, lambda chain: any(n.startswith(PREFIXES)
                                          for n in chain))
