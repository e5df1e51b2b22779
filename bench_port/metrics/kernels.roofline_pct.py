"""The hand-written kernels' share of their roofline (%): the least time
of the work a frame needs from them (``roofline.frame``: LAB, the assign
passes, the updates, LSC's features and re-centring, one connectivity
pass; counted from the frame's shapes), over the device time of every
launch of a kernel of ``fast_slic_tpu_torch/csrc`` in the profiled
slice."""


def read(rec, roofline):
    s = rec.slice
    if s is None:
        return None
    spent = s.hand_kernel_s(rec.hand_kernels)
    if spent <= 0:
        return None
    return 100.0 * s.frames * roofline.frame(rec.cfg) / spent
