"""Frames whose connectivity pass tied at the top-K boundary and took the
exact selection, over all frames of the run (``SlicModel.last_cca_tie``,
``BatchedSlic.last_flags``)."""


def read(rec, roofline):
    return rec.tie_frames / rec.frames if rec.frames else None
