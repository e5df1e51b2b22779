"""Batched frames: :class:`batch.BatchedSlic` (map and stack modes) and the
stacked program of :mod:`.stack`."""
