"""Batched frames and device meshes: :class:`batch.BatchedSlic` (map and
stack modes, split over a mesh's ``data`` axis with ``mesh=``), the
stacked program of :mod:`.stack`, :func:`mesh.make_mesh`, and one image's
rows over a mesh's ``space`` axis (:class:`spatial_shardmap.
ShardedSlicExplicit`, :class:`spatial.ShardedSlic`)."""
