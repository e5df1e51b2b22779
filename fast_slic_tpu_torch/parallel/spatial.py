"""Spatial parallelism: one image's rows sharded across a device mesh.

The counterpart of ``fast_slic_tpu/parallel/spatial.py``.  The JAX package
runs the single-device program there under sharding constraints and lets
GSPMD insert the collectives; PyTorch has no GSPMD, so :class:`ShardedSlic`
runs the explicit shard step of :mod:`.spatial_shardmap` and keeps this
class's own escalations (fast_slic_tpu/parallel/spatial.py:82-117):

* a candidate overflow re-runs the image on the first shard's device
  through ``runner.run_iterate`` from the state before it, starting at the
  slots this object carries (``runner.CarriedSlots.hand_off``: a re-run;
  the next call's shards start no lower than their own re-run would, or at
  the slots of the run the runner keeps, if more);
* a CCA top-K tie takes the exact CCA on the raw assignment, and the new
  cluster state is kept.
"""

from __future__ import annotations

from ..config import RuntimeParams
from ..runner import run_iterate
from .spatial_shardmap import ShardedSlicExplicit, join_labels

__all__ = ["ShardedSlic"]


class ShardedSlic(ShardedSlicExplicit):
    """Single-image SLIC with rows sharded over the mesh's ``space`` axis;
    the constructor of :class:`.spatial_shardmap.ShardedSlicExplicit`.

    ``iterate`` returns numpy int16 labels with -1 for unassigned, exactly
    like ``Slic.iterate`` (the single-frame API contract)."""

    def iterate(self, image, max_iter=10):
        image, cfg, scalars, start, out, tie, ovf = self._run(image,
                                                              max_iter)
        self.last_tie = tie
        if ovf:
            self._slots.hand_off(cfg.cand_slots)
            res = run_iterate(cfg, image, start.as_numpy(), RuntimeParams(
                compactness=self.compactness,
                min_size_factor=self.min_size_factor,
                subsample_stride=int(self.subsample_stride),
                max_iter=int(max_iter),
                preemptive_thres=self.preemptive_thres), self.device,
                carry=self._slots)
            self.last_tie = res.cca_tie
            self._state = res.clusters.to_torch(self.device)
            return res.labels
        labels = (self._exact_labels(out, cfg, scalars) if tie
                  else join_labels(out.labels))
        self._state = out.clusters
        return labels
