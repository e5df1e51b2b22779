"""Batched (video) SLIC: :class:`BatchedSlic` over [B, H, W, 3] frames.

The counterpart of ``fast_slic_tpu/parallel/batch.py`` on one device.  Two
batch modes:

* ``"map"`` (default): the frames run in turn through the single-frame
  pipeline (``pipeline.iterate_graph``) on the device; every variant.
* ``"stack"``: one program over all B frames with a frame axis in every
  kernel (:mod:`.stack`); every variant but LSC, for B*K < 0xFFFF, and map
  otherwise, as in the JAX package.

``"canvas"`` (the JAX package's spacer-row TPU layout, not ported) runs
the stack path: its per-frame results equal map's, and so do stack's.

Exactness is kept as in the single-frame runner: a candidate overflow
re-runs the batch from its state before the batch with more slots, and a
frame whose CCA ties at the top-K boundary takes the exact selection
(``ops.cca.selection_rerun_device``).  The flags of a batch come to the
host in one transfer, in :meth:`PendingBatch.resolve`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cluster as cluster_lib
from ..cluster import Clusters
from ..config import (UNASSIGNED, VARIANT_LSC, StaticConfig, check_arch,
                      not_ported)
from ..model import resolve_device
from ..ops.cca import selection_rerun_device
from ..pipeline import derive_scalars, iterate_graph
from .stack import iterate_graph_stacked

__all__ = ["BatchedSlic", "PendingBatch"]


def _frame(st: Clusters, f: int) -> Clusters:
    return Clusters(*(x[f] for x in st.fields()))


def _stack(states) -> Clusters:
    return Clusters(*(torch.stack(xs) for xs in zip(*(s.fields()
                                                       for s in states))))


class BatchedSlic:
    """Video-batch SLIC: iterate() over uint8 [B, H, W, 3] frames.

    The cluster state is kept per frame ([B, K] fields, on the device), so
    each stream position warm-starts from its previous frame.  Labels come
    back as an int32 tensor [B, H, W] on the device, -1 = unassigned.
    ``device="cuda"`` (the default) raises without a GPU; ``device="cpu"``
    runs the plain PyTorch path.  ``arch`` is accepted for API parity.
    """

    def __init__(self, num_components=400, compactness=10.0,
                 min_size_factor=0.25, subsample_stride=3,
                 convert_to_lab=True, manhattan_spatial_dist=True,
                 variant="standard", preemptive=False, preemptive_thres=0.05,
                 arch=None, mesh=None, check_exactness=True,
                 batch_mode="map", device="cuda"):
        if batch_mode not in ("map", "canvas", "stack"):
            raise ValueError("batch_mode must be 'map', 'stack' or 'canvas'")
        if mesh is not None:
            raise not_ported("mesh", "§1.13")
        if arch is not None:
            check_arch(arch)
        self.device = resolve_device(device)
        self.batch_mode = batch_mode
        self.num_components = num_components
        self.compactness = compactness
        self.min_size_factor = min_size_factor
        self.subsample_stride = subsample_stride
        self.convert_to_lab = convert_to_lab
        self.manhattan_spatial_dist = manhattan_spatial_dist
        self.variant = variant
        self.preemptive = preemptive
        self.preemptive_thres = preemptive_thres
        self.arch = arch
        self.check_exactness = check_exactness
        self._state = None  # Clusters of [B, K] tensors on the device
        self._capacity_boost = 0
        self.last_flags = None

    # -- configuration -------------------------------------------------
    def _use_stack(self, B: int) -> bool:
        return (self.batch_mode in ("stack", "canvas")
                and self.variant != VARIANT_LSC
                and B * self.num_components < UNASSIGNED)

    def _cfg(self, H: int, W: int) -> StaticConfig:
        kw = {}
        if self._capacity_boost:
            kw["cand_slots"] = min(16 * 2 ** self._capacity_boost, 48)
        return StaticConfig(
            H=H, W=W, K=self.num_components, variant=self.variant,
            convert_to_lab=bool(self.convert_to_lab),
            manhattan_spatial_dist=bool(self.manhattan_spatial_dist),
            preemptive=bool(self.preemptive), **kw)

    # -- state ----------------------------------------------------------
    def initialize(self, images) -> None:
        """Seed the per-frame states from a batch (host grid seeding)."""
        states = [cluster_lib.initialize_clusters(img, self.num_components)
                  for img in np.asarray(images)]
        self.state = Clusters(*(np.stack(xs) for xs in
                                zip(*(s.fields() for s in states))))

    @property
    def state(self):
        """The per-frame cluster state as numpy ``Clusters`` ([B, K]
        fields), or None before the first batch."""
        return None if self._state is None else self._state.as_numpy()

    @state.setter
    def state(self, st) -> None:
        """Any object with the eight [B, K] cluster fields (numpy, or a JAX
        ``Clusters``) becomes the state on the device."""
        self._state = cluster_lib.clusters_from_numpy(
            st.y, st.x, st.r, st.g, st.b, st.num_members, st.is_active,
            st.is_updatable).to_torch(self.device)

    # -- hot path --------------------------------------------------------
    def iterate(self, images, max_iter=10):
        """images: uint8 [B, H, W, 3], numpy or a tensor."""
        return self.iterate_async(images, max_iter).resolve()

    def iterate_async(self, images, max_iter=10) -> "PendingBatch":
        """Queue one batch and return a :class:`PendingBatch` without
        waiting for the device; the per-frame state advances at once, and
        ``resolve()`` fetches the flags and applies the escalations."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if images.dtype != torch.uint8:
            raise ValueError("images must be uint8")
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError("images must be [B, H, W, 3]")
        if self._state is None:
            self.initialize(images.cpu().numpy())
        images = images.to(self.device)
        B, H, W, _ = images.shape
        cfg = self._cfg(H, W)
        scalars = derive_scalars(cfg, self.compactness, self.min_size_factor,
                                 self.preemptive_thres)
        max_iter, stride = int(max_iter), int(self.subsample_stride)
        if self._use_stack(B):
            out = iterate_graph_stacked(images, self._state, cfg, scalars,
                                        max_iter, stride)
            labels, st, raw = out.labels, out.clusters, out.raw_assignment
            ovf, tie = out.cand_overflow, out.cca_tie
        else:
            outs = [iterate_graph(images[f], _frame(self._state, f), cfg,
                                  scalars, max_iter, stride)
                    for f in range(B)]
            labels = torch.stack([o.labels for o in outs])
            st = _stack([o.clusters for o in outs])
            raw = torch.stack([o.raw_assignment for o in outs])
            ovf = torch.any(torch.stack([o.cand_overflow for o in outs]))
            tie = torch.stack([o.cca_tie for o in outs])
        # [1 + B] flags: one device-to-host transfer resolves the batch
        both = torch.cat([ovf.reshape(1), tie.reshape(-1)])
        self.last_flags = both[1:]
        prev_state, self._state = self._state, st
        return PendingBatch(self, images, prev_state, max_iter, cfg, scalars,
                            labels, both, raw)


class PendingBatch:
    """A queued :class:`BatchedSlic` batch: its device tensors and the
    deferred exactness check."""

    def __init__(self, parent, images, prev_state, max_iter, cfg, scalars,
                 labels, both, raw):
        self._p = (parent, images, prev_state, max_iter, cfg, scalars,
                   labels, both, raw)

    def resolve(self):
        """Fetch the batch's flags (one transfer) and return the labels
        (int32 [B, H, W] on the device, -1 = unassigned), after the
        candidate-overflow re-run or the tie escalations they call for."""
        (parent, images, prev_state, max_iter, cfg, scalars, labels, both_d,
         raw) = self._p
        if not parent.check_exactness:
            return labels
        both = both_d.cpu().numpy()
        if both[0] and parent._capacity_boost < 2:
            # candidate slots exceeded: re-run the batch from its state
            # before the batch with more slots (the runner's escalation)
            parent._capacity_boost += 1
            parent._state = prev_state
            return parent.iterate(images, max_iter)
        for f in np.nonzero(both[1:])[0].tolist():
            fixed = selection_rerun_device(raw[f], cfg.K, int(scalars.thres))
            labels[f] = torch.where(fixed == UNASSIGNED, -1, fixed)
        return labels
