"""Batched (video) SLIC: :class:`BatchedSlic` over [B, H, W, 3] frames.

The counterpart of ``fast_slic_tpu/parallel/batch.py``.  Two batch
modes:

* ``"map"`` (default): the frames run in turn through the single-frame
  pipeline (``pipeline.iterate_graph``) on the device; every variant.
* ``"stack"``: one program over all B frames with a frame axis in every
  kernel (:mod:`.stack`); every variant but LSC, for B*K < 0xFFFF, and map
  otherwise, as in the JAX package.

``"canvas"`` (the JAX package's spacer-row TPU layout, not ported) runs
the stack path: its per-frame results equal map's, and so do stack's.

With ``mesh=`` (a :class:`.mesh.Mesh`) the batch splits over the mesh's
``data`` axis in contiguous groups of B / data frames, as ``shard_map``'s
``P("data")`` splits it; each group runs map or stack mode on the first
``space`` shard of its data row (the ``space`` axis is replicated, as in
the JAX package).  Frames are independent, so the groups share nothing but
the flags: the candidate overflow is the any of the groups' (an
all_gather), the tie flags stay per frame.  Labels, flags and the state
are joined on the first group's device.

Exactness is kept by the runner's escalation: a candidate overflow
re-runs the batch from its state before the batch on the runner's
schedule (``runner.rerun_slots``; the batch carries the kept run's slots,
``runner.CarriedSlots``), and a frame whose CCA ties at the top-K boundary
takes the exact selection (``runner.tie_labels``).  The flags of a batch
come to the host in one transfer, in :meth:`PendingBatch.resolve`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cluster as cluster_lib
from ..cluster import Clusters
from ..config import UNASSIGNED, VARIANT_LSC, StaticConfig, check_arch
from ..model import resolve_device
from ..pipeline import derive_scalars, iterate_graph
from ..runner import CarriedSlots, tie_labels
from ..utils.timing import span, spanned, to_device, to_host
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
    runs the plain PyTorch path.  With ``mesh`` its devices hold the frames
    (module docstring) and ``device`` is not used.  ``arch`` is accepted
    for API parity.
    """

    @spanned("entry.init")
    def __init__(self, num_components=400, compactness=10.0,
                 min_size_factor=0.25, subsample_stride=3,
                 convert_to_lab=True, manhattan_spatial_dist=True,
                 variant="standard", preemptive=False, preemptive_thres=0.05,
                 arch=None, mesh=None, check_exactness=True,
                 batch_mode="map", device="cuda"):
        if batch_mode not in ("map", "canvas", "stack"):
            raise ValueError("batch_mode must be 'map', 'stack' or 'canvas'")
        if arch is not None:
            check_arch(arch)
        self.mesh = mesh
        # one device a group of frames: the data axis's, or ``device``
        self._devices = ([resolve_device(device)] if mesh is None else
                         [resolve_device(d)
                          for d in mesh.axis_devices("data")])
        self.device = self._devices[0]
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
        self._state = None  # a group's Clusters of [B/data, K] tensors
        self._slots = CarriedSlots()
        self.last_flags = None

    # -- configuration -------------------------------------------------
    def _use_stack(self, B: int) -> bool:
        return (self.batch_mode in ("stack", "canvas")
                and self.variant != VARIANT_LSC
                and B // len(self._devices) * self.num_components
                < UNASSIGNED)

    def _cfg(self, H: int, W: int) -> StaticConfig:
        return StaticConfig(
            H=H, W=W, K=self.num_components, variant=self.variant,
            convert_to_lab=bool(self.convert_to_lab),
            manhattan_spatial_dist=bool(self.manhattan_spatial_dist),
            preemptive=bool(self.preemptive),
            cand_slots=self._slots.start(H, W))

    # -- state ----------------------------------------------------------
    @spanned("entry.seed")
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
        if self._state is None:
            return None
        return Clusters(*(np.concatenate(xs) for xs in zip(
            *(g.as_numpy().fields() for g in self._state))))

    @state.setter
    def state(self, st) -> None:
        """Any object with the eight [B, K] cluster fields (numpy, or a JAX
        ``Clusters``) becomes the state, split over the groups' devices."""
        st = cluster_lib.clusters_from_numpy(
            st.y, st.x, st.r, st.g, st.b, st.num_members, st.is_active,
            st.is_updatable)
        G = len(self._devices)
        Bg = _group_size(st.y.shape[0], G)
        self._state = [Clusters(*(x[g * Bg:(g + 1) * Bg]
                                  for x in st.fields())).to_torch(dev)
                       for g, dev in enumerate(self._devices)]
        self._slots.reset()

    # -- hot path --------------------------------------------------------
    @spanned("entry.batch")
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
        B, H, W, _ = images.shape
        Bg = _group_size(B, len(self._devices))
        if self._state is None:
            self.initialize(to_host(images).numpy())
        cfg = self._cfg(H, W)
        scalars = derive_scalars(cfg, self.compactness, self.min_size_factor,
                                 self.preemptive_thres)
        max_iter, stride = int(max_iter), int(self.subsample_stride)
        stacked = self._use_stack(B)
        parts = []
        for g, dev in enumerate(self._devices):
            with span("batch.upload"):
                frames = to_device(images[g * Bg:(g + 1) * Bg], dev)
            parts.append(_run_group(stacked, frames, self._state[g], cfg,
                                    scalars, max_iter, stride))
        labels, st, raw, ovf, tie = zip(*parts)
        if self.mesh is None:
            labels, ovf, tie = labels[0], ovf[0], tie[0]
        else:
            labels = self.mesh.gather(list(labels), axis="data")
            ovf = torch.any(self.mesh.all_gather(list(ovf), axis="data"))
            tie = self.mesh.gather(list(tie), axis="data")
        # [1 + B] flags: one device-to-host transfer resolves the batch
        both = torch.cat([ovf.reshape(1), tie.reshape(-1)])
        self.last_flags = both[1:]
        prev_state, self._state = self._state, list(st)
        return PendingBatch(self, images, prev_state, max_iter, cfg, scalars,
                            labels, both, list(raw))


def _run_group(stacked: bool, images, st, cfg, scalars, max_iter, stride):
    """One group's frames on its device, stacked or mapped: (labels,
    state, raw assignment, overflow flag, tie flags)."""
    if stacked:
        out = iterate_graph_stacked(images, st, cfg, scalars, max_iter,
                                    stride)
        return (out.labels, out.clusters, out.raw_assignment,
                out.cand_overflow, out.cca_tie)
    outs = [iterate_graph(images[f], _frame(st, f), cfg, scalars, max_iter,
                          stride)
            for f in range(images.shape[0])]
    return (torch.stack([o.labels for o in outs]),
            _stack([o.clusters for o in outs]),
            torch.stack([o.raw_assignment for o in outs]),
            torch.any(torch.stack([o.cand_overflow for o in outs])),
            torch.stack([o.cca_tie for o in outs]))


def _group_size(B: int, groups: int) -> int:
    """Frames a group: B over the data axis (shard_map's P("data"))."""
    if B % groups:
        raise ValueError("batch size %d must divide over the data axis "
                         "(%d devices)" % (B, groups))
    return B // groups


class PendingBatch:
    """A queued :class:`BatchedSlic` batch: its device tensors and the
    deferred exactness check."""

    def __init__(self, parent, images, prev_state, max_iter, cfg, scalars,
                 labels, both, raw):
        self._p = (parent, images, prev_state, max_iter, cfg, scalars,
                   labels, both, raw)

    @spanned("batch.resolve")
    def resolve(self):
        """Fetch the batch's flags (one transfer) and return the labels
        (int32 [B, H, W] on the device, -1 = unassigned), after the
        candidate-overflow re-run or the tie escalations they call for."""
        (parent, images, prev_state, max_iter, cfg, scalars, labels, both_d,
         raw) = self._p
        if not parent.check_exactness:
            return labels
        both = to_host(both_d).numpy()
        if parent._slots.rerun(cfg.cand_slots, bool(both[0])):
            # candidate slots exceeded: re-run the batch from its state
            # before the batch, starting at the re-run's slots
            parent._state = prev_state
            return parent.iterate(images, max_iter)
        Bg = raw[0].shape[0]
        for f in np.nonzero(both[1:])[0].tolist():
            labels[f] = tie_labels(raw[f // Bg][f % Bg], cfg.K,
                                   int(scalars.thres)).to(labels.device)
        return labels
