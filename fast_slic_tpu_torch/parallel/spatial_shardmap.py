"""Explicit spatial parallelism: one image's rows over the ``space`` axis of
a mesh, with halo exchanges and psums.

The counterpart of ``fast_slic_tpu/parallel/spatial_shardmap.py``.  The
JAX package runs its shard step under ``shard_map`` with ``ppermute``,
``psum`` and ``all_gather``; this port runs the same step for each shard
in turn from one Python process and moves data between shards only
through the collectives of :class:`.mesh.Mesh`:

* **assignment needs no communication**: each shard shifts the replicated
  [K] cluster state into its own rows, drops the clusters more than S+1
  rows from its slab, and builds its candidate lists with visit-order keys
  of the image's coordinates (``pipeline.build_candidates(..., key=)``);
  its row remainder is (rem - row0) mod stride;
* **update**: each shard's [6, K] sums, Σi made global by count * row0,
  merged by one psum (the reference's critical-section merge,
  context.cpp:345-353); LSC's [K+1, 11] sums likewise;
* **connectivity enforcement** (:func:`_enforce_connectivity_spatial`):
  the minimum of a seed over each region of the image, kept per slab
  region in a table indexed by the region's root (the slab's
  ``connected_components``, found once for every seed and round); one-row
  halos of labels and table values are exchanged, and each slab's two edge
  rows lower its table across the seams (``kernels.cca.seam_min``), until
  a psum'd "changed" flag says the image has its fixpoint (the seam merge
  of cca.cpp:89-99).  No round touches more than the edge rows; the
  per-pixel minima are gathered once at the end.

Equal to the single-device pipeline bit for bit for the standard, real,
real_l2 and real_noq variants and the preemptive grid; LSC agrees to f32
rounding (its update sums are added shard by shard).  A CCA tie escalates,
as in the JAX package, to the exact CCA on the raw assignment gathered
once (``ops.cca.enforce_connectivity_exact``): the one pixel-sized
transfer between shards.  Component tables are sized by the image's
component count, so the JAX package's component overflow cannot arise.

Candidate lists: a shard's first and last cell rows also take the clusters
within S+1 rows outside its slab, and where the slab ends inside a cell
the last rows' 3x3 neighbourhoods span 3.5 cell rows; so a shard's lists
hold twice the image's slots (32 for 16; 48 at most).  A flagged overflow
re-runs the image from its state on the runner's schedule
(``runner.rerun_slots``), and the next image of the same shape starts at
the kept run's slots (``runner.CarriedSlots``).  The JAX class takes the
exact CCA of the truncated assignment instead, which differs from the
single device's where a dropped candidate would have won a pixel
(ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cluster as cluster_lib
from ..cluster import Clusters
from ..config import UNASSIGNED, VARIANT_LSC, StaticConfig, check_arch
from .. import pipeline
from ..kernels.cca import connected_components, lookup, seam_min
from ..kernels.lab import rgb_to_lab_planar
from ..kernels.segsum import segment_sum, slic_update, slic_update_masked
from ..ops import lsc as lsc_ops
from ..ops.cca import _substitutes, enforce_connectivity_exact
from ..runner import MAX_CAND_SLOTS, CarriedSlots
from .mesh import Mesh, make_mesh

__all__ = ["ShardedSlicExplicit"]

_BIG = 0x7FFFFFFF


def _halo_propagate(mesh: Mesh, labs, tables, roots, rounds: list):
    """The minimum of a seed over every 4-connected equal-label region of
    the whole image, per pixel (int32 [Hl, W] a shard).  Each shard gives
    its seed as a region table (int32 [Hl*W], see
    ``kernels.cca.region_table``: slot r holds the seed's minimum over the
    slab region whose root, in ``roots``, is pixel r), which is lowered in
    place.  Each round, every shard gathers the table values of its two
    edge rows, sends them to its neighbours, and lowers its slots where
    the labels match across a seam (``seam_min``), until a round lowers
    nothing anywhere (the psum'd flags; one host read a round).  No op
    inside the loop touches more than a row of a slab; the per-pixel
    result is one lookup a shard at the end.  Appends the round count, the
    last round (which lowers nothing) included, to ``rounds``."""
    D = len(labs)
    lab_above = mesh.ppermute([lab[-1:] for lab in labs], up=True)
    lab_below = mesh.ppermute([lab[:1] for lab in labs], up=False)
    edges = [torch.stack([r[0], r[-1]]) for r in roots]    # [2, W] a shard
    # seam_min stamps a shard's flag with the round that lowered a slot, so
    # each flag only grows and their psum grows exactly in the rounds that
    # lower something: no flag is zeroed between rounds
    flags = [torch.zeros((), dtype=torch.int32, device=t.device)
             for t in tables]
    total, n = 0, 0
    while True:
        n += 1
        vals = [lookup(e, t) for e, t in zip(edges, tables)]
        v_above = mesh.ppermute([v[1:] for v in vals], up=True)
        v_below = mesh.ppermute([v[:1] for v in vals], up=False)
        for d in range(D):
            if d > 0:
                seam_min(tables[d], roots[d][0], labs[d][0], lab_above[d][0],
                         v_above[d][0], flags[d], n)
            if d < D - 1:
                seam_min(tables[d], roots[d][-1], labs[d][-1],
                         lab_below[d][0], v_below[d][0], flags[d], n)
        now = int(mesh.psum(flags))
        if now == total:
            rounds.append(n)
            return [lookup(r, t) for r, t in zip(roots, tables)]
        total = now


def _enforce_connectivity_spatial(mesh: Mesh, asgs, K: int, thres: int,
                                  rounds: list):
    """ConnectivityEnforcer::execute (cca.cpp:178-265) over the row shards
    ``asgs`` (int32 [Hl, W] each): the single-device
    ``ops.cca.enforce_connectivity_flagged`` with every image-wide
    quantity assembled by collectives.

    Components are numbered by their minimum pixel (a halo propagation of
    the pixel ids) in the image's raster order: each shard ranks its
    leaders, and an all_gather of the shards' counts gives each its
    offset; a second propagation spreads the ranks.  Areas and orphan
    targets (the component left of a leader, or above it at column 0: the
    shard above's last row at a slab's first) come from each shard's
    segment sum over the image's components, merged by a psum; the first
    shard selects and chases the orphans as the single-device CCA does,
    and each shard relabels by a lookup.  Returns (labels per shard, int32
    [Hl, W], UNASSIGNED kept; the top-K boundary-tie flag, on the first
    shard)."""
    D = len(asgs)
    Hl, W = asgs[0].shape
    devs = [a.device for a in asgs]
    roots = [connected_components(a) for a in asgs]
    iotas = [torch.arange(d * Hl * W, (d + 1) * Hl * W, dtype=torch.int32,
                          device=dev).reshape(Hl, W)
             for d, dev in enumerate(devs)]
    # Neither seed needs its region table built: a root is its slab
    # region's smallest pixel, so the table of the pixel ids is the iota
    # itself, and every leader (its image region's smallest pixel) is a
    # root, so the table of the leader ranks is the seed itself.
    L2 = _halo_propagate(mesh, asgs, [i.clone().reshape(-1) for i in iotas],
                         roots, rounds)
    leaders = [x == i for x, i in zip(L2, iotas)]
    incl = [torch.cumsum(x.reshape(-1), 0, dtype=torch.int32)
            for x in leaders]
    totals = mesh.all_gather([c[-1] for c in incl]).tolist()
    ncomp = int(sum(totals))
    offsets = np.concatenate([[0], np.cumsum(totals)[:-1]]).tolist()
    seeds = []
    for d in range(D):
        rank = (incl[d] - leaders[d].reshape(-1).to(torch.int32)
                + int(offsets[d]))
        seeds.append(torch.where(leaders[d].reshape(-1), rank, _BIG))
    comps = _halo_propagate(mesh, asgs, seeds, roots, rounds)
    comp_above = mesh.ppermute([c[-1:] for c in comps], up=True)
    tables = []
    for d in range(D):
        c = comps[d]
        donor = torch.zeros_like(c)
        donor[:, 1:] = c[:, :-1]
        donor[1:, 0] = c[:-1, 0]
        donor[0, 0] = comp_above[d][0, 0]   # 0 at the image's pixel 0
        vals = torch.stack([torch.ones_like(c),
                            torch.where(leaders[d], donor, 0)])
        tables.append(segment_sum(c.reshape(-1), vals.reshape(2, -1),
                                  ncomp)[:, :ncomp])
    acc = mesh.psum(tables)
    sub, tie = _substitutes(
        acc[0], acc[1], torch.tensor(ncomp, device=devs[0]), K, thres,
        n_pixels=D * Hl * W)
    labels = [lookup(c, s) for c, s in zip(comps, mesh.broadcast(sub))]
    return labels, tie


@dataclasses.dataclass
class _ShardOut:
    labels: list              # int32 [Hl, W] a shard, -1 = unassigned
    clusters: Clusters        # final state, on the first shard
    cca_tie: torch.Tensor     # bool, first shard
    cand_overflow: torch.Tensor  # bool, first shard
    raw_assignment: list      # int32 [Hl, W] a shard, pre-CCA
    seam_rounds: list         # rounds of each halo propagation


def shard_step(mesh: Mesh, image: np.ndarray, st: Clusters,
               cfg: StaticConfig, scalars, max_iter: int,
               stride: int) -> _ShardOut:
    """The full iterate() of one uint8 [H, W, 3] image with its rows split
    over the mesh's ``space`` axis (data row 0): the JAX package's
    ``local_step`` (spatial_shardmap.py:240-364) for each shard in turn.
    ``st``: the cluster state on the first shard.  H % D == 0."""
    devs = mesh.axis_devices("space")
    D = len(devs)
    H, W, K, S = cfg.H, cfg.W, cfg.K, cfg.S
    Hl = H // D
    row0s = [d * Hl for d in range(D)]
    cfg_l = dataclasses.replace(cfg, H=Hl, S_fixed=S,
                                cand_slots=min(2 * cfg.cand_slots,
                                               MAX_CAND_SLOTS))
    lsc = cfg.variant == VARIANT_LSC

    # cielab of each slab, uploaded to its shard (shard_map's P("space"))
    planes = []
    for d, dev in enumerate(devs):
        img = torch.from_numpy(np.ascontiguousarray(
            image[row0s[d]:row0s[d] + Hl])).to(dev)
        planes.append(rgb_to_lab_planar(img) if cfg.convert_to_lab
                      else img.permute(2, 0, 1).to(torch.int32)
                      .contiguous())

    # cluster colour re-seed: the shard holding a centre's row gives its
    # colour, merged by a psum (context.cpp:128-135)
    cyi = torch.clamp(st.y.to(torch.int64), 0, H - 1)
    cxi = torch.clamp(st.x.to(torch.int64), 0, W - 1)
    seeds = []
    for d, (cy, cx) in enumerate(zip(mesh.broadcast(cyi),
                                     mesh.broadcast(cxi))):
        owns = (cy >= row0s[d]) & (cy < row0s[d] + Hl)
        ly = torch.clamp(cy - row0s[d], 0, Hl - 1)
        seeds.append(torch.where(owns, planes[d][:, ly, cx], 0))
    cols = mesh.psum(seeds).to(torch.float32)
    st = st.replace(r=cols[0], g=cols[1], b=cols[2],
                    is_updatable=torch.full(
                        (K,), pipeline._PREEMPTIVE_COOLDOWN,
                        dtype=torch.int32, device=devs[0]))

    feats = weights = [None] * D
    cent = None
    if lsc:
        fw = lsc_ops.features_sharded(planes, cfg, scalars.lsc_tables, mesh)
        feats, weights = [f for f, _ in fw], [w for _, w in fw]
        cent = lsc_ops.seed_centroids_sharded(feats, st, cfg, mesh)

    asgs = [torch.full((Hl, W), UNASSIGNED, dtype=torch.int32, device=dev)
            for dev in devs]
    overflow = [torch.zeros((), dtype=torch.bool, device=dev)
                for dev in devs]

    def assign_all(st, stride, rem):
        """One assign pass on every shard (in place); returns the clamped
        state the single-device loop carries (context.cpp:209-212)."""
        st = pipeline._clamp_centers(st, cfg)
        key = pipeline.visit_order_key(st.y, st.x, cfg)
        cent_d = mesh.broadcast(cent) if lsc else [None] * D
        for d, (stg, key_d) in enumerate(zip(
                _broadcast_clusters(mesh, st), mesh.broadcast(key))):
            r0 = row0s[d]
            in_range = (stg.y >= r0 - S - 1) & (stg.y < r0 + Hl + S + 1)
            st_l = stg.replace(y=stg.y - r0,
                               is_active=stg.is_active * in_range)
            cand, cov = pipeline.build_candidates(
                st_l.y, st_l.x, st_l.is_active, cfg_l, key=key_d)
            overflow[d] = overflow[d] | cov
            pipeline.assign_pass(planes[d], st_l, cand, asgs[d], cfg_l,
                                 scalars, stride, (rem - r0) % stride,
                                 None, feats[d], cent_d[d])
        return st

    pixel_mask = ([torch.ones((Hl, W), dtype=torch.bool, device=dev)
                   for dev in devs] if cfg.preemptive else [None] * D)
    for i in range(max_iter):
        rem = i % stride
        st = assign_all(st, stride, rem)
        old_y, old_x = st.y, st.x  # set_old_clusters
        accs, acc11 = [], []
        for d in range(D):
            rem_l = (rem - row0s[d]) % stride
            if cfg.preemptive:
                acc = slic_update_masked(asgs[d], planes[d],
                                         pixel_mask[d], K, stride, rem_l)
            else:
                acc = slic_update(asgs[d], planes[d], K, stride, rem_l)
            # local row sums -> the image's: Σi += count * row0
            acc[1] += acc[0] * row0s[d]
            accs.append(acc)
            if lsc:
                pm = pixel_mask[d]
                acc11.append(lsc_ops.after_update_acc(
                    feats[d][:, rem_l::stride],
                    weights[d][rem_l::stride], asgs[d][rem_l::stride], K,
                    None if pm is None else pm[rem_l::stride]))
        acc = mesh.psum(accs)
        st = pipeline.update_apply_means_rows(acc[0], acc[1:], st, cfg)
        if lsc:
            cent = lsc_ops.after_update_apply(mesh.psum(acc11), st, cent)
        if cfg.preemptive:
            st = pipeline.preemptive_update(st, old_y, old_x, cfg,
                                            scalars.l1_thres)
            pixel_mask = [pipeline.preemptive_mask(std, cfg, r0, Hl)
                          for std, r0 in zip(_broadcast_clusters(mesh, st),
                                             row0s)]

    # preemptive_grid.finalize, then full_assign at stride 1
    st = st.replace(is_active=torch.ones_like(st.is_active))
    st = assign_all(st, 1, 0)
    rounds = []
    labels, tie = _enforce_connectivity_spatial(mesh, asgs, K,
                                                int(scalars.thres), rounds)
    labels = [torch.where(x == UNASSIGNED, -1, x) for x in labels]
    ovf = mesh.psum([o.to(torch.int32) for o in overflow]) > 0
    return _ShardOut(labels, st, tie, ovf, asgs, rounds)


def _broadcast_clusters(mesh: Mesh, st: Clusters):
    """The replicated cluster state on every shard of the space axis."""
    fields = [mesh.broadcast(f) for f in st.fields()]
    return [Clusters(*fs) for fs in zip(*fields)]


class ShardedSlicExplicit:
    """Single-image SLIC with rows sharded over the mesh's ``space`` axis by
    explicit collectives (halo exchanges and psums).  Every variant
    (standard / real / real_l2 / real_noq / lsc) and the preemptive grid;
    equal to the single-device pipeline for all but LSC, which agrees to
    f32 rounding.

    ``mesh``: a :class:`.mesh.Mesh`; by default every visible GPU on the
    space axis (``make_mesh(data=1)``), which raises without a GPU.  The
    shards are those of data row 0.  ``iterate`` returns numpy int16 labels
    with -1 for unassigned, like ``Slic.iterate``; the cluster state is
    :attr:`state`."""

    def __init__(self, num_components=400, compactness=10.0,
                 min_size_factor=0.25, subsample_stride=3,
                 convert_to_lab=True, variant="standard", arch="xla",
                 preemptive=False, preemptive_thres=0.05,
                 mesh: Mesh | None = None):
        check_arch(arch)
        self.num_components = num_components
        self.compactness = compactness
        self.min_size_factor = min_size_factor
        self.subsample_stride = subsample_stride
        self.convert_to_lab = convert_to_lab
        self.variant = variant
        self.arch = arch
        self.preemptive = preemptive
        self.preemptive_thres = preemptive_thres
        self.mesh = mesh if mesh is not None else make_mesh(data=1)
        self._state = None        # Clusters on the first shard
        self._slots = CarriedSlots()
        self.last_tie = False     # the last iterate's CCA tie
        self.last_reruns = 0      # its re-runs after a candidate overflow
        self.last_seam_rounds = []  # rounds of each halo propagation

    @property
    def device(self) -> torch.device:
        """The first shard's device, where the replicated state lives."""
        return self.mesh.axis_devices("space")[0]

    @property
    def state(self):
        """The cluster state as numpy ``Clusters`` ([K] fields), or None
        before the first image."""
        return None if self._state is None else self._state.as_numpy()

    @state.setter
    def state(self, st) -> None:
        """Any object with the eight [K] cluster fields (numpy, or a JAX
        ``Clusters``) becomes the state."""
        self._state = cluster_lib.clusters_from_numpy(
            st.y, st.x, st.r, st.g, st.b, st.num_members, st.is_active,
            st.is_updatable).to_torch(self.device)
        self._slots.reset()

    def _config(self, image):
        H, W, _ = image.shape
        D = self.mesh.shape["space"]
        if H % D:
            raise ValueError("image rows %d must divide over the space "
                             "axis (%d devices)" % (H, D))
        cfg = StaticConfig(H=H, W=W, K=self.num_components,
                           variant=self.variant,
                           convert_to_lab=bool(self.convert_to_lab),
                           preemptive=bool(self.preemptive),
                           cand_slots=self._slots.start(H, W))
        if self.variant == VARIANT_LSC and (cfg.S // 4) >= H // D:
            raise ValueError(
                "LSC centroid seeding window (S/4 = %d rows) must fit in "
                "one shard's slab (%d rows)" % (cfg.S // 4, H // D))
        # update sums are int32: Σi of a cluster (at most its (2S+1)^2
        # window's pixels) must stay below 2^31
        if min((2 * cfg.S + 1) ** 2, H * W) * (H - 1) >= 2 ** 31:
            raise ValueError("Σi of a cluster could pass 2^31 at H=%d S=%d"
                             % (H, cfg.S))
        return cfg

    def _run(self, image, max_iter):
        """One shard step at the carried slots."""
        image = np.ascontiguousarray(image, np.uint8)
        cfg = self._config(image)
        if self._state is None:
            self._state = cluster_lib.initialize_clusters(
                image, self.num_components).to_torch(self.device)
        scalars = pipeline.derive_scalars(cfg, self.compactness,
                                          self.min_size_factor,
                                          self.preemptive_thres)
        start = self._state
        out = shard_step(self.mesh, image, start, cfg, scalars,
                         int(max_iter), int(self.subsample_stride))
        self.last_seam_rounds = out.seam_rounds
        tie, ovf = torch.stack([out.cca_tie, out.cand_overflow]).tolist()
        return image, cfg, scalars, start, out, bool(tie), bool(ovf)

    def _exact_labels(self, out, cfg, scalars):
        """The escalation: the exact CCA on the raw assignment, gathered
        once on the first shard."""
        raw = self.mesh.gather(out.raw_assignment)
        fixed, _ = enforce_connectivity_exact(raw, cfg.K,
                                              int(scalars.thres))
        fixed = fixed.cpu().numpy()
        labels = fixed.astype(np.int16)
        labels[fixed == UNASSIGNED] = -1
        return labels

    def iterate(self, image, max_iter=10):
        self.last_reruns = 0
        while True:
            image, cfg, scalars, _, out, tie, ovf = self._run(image,
                                                              max_iter)
            if not self._slots.rerun(cfg.cand_slots, ovf):
                break
            self.last_reruns += 1
        self.last_tie = tie
        # a tie (or lists still full at 48 slots): the exact CCA on the raw
        # assignment, as the JAX class (spatial_shardmap.py:433-441)
        labels = (self._exact_labels(out, cfg, scalars) if tie or ovf
                  else join_labels(out.labels))
        self._state = out.clusters
        return labels


def join_labels(parts) -> np.ndarray:
    """The shards' label rows as one numpy int16 [H, W] map on the host."""
    return np.concatenate([x.cpu().numpy() for x in parts]).astype(np.int16)
