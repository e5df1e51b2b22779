"""The SLIC pipeline in PyTorch: setup, the assign/update loop, the full
assign and connectivity enforcement.

The counterpart of ``fast_slic_tpu/pipeline.py`` for every distance
variant (standard (quantized), real, real_l2, real_noq and LSC) and the
preemptive grid.  Plain tensor code stays torch; the per-pixel work goes
through the kernel wrappers of :mod:`fast_slic_tpu_torch.kernels`, which
take the plain PyTorch version on a CPU tensor and the CUDA kernel on a
CUDA tensor.

The loop keeps ONE full-resolution int32 [H, W] assignment.  Iteration i
writes only the rows r with r % stride == i % stride, and the update reads
only those rows: the semantics of the JAX package's scan loop
(``pipeline.py:1018-1070``), which its tests pin as bit-identical to the
TPU loop.  The TPU loop layout (per-remainder resident planes, 64-row and
128-lane padding) is not carried over.

Frame axis: the setup, the loop and the full assign also take B stacked
frames (images [B, H, W, 3], cluster fields [B, K]); every kernel then runs
once over the B frames with frame-local row and cell math, and every [K]
glue op becomes one [B, K] op.  That is the stacked batch mode of
:mod:`fast_slic_tpu_torch.parallel.stack` (LSC stays single-frame, as in
the JAX package).
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from .cluster import Clusters
from .config import (UNASSIGNED, VARIANT_LSC, VARIANT_REAL_NOQ,
                     VARIANT_STANDARD, StaticConfig)
from .kernels import candidates as candidates_kernel
from .kernels.assign import assign
from .kernels.assign_float import F32_MAX, assign_float
from .kernels.lab import rgb_to_lab_planar
from .kernels.segsum import slic_update, slic_update_masked
from .ops import lsc as lsc_ops
from .ops.cca import enforce_connectivity_flagged
from .utils.timing import Timer, span

_PREEMPTIVE_COOLDOWN = 2  # preemptive.h:32


class IterateOut(NamedTuple):
    labels: torch.Tensor          # int32 [H, W], -1 = unassigned
    clusters: Clusters            # final centroid state (tensors)
    min_dists: torch.Tensor       # [H, W] last full-assign distances: int32
                                  # (standard) or f32 (float variants)
    raw_assignment: torch.Tensor  # pre-CCA assignment (int32, 0xFFFF ok)
    cca_tie: torch.Tensor         # bool: top-K boundary tie, escalate
    cand_overflow: torch.Tensor   # bool: re-run with more cand_slots
    # preemptive: int32 [max_iter, 2] (stage_loop's ``activity``), else None
    preemptive_activity: torch.Tensor = None


class DerivedScalars(NamedTuple):
    """Scalars derived on the host with the exact float ops of the
    reference C code (see fast_slic_tpu.pipeline.DerivedScalars): coef
    reaches the assign kernel as this exact float32."""

    coef: np.float32       # spatial coefficient (context.cpp:24-25)
    c_spatial: np.float32  # LSC C_color * compactness/100 (lsc.cpp:27-28)
    thres: np.int32        # CCA area threshold (context.cpp:16)
    l1_thres: np.float32   # preemptive movement threshold (preemptive.h:126)
    lsc_tables: object = None  # host-built trig LUTs (ops.lsc.trig_tables)


def derive_scalars(cfg: StaticConfig, compactness, min_size_factor,
                   preemptive_thres=0.05) -> DerivedScalars:
    S = cfg.S
    color_shift = 1 if cfg.convert_to_lab else 0
    c = np.float32(compactness)
    coef = (np.float32(1.0) / (np.float32(S) / c)) * np.float32(1 << color_shift)
    c_spatial = np.float32(20.0) * (c / np.float32(100.0))
    # (int)round((double)(S*S) * (double)msf): half away from zero
    thres = np.int32(math.floor(float(S * S) * float(min_size_factor) + 0.5))
    # my_max(roundf(2*S*thres), 1.0f)
    l1 = float(np.float32(2 * S) * np.float32(preemptive_thres))
    l1_thres = np.float32(max(math.floor(l1 + 0.5), 1.0))
    tables = (lsc_ops.trig_tables(cfg, compactness)
              if cfg.variant == VARIANT_LSC else None)
    return DerivedScalars(coef, c_spatial, thres, l1_thres, tables)


def cell_grid_shape(cfg: StaticConfig):
    S = cfg.S
    return -(-cfg.H // S), -(-cfg.W // S)


def visit_order_key(y, x, cfg: StaticConfig):
    """Per-cluster visit rank phase*K + k reproducing the reference's
    4-phase checkerboard assignment order (context.cpp:214-242); see
    fast_slic_tpu.pipeline.visit_order_key.  y, x: [..., K]."""
    return candidates_kernel.visit_order_key(y, x, cfg.S, cfg.K)


def build_candidates_batched(y, x, is_active, cfg: StaticConfig, key=None,
                             overflow=None):
    """Per-cell candidate lists of B frames: for every S-cell, the active
    clusters whose centre lies in its 3x3 cell neighbourhood, in visit
    order.  y, x, is_active: [B, K] frame-local.  ``key``: the visit-order
    keys [B, K] when the caller has them (a row shard passes the keys of
    the image's own coordinates, and centres above or below its rows, which
    land in its first or last cell row); by default
    :func:`visit_order_key` of y, x.  Returns (int32
    [B, GH, GW, cand_slots] of frame-local ids, -1 = empty slot; bool
    overflow flag: some cell of some frame has more than cand_slots
    candidates).  ``overflow``: a running flag to OR the build's into, in
    place (the loop's), returned as the flag.

    One launch of the candidate kernel on the card (two without
    ``overflow``: its fill first); the plain version's sort on the CPU
    (:mod:`fast_slic_tpu_torch.kernels.candidates`).  Each frame's result
    equals the single-frame build."""
    GH, GW = cell_grid_shape(cfg)
    return candidates_kernel.candidates(y, x, is_active, cfg.S, GH, GW,
                                        cfg.cand_slots, key, overflow)


def build_candidates(y, x, is_active, cfg: StaticConfig, key=None,
                     overflow=None):
    """:func:`build_candidates_batched` for one frame (fields [K]; cand
    [GH, GW, C]) or for B frames (fields [B, K])."""
    if y.ndim == 2:
        return build_candidates_batched(y, x, is_active, cfg, key, overflow)
    cand, overflow = build_candidates_batched(
        y[None], x[None], is_active[None], cfg,
        None if key is None else key[None], overflow)
    return cand[0], overflow


def _clamp_centers(st: Clusters, cfg: StaticConfig) -> Clusters:
    """Safeguard clamp at the top of assign() (context.cpp:209-212)."""
    return st.replace(y=torch.clamp(st.y, 0.0, cfg.H - 1),
                      x=torch.clamp(st.x, 0.0, cfg.W - 1))


def center_table(st: Clusters) -> torch.Tensor:
    """f32 [..., K, 5] (y, x, r, g, b), the table the assign kernel reads."""
    return torch.stack([st.y, st.x, st.r, st.g, st.b], dim=-1).contiguous()


def update_apply_means_rows(counts, sums, st: Clusters,
                            cfg: StaticConfig) -> Clusters:
    """Centroid means for updatable clusters from counts [..., K] and sums
    [5, ..., K] ordered (i, j, L, a, b): round_int means, or float division
    for real_noq (context.cpp:356-387)."""
    upd = st.is_updatable != 0
    num_members = torch.where(upd, counts.to(torch.int64), st.num_members)
    safe = torch.clamp(counts, min=1)
    if cfg.variant == VARIANT_REAL_NOQ:
        means = sums.to(torch.float32) / safe[None].to(torch.float32)
    else:
        means = ((sums + (safe // 2)[None]) // safe[None]).to(torch.float32)
    sel = upd & (counts > 0)
    return st.replace(
        y=torch.where(sel, means[0], st.y),
        x=torch.where(sel, means[1], st.x),
        r=torch.where(sel, means[2], st.r),
        g=torch.where(sel, means[3], st.g),
        b=torch.where(sel, means[4], st.b),
        num_members=num_members,
    )


def preemptive_mask(st: Clusters, cfg: StaticConfig, row0: int = 0,
                    nrows=None):
    """The active-pixel mask bool [..., H, W] of the preemptive grid: a
    2S-cell is active if it holds an active cluster's centre, and every
    pixel is active when every cluster is (preemptive.h:166-178).  With
    ``nrows``, only the image rows [row0, row0 + nrows) (a row shard's)."""
    H, W = cfg.H, cfg.W
    S2 = 2 * cfg.S
    CH, CW = -(-H // S2), -(-W // S2)
    dev = st.y.device
    cy = torch.clamp(st.y.to(torch.int32) // S2, 0, CH - 1)
    cx = torch.clamp(st.x.to(torch.int32) // S2, 0, CW - 1)
    lead = tuple(st.y.shape[:-1])
    grid = torch.zeros(lead + (CH * CW,), dtype=torch.int32, device=dev)
    grid.scatter_reduce_(-1, (cy * CW + cx).long(), st.is_active, "amax")
    grid = grid.reshape(lead + (CH, CW)) > 0
    rows = torch.arange(row0, row0 + (H if nrows is None else nrows),
                        device=dev) // S2
    cols = torch.arange(W, device=dev) // S2
    px = grid[..., rows, :][..., cols]
    all_active = torch.all(st.is_active == 1, dim=-1)
    return px | all_active[..., None, None]


def _preemptive_step(st: Clusters, old_y, old_x, cfg: StaticConfig,
                     l1_thres):
    """PreemptiveGrid::set_new_clusters (preemptive.h:114-178), for one
    frame (fields [K]) or B frames (fields [B, K]): the clusters of
    :func:`preemptive_update` and their active-pixel mask bool
    [..., H, W], each half in a span of its own."""
    with span("preemptive.cooldown"):
        st = preemptive_update(st, old_y, old_x, cfg, l1_thres)
    with span("preemptive.mask"):
        return st, preemptive_mask(st, cfg)


def preemptive_update(st: Clusters, old_y, old_x, cfg: StaticConfig,
                      l1_thres) -> Clusters:
    """The cluster half of :func:`_preemptive_step`.

    Decrements the per-cluster cooldown when the centre moved less than
    ``l1_thres`` in L1 and re-activates every cluster within L-inf 2S of a
    still-updatable cluster of its frame (a K x K test on the int-cast
    centres, the predicate the reference's cell walk prunes).  Every
    compare is on float32, as in fast_slic_tpu.pipeline._preemptive_step."""
    S2 = 2 * cfg.S
    upd = st.is_updatable > 0
    moved = torch.abs(old_x - st.x) + torch.abs(old_y - st.y)
    # a Python scalar compares in the tensor's float32 (l1_thres is an
    # integer-valued float32, so exact) and needs no host-to-device copy
    new_updatable = torch.where(
        upd,
        torch.where(moved < float(l1_thres), st.is_updatable - 1,
                    _PREEMPTIVE_COOLDOWN),
        st.is_updatable).to(torch.int32)
    # int-cast centres before the nearness test (preemptive.h:150-164)
    yi = torch.trunc(st.y)
    xi = torch.trunc(st.x)
    near = ((torch.abs(yi[..., :, None] - yi[..., None, :]) <= S2)
            & (torch.abs(xi[..., :, None] - xi[..., None, :]) <= S2))
    is_active = torch.any(near & (new_updatable > 0)[..., :, None],
                          dim=-2).to(torch.int32)
    return st.replace(is_active=is_active, is_updatable=new_updatable)


def stage_setup(image, st: Clusters, cfg: StaticConfig,
                scalars: DerivedScalars):
    """CIELAB conversion, the cluster colour re-seed and, for LSC, the
    feature build (context.cpp:114-157).  image: uint8 [H, W, 3] tensor,
    or [B, H, W, 3] frames with [B, K] cluster fields (one LAB launch over
    the [B*H, W] stack).  Returns (planes int32 [3, H, W] or [3, B, H, W],
    clusters, LSC state (feats f32 [10, H, W], weights f32 [H, W],
    centroids f32 [K, 10]) or three Nones)."""
    H, W, K = cfg.H, cfg.W, cfg.K
    lead = tuple(image.shape[:-3])
    flat = image.reshape(-1, W, 3)
    if cfg.convert_to_lab:
        planes = rgb_to_lab_planar(flat)
    else:
        planes = flat.permute(2, 0, 1).to(torch.int32).contiguous()
    planes = planes.reshape((3,) + lead + (H, W))
    cyi = torch.clamp(st.y.to(torch.int64), 0, H - 1)
    cxi = torch.clamp(st.x.to(torch.int64), 0, W - 1)
    idx = cyi * W + cxi
    if lead:
        idx = idx + torch.arange(lead[0], device=idx.device)[:, None] * (H * W)
    seed = planes.reshape(3, -1)[:, idx].to(torch.float32)
    # preemptive_grid.initialize (preemptive.h:59-67) runs regardless of the
    # `preemptive` flag: every cluster's cooldown is reset
    st = st.replace(r=seed[0], g=seed[1], b=seed[2],
                    is_updatable=torch.full(lead + (K,), _PREEMPTIVE_COOLDOWN,
                                            dtype=torch.int32,
                                            device=planes.device))
    lsc_state = (None, None, None)
    if cfg.variant == VARIANT_LSC:
        feats, weights = lsc_ops.features(planes, cfg, scalars.lsc_tables)
        lsc_state = (feats, weights, lsc_ops.seed_centroids(feats, st, cfg))
    return planes, st, lsc_state


def assign_pass(planes, st: Clusters, cand, assignment, cfg: StaticConfig,
                scalars: DerivedScalars, stride: int, rem: int,
                min_dists=None, feats=None, cent=None):
    """One assign pass, in place: the quantized kernel for the standard
    variant, the float kernel for the others (assign_xla's two branches)."""
    table = center_table(st)
    if cfg.variant == VARIANT_STANDARD:
        return assign(planes, table, cand, assignment, scalars.coef, cfg.S,
                      stride, rem, cfg.manhattan_spatial_dist, min_dists)
    return assign_float(planes, table, cand, assignment, scalars.coef, cfg.S,
                        stride, rem, cfg.variant, cfg.manhattan_spatial_dist,
                        min_dists, feats, cent)


def _no_scope(name):
    return contextlib.nullcontext()


def count_activity(activity, steps) -> None:
    """The preemptive grid's activity of a call, in place on the device
    (two launches a call, no host sync): row i of int32 [max_iter, 2] the
    clusters active after iteration i's step and the pixels iteration i's
    masked update added (its per-cluster counts; the pixels step i - 1's
    mask passed).  steps: each iteration's is_active and counts, [..., K]
    int32, in turn."""
    stacked = torch.stack([t.reshape(-1) for t in steps])
    torch.sum(stacked.reshape(activity.shape + (-1,)), dim=-1,
              dtype=torch.int32, out=activity)


def stage_loop(planes, st: Clusters, lsc_state, cfg: StaticConfig,
               scalars: DerivedScalars, max_iter: int, stride: int,
               timer=None, recorder=None, activity=None):
    """max_iter x (assign, update) with row subsampling and a rotating
    remainder (context.cpp:158-175); LSC re-centres its feature centroids
    after each update; the preemptive grid masks the update to its active
    cells and steps after it (fast_slic_tpu/pipeline.py:1035-1057).
    Returns (clusters, assignment, LSC centroids or None, candidate
    overflow flag).

    ``timer`` (profile=True): a ``write_to_buffer`` section for the loop's
    buffers, then one ``assign``, ``update`` and, for LSC, ``after_update``
    section an iteration (fast_slic_tpu/pipeline.py:1258).  ``recorder``
    (debug_mode; utils.recorder.Recorder): a snapshot (assignment,
    min_dists, clusters) before the first iteration and after each one;
    each pass's min_dists is a fresh fill that the assign writes on its
    rows (fast_slic_tpu/pipeline.py:571-580, 1024-1073).  ``activity``
    (preemptive): an int32 [max_iter, 2] device buffer that
    :func:`count_activity` fills after the last iteration's step."""
    feats, weights, cent = lsc_state
    dev = planes.device
    scope = _no_scope if timer is None else timer.scope
    with scope("write_to_buffer"):
        assignment = torch.full(planes.shape[1:], UNASSIGNED,
                                dtype=torch.int32, device=dev)
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
        pixel_mask = (torch.ones(planes.shape[1:], dtype=torch.bool,
                                 device=dev)
                      if cfg.preemptive else None)
    steps = []
    min_dists = None
    if recorder is not None:
        standard = cfg.variant == VARIANT_STANDARD
        dist_fill = UNASSIGNED if standard else F32_MAX
        dist_dtype = torch.int32 if standard else torch.float32
        recorder.snap(-1, assignment,
                      torch.full_like(assignment, dist_fill,
                                      dtype=dist_dtype), st)
    for i in range(max_iter):
        rem = i % stride
        with scope("assign"):
            with span("loop.candidates"):
                st = _clamp_centers(st, cfg)
                cand, overflow = build_candidates(st.y, st.x, st.is_active,
                                                  cfg, overflow=overflow)
            if recorder is not None:
                min_dists = torch.full_like(assignment, dist_fill,
                                            dtype=dist_dtype)
            with span("loop.assign"):
                assign_pass(planes, st, cand, assignment, cfg, scalars,
                            stride, rem, min_dists, feats, cent)
        old_y, old_x = st.y, st.x  # set_old_clusters (context.cpp:303)
        with scope("update"), span("loop.update"):
            # per-cluster (count, i, j, L, a, b) over the rows just assigned
            if cfg.preemptive:
                acc = slic_update_masked(assignment, planes, pixel_mask,
                                         cfg.K, stride, rem)
            else:
                acc = slic_update(assignment, planes, cfg.K, stride, rem)
            acc = acc.reshape((6,) + tuple(st.y.shape))
            st = update_apply_means_rows(acc[0], acc[1:], st, cfg)
        if cfg.variant == VARIANT_LSC:
            with scope("after_update"), span("loop.after_update"):
                cent = lsc_ops.after_update(feats, weights, st, cent, cfg,
                                            rem, stride, assignment,
                                            pixel_mask)
        if cfg.preemptive:
            with span("loop.preemptive"):
                st, pixel_mask = _preemptive_step(st, old_y, old_x, cfg,
                                                  scalars.l1_thres)
                if activity is not None:
                    steps += (st.is_active, acc[0])
        if recorder is not None:
            recorder.snap(i, assignment, min_dists, st)
    if steps:
        count_activity(activity, steps)
    return st, assignment, cent, overflow


def stage_full_assign(planes, st: Clusters, lsc_state, cent, assignment,
                      cfg: StaticConfig, scalars: DerivedScalars,
                      overflow=None):
    """Preemptive finalize and full_assign at stride 1
    (context.cpp:176-181).  Updates ``assignment`` in place; returns
    (clusters, assignment, min_dists, candidate overflow flag).  The flag
    is ``overflow`` (the loop's) OR-ed in place when given."""
    with span("loop.candidates"):
        st = st.replace(is_active=torch.ones_like(st.is_active))
        st = _clamp_centers(st, cfg)
        cand, cov = build_candidates(st.y, st.x, st.is_active, cfg,
                                     overflow=overflow)
    dtype = (torch.int32 if cfg.variant == VARIANT_STANDARD
             else torch.float32)
    min_dists = torch.empty(assignment.shape, dtype=dtype,
                            device=assignment.device)
    with span("loop.assign"):
        assign_pass(planes, st, cand, assignment, cfg, scalars, 1, 0,
                    min_dists, lsc_state[0], cent)
    return st, assignment, min_dists, cov


def stage_cca(assignment, cfg: StaticConfig, scalars: DerivedScalars):
    """enforce_connectivity (context.cpp:15-20, cca.cpp:178-265): returns
    (labels int32 [H, W] with -1 for unassigned, tie flag)."""
    labels, cca_tie = enforce_connectivity_flagged(assignment, cfg.K,
                                                   int(scalars.thres))
    return torch.where(labels == UNASSIGNED, -1, labels), cca_tie


def iterate_graph(image, st: Clusters, cfg: StaticConfig,
                  scalars: DerivedScalars, max_iter: int, stride: int,
                  timer=None, recorder=None) -> IterateOut:
    """The full iterate() pipeline on the device of ``image`` (uint8
    [H, W, 3] tensor; ``st`` holds tensors on the same device).  ``timer``
    (utils.timing.Timer) gets one section per phase when given;
    ``recorder`` takes the loop's snapshots (debug_mode)."""
    timer = timer or Timer(None)
    with timer.scope("cielab_conversion"):
        setup = stage_setup(image, st, cfg, scalars)
    return iterate_from_setup(setup, cfg, scalars, max_iter, stride, timer,
                              recorder=recorder)


def iterate_from_setup(setup, cfg: StaticConfig, scalars: DerivedScalars,
                       max_iter: int, stride: int, timer, profile=False,
                       recorder=None) -> IterateOut:
    """The pipeline after :func:`stage_setup` (its result ``setup``): an
    ``iteration_loop`` section, or with ``profile`` the loop's own
    sections (:func:`stage_loop`), then ``full_assign`` and
    ``enforce_connectivity``."""
    planes, st, lsc_state = setup
    activity = (torch.empty((max_iter, 2), dtype=torch.int32,
                            device=planes.device)
                if cfg.preemptive else None)
    if profile:
        loop = stage_loop(planes, st, lsc_state, cfg, scalars, max_iter,
                          stride, timer, recorder, activity)
    else:
        with timer.scope("iteration_loop"):
            loop = stage_loop(planes, st, lsc_state, cfg, scalars, max_iter,
                              stride, recorder=recorder, activity=activity)
    st, assignment, cent, overflow = loop
    with timer.scope("full_assign"):
        st, assignment, min_dists, overflow = stage_full_assign(
            planes, st, lsc_state, cent, assignment, cfg, scalars, overflow)
    with timer.scope("enforce_connectivity"):
        labels, cca_tie = stage_cca(assignment, cfg, scalars)
    return IterateOut(labels, st, min_dists, assignment, cca_tie, overflow,
                      activity)
