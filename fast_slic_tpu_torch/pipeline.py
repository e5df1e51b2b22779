"""The SLIC pipeline in PyTorch: setup, the assign/update loop, the full
assign and connectivity enforcement.

The counterpart of ``fast_slic_tpu/pipeline.py`` for the standard
(quantized) variant.  Plain tensor code stays torch; the per-pixel work goes
through the kernel wrappers of :mod:`fast_slic_tpu_torch.kernels`, which
take the plain PyTorch version on a CPU tensor and the CUDA kernel on a
CUDA tensor.

The loop keeps ONE full-resolution int32 [H, W] assignment.  Iteration i
writes only the rows r with r % stride == i % stride, and the update reads
only those rows: the semantics of the JAX package's scan loop
(``pipeline.py:1018-1070``), which its tests pin as bit-identical to the
TPU loop.  The TPU loop layout (per-remainder resident planes, 64-row and
128-lane padding) is not carried over.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .cluster import Clusters
from .config import UNASSIGNED, StaticConfig
from .kernels.assign import assign
from .kernels.lab import rgb_to_lab_planar
from .kernels.segsum import slic_update
from .ops.cca import enforce_connectivity_flagged
from .utils.timing import Timer

_PREEMPTIVE_COOLDOWN = 2  # preemptive.h:32


class IterateOut(NamedTuple):
    labels: torch.Tensor          # int32 [H, W], -1 = unassigned
    clusters: Clusters            # final centroid state (tensors)
    min_dists: torch.Tensor       # int32 [H, W], last full-assign distances
    raw_assignment: torch.Tensor  # pre-CCA assignment (int32, 0xFFFF ok)
    cca_tie: torch.Tensor         # bool: top-K boundary tie, escalate
    cand_overflow: torch.Tensor   # bool: re-run with more cand_slots


class DerivedScalars(NamedTuple):
    """Scalars derived on the host with the exact float ops of the
    reference C code (see fast_slic_tpu.pipeline.DerivedScalars): coef
    reaches the assign kernel as this exact float32."""

    coef: np.float32       # spatial coefficient (context.cpp:24-25)
    thres: np.int32        # CCA area threshold (context.cpp:16)


def derive_scalars(cfg: StaticConfig, compactness,
                   min_size_factor) -> DerivedScalars:
    S = cfg.S
    color_shift = 1 if cfg.convert_to_lab else 0
    c = np.float32(compactness)
    coef = (np.float32(1.0) / (np.float32(S) / c)) * np.float32(1 << color_shift)
    # (int)round((double)(S*S) * (double)msf): half away from zero
    thres = np.int32(math.floor(float(S * S) * float(min_size_factor) + 0.5))
    return DerivedScalars(coef, thres)


def cell_grid_shape(cfg: StaticConfig):
    S = cfg.S
    return -(-cfg.H // S), -(-cfg.W // S)


def visit_order_key(y, x, cfg: StaticConfig):
    """Per-cluster visit rank phase*K + k reproducing the reference's
    4-phase checkerboard assignment order (context.cpp:214-242); see
    fast_slic_tpu.pipeline.visit_order_key."""
    S, K = cfg.S, cfg.K
    T = 2 * S + 32
    ci = y.to(torch.int64) // T
    cj = x.to(torch.int64) // T
    phase = 2 * (ci % 2) + (cj % 2)
    return phase * K + torch.arange(K, device=y.device)


def build_candidates(y, x, is_active, cfg: StaticConfig):
    """Per-cell candidate lists: for every S-cell, the active clusters whose
    centre lies in its 3x3 cell neighbourhood, in visit order.  Returns
    (int32 [GH, GW, cand_slots], -1 = empty slot; bool overflow flag: some
    cell has more than cand_slots candidates).

    Each cluster is replicated into its up to 9 cells, the (cell, visit key)
    pairs are sorted as one composite key cell*4K + key, and the rank inside
    each run of one cell gives the slot (fast_slic_tpu/pipeline.py:98-184).
    """
    GH, GW = cell_grid_shape(cfg)
    S, K = cfg.S, cfg.K
    C = cfg.cand_slots
    num_cells = GH * GW
    dev = y.device

    ci = torch.clamp(y.to(torch.int64) // S, 0, GH - 1)
    cj = torch.clamp(x.to(torch.int64) // S, 0, GW - 1)
    key = visit_order_key(y, x, cfg)

    d = torch.tensor([-1, 0, 1], device=dev)
    di9 = d.repeat_interleave(3)[:, None]
    dj9 = d.repeat(3)[:, None]
    ni = ci[None, :] + di9                               # [9, K]
    nj = cj[None, :] + dj9
    ok = ((is_active != 0)[None, :] & (ni >= 0) & (ni < GH)
          & (nj >= 0) & (nj < GW))
    cell9 = torch.where(ok, ni * GW + nj, num_cells).reshape(-1)
    key9 = key[None, :].expand(9, K).reshape(-1)

    span = 4 * K
    comp_key, _ = torch.sort(cell9 * span + key9)
    sc = comp_key // span
    okey = comp_key % span
    M = sc.shape[0]
    iota = torch.arange(M, device=dev)
    run_start = torch.ones(M, dtype=torch.bool, device=dev)
    run_start[1:] = sc[1:] != sc[:-1]
    rank = iota - torch.cummax(torch.where(run_start, iota, 0), 0).values

    valid = sc < num_cells
    kept = valid & (rank < C)
    overflow = torch.any(valid & (rank >= C))
    target = torch.where(kept, sc * C + rank, num_cells * C)
    ckey = torch.full((num_cells * C + 1,), 2 ** 30, dtype=torch.int64,
                      device=dev)
    ckey[target[kept]] = okey[kept]
    ckey = ckey[:-1].reshape(GH, GW, C)
    cand = torch.where(ckey < 2 ** 30, ckey % K, -1).to(torch.int32)
    return cand, overflow


def _clamp_centers(st: Clusters, cfg: StaticConfig) -> Clusters:
    """Safeguard clamp at the top of assign() (context.cpp:209-212)."""
    return st.replace(y=torch.clamp(st.y, 0.0, cfg.H - 1),
                      x=torch.clamp(st.x, 0.0, cfg.W - 1))


def center_table(st: Clusters) -> torch.Tensor:
    """f32 [K, 5] (y, x, r, g, b), the table the assign kernel reads."""
    return torch.stack([st.y, st.x, st.r, st.g, st.b], dim=1).contiguous()


def update_apply_means_rows(counts, sums, st: Clusters,
                            cfg: StaticConfig) -> Clusters:
    """Centroid round_int means for updatable clusters from counts [K] and
    sums [5, K] ordered (i, j, L, a, b) (context.cpp:356-387)."""
    upd = st.is_updatable != 0
    num_members = torch.where(upd, counts.to(torch.int64), st.num_members)
    safe = torch.clamp(counts, min=1)
    means = ((sums + (safe // 2)[None, :]) // safe[None, :]).to(torch.float32)
    sel = upd & (counts > 0)
    return st.replace(
        y=torch.where(sel, means[0], st.y),
        x=torch.where(sel, means[1], st.x),
        r=torch.where(sel, means[2], st.r),
        g=torch.where(sel, means[3], st.g),
        b=torch.where(sel, means[4], st.b),
        num_members=num_members,
    )


def stage_setup(image, st: Clusters, cfg: StaticConfig):
    """CIELAB conversion and the cluster colour re-seed
    (context.cpp:114-157).  image: uint8 [H, W, 3] tensor.  Returns
    (planes int32 [3, H, W], clusters)."""
    H, W, K = cfg.H, cfg.W, cfg.K
    if cfg.convert_to_lab:
        planes = rgb_to_lab_planar(image)
    else:
        planes = image.permute(2, 0, 1).to(torch.int32).contiguous()
    cyi = torch.clamp(st.y.to(torch.int64), 0, H - 1)
    cxi = torch.clamp(st.x.to(torch.int64), 0, W - 1)
    seed = planes.reshape(3, -1)[:, cyi * W + cxi].to(torch.float32)
    # preemptive_grid.initialize (preemptive.h:59-67) runs regardless of the
    # `preemptive` flag: every cluster's cooldown is reset
    st = st.replace(r=seed[0], g=seed[1], b=seed[2],
                    is_updatable=torch.full((K,), _PREEMPTIVE_COOLDOWN,
                                            dtype=torch.int32,
                                            device=planes.device))
    return planes, st


def stage_loop(planes, st: Clusters, cfg: StaticConfig,
               scalars: DerivedScalars, max_iter: int, stride: int):
    """max_iter x (assign, update) with row subsampling and a rotating
    remainder (context.cpp:158-175).  Returns (clusters, assignment,
    candidate overflow flag)."""
    dev = planes.device
    assignment = torch.full((cfg.H, cfg.W), UNASSIGNED, dtype=torch.int32,
                            device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(max_iter):
        rem = i % stride
        st = _clamp_centers(st, cfg)
        cand, cov = build_candidates(st.y, st.x, st.is_active, cfg)
        overflow = overflow | cov
        assign(planes, center_table(st), cand, assignment, scalars.coef,
               cfg.S, stride, rem, cfg.manhattan_spatial_dist)
        # per-cluster (count, i, j, L, a, b) over the rows just assigned
        acc = slic_update(assignment, planes, cfg.K, stride, rem)
        st = update_apply_means_rows(acc[0], acc[1:], st, cfg)
    return st, assignment, overflow


def stage_full_assign(planes, st: Clusters, assignment, cfg: StaticConfig,
                      scalars: DerivedScalars):
    """Preemptive finalize and full_assign at stride 1
    (context.cpp:176-181).  Updates ``assignment`` in place; returns
    (clusters, assignment, min_dists, candidate overflow flag)."""
    st = st.replace(is_active=torch.ones_like(st.is_active))
    st = _clamp_centers(st, cfg)
    cand, cov = build_candidates(st.y, st.x, st.is_active, cfg)
    min_dists = torch.empty_like(assignment)
    assign(planes, center_table(st), cand, assignment, scalars.coef, cfg.S,
           1, 0, cfg.manhattan_spatial_dist, min_dists=min_dists)
    return st, assignment, min_dists, cov


def stage_cca(assignment, cfg: StaticConfig, scalars: DerivedScalars):
    """enforce_connectivity (context.cpp:15-20, cca.cpp:178-265): returns
    (labels int32 [H, W] with -1 for unassigned, tie flag)."""
    labels, cca_tie = enforce_connectivity_flagged(assignment, cfg.K,
                                                   int(scalars.thres))
    return torch.where(labels == UNASSIGNED, -1, labels), cca_tie


def iterate_graph(image, st: Clusters, cfg: StaticConfig,
                  scalars: DerivedScalars, max_iter: int, stride: int,
                  timer=None) -> IterateOut:
    """The full iterate() pipeline on the device of ``image`` (uint8
    [H, W, 3] tensor; ``st`` holds tensors on the same device).  ``timer``
    (utils.timing.Timer) gets one section per phase when given."""
    timer = timer or Timer(None)
    with timer.scope("cielab_conversion"):
        planes, st = stage_setup(image, st, cfg)
    with timer.scope("iteration_loop"):
        st, assignment, overflow = stage_loop(planes, st, cfg, scalars,
                                              max_iter, stride)
    with timer.scope("full_assign"):
        st, assignment, min_dists, cov = stage_full_assign(
            planes, st, assignment, cfg, scalars)
    with timer.scope("enforce_connectivity"):
        labels, cca_tie = stage_cca(assignment, cfg, scalars)
    return IterateOut(labels, st, min_dists, assignment, cca_tie,
                      overflow | cov)
