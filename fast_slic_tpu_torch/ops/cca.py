"""Connectivity enforcement (CCA) on the device.

The counterpart of ``fast_slic_tpu/ops/cca.py`` (lines 133-442), with the
JAX package's non-TPU branches as the design:

1. components: every 4-connected equal-label region gets the minimum linear
   index of its pixels (``kernels.cca.connected_components``); UNASSIGNED
   is a label of its own.
2. components are numbered by leader order: an exclusive prefix count of
   the leader pixels, spread to every pixel by a lookup ``rank[L]``.
3. areas and orphan-adoption targets in one segment sum.
4. the selection (cca.cpp:212-254), one kernel a call on the card
   (``kernels.cca.cca_select``, a block a frame): area threshold, top-K by
   area (a radix select of the K-th largest area; the plain version's
   binary search on the area value finds the same), renumbering of the
   kept components in leader order, and orphan adoption -- a dropped
   component takes the label of its leader's left (or, at column 0, upper)
   neighbour, resolved over the component DAG by a chase.

:func:`enforce_connectivity_framed_flagged` does the same for B stacked
frames in one pass (the stacked batch mode), each frame as if alone.

The component bins are sized at the pixel count n (not at the JAX
package's ``effective_max_components``, a TPU memory device: 11 MB of bins
at 720p on the card), so the component-overflow case of the JAX package
cannot arise and only a top-K boundary-area tie raises the flag.  The tie
escalation (:func:`selection_rerun_device`) runs the sequential selection
of the reference on the host and relabels on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import UNASSIGNED
from ..kernels.cca import cca_select, connected_components, lookup
from ..kernels.segsum import framed_segment_sum, segment_sum
from ..utils.timing import span, spanned, to_device, to_host


def leader_ranks(L):
    """Component ids [n] (min linear index) -> (is_leader bool [n], exclusive
    leader rank int32 [n], num_components int64 0-d tensor)."""
    is_leader = L == torch.arange(L.shape[0], dtype=torch.int32,
                                  device=L.device)
    il = is_leader.to(torch.int32)
    incl = torch.cumsum(il, 0, dtype=torch.int32)
    return is_leader, incl - il, incl[-1].to(torch.int64)


def segsum_values(comp, is_leader):
    """int32 [2, ...] values of the area / orphan-target segment sum for
    component ids ``comp`` [..., H, W] and ``is_leader`` of the same pixels
    in any shape: 1 per pixel, and at each leader the component of its left
    neighbour (up at column 0; 0 at the frame's pixel (0, 0)), the adoption
    target of cca.cpp:240-254."""
    donor = torch.zeros_like(comp)
    donor[..., :, 1:] = comp[..., :, :-1]
    donor[..., 1:, 0] = comp[..., :-1, 0]
    return torch.stack([torch.ones_like(is_leader, dtype=torch.int32),
                        torch.where(is_leader, donor.reshape(is_leader.shape),
                                    0)])


@spanned("cca.components")
def cca_parts(assignment):
    """Components, areas and orphan targets: [H, W] int32 labels ->
    (comp_flat int32 [n] per-pixel component ids, areas int32 [n], orphan
    target int32 [n], num_components int64 0-d tensor).  Entries from
    num_components on are empty bins.  Also the device half of the
    selection-only tie re-run; comp_flat stays on the device for
    :func:`cca_relabel`."""
    H, W = assignment.shape
    n = H * W
    L = connected_components(assignment.contiguous()).reshape(-1)
    is_leader, rank, num_components = leader_ranks(L)
    comp2 = lookup(L, rank).reshape(H, W)
    comp_flat = comp2.reshape(-1)
    acc = segment_sum(comp_flat, segsum_values(comp2, is_leader), n)
    return comp_flat, acc[0, :n], acc[1, :n], num_components


@spanned("cca.select")
def _substitutes(areas, target, num_components, K: int, min_threshold: int,
                 n_pixels=None):
    """The selection and orphan adoption of cca.cpp:212-254
    (:func:`kernels.cca.cca_select`: one launch on the card, no wait on the
    host).  Returns (substitute int32 of the tables' shape, boundary-tie
    flag per frame)."""
    return cca_select(areas, target, num_components, K, min_threshold,
                      n_pixels)


def enforce_connectivity_flagged(assignment, K: int, min_threshold: int):
    """ConnectivityEnforcer::execute (cca.cpp:178-265).

    assignment: int32 [H, W] (UNASSIGNED is a label of its own).  Returns
    (relabeled int32 [H, W], bool 0-d tensor: the component areas tie at the
    top-K boundary, where the reference's std::partial_sort decides the
    survivors; see :func:`selection_rerun_device`)."""
    H, W = assignment.shape
    comp_flat, areas, target, num_components = cca_parts(assignment)
    substitute, boundary_tie = _substitutes(areas, target, num_components, K,
                                            min_threshold)
    with span("cca.relabel"):
        return lookup(comp_flat, substitute).reshape(H, W), boundary_tie


def enforce_connectivity_exact(assignment, K: int, min_threshold: int):
    """:func:`enforce_connectivity_flagged`, escalated on a tie to
    :func:`selection_rerun_device`: the reference's labels exactly,
    ``std::partial_sort`` ties included.  Returns (labels int32 [H, W],
    whether the escalation ran)."""
    labels, tie = enforce_connectivity_flagged(assignment, K, min_threshold)
    if to_host(tie, bool):
        return selection_rerun_device(assignment, K, min_threshold), True
    return labels, False


def framed_labels(assignment, K: int):
    """int32 [B, H, W] frame-local labels -> the int32 [B*H, W] stack that
    one connected-components launch takes: frame f's labels become f*K + k
    and its UNASSIGNED pixels 0x10000 + f, so no region joins across a
    frame boundary."""
    B, H, W = assignment.shape
    fid = torch.arange(B, dtype=torch.int32,
                       device=assignment.device)[:, None, None]
    labels = torch.where(assignment == UNASSIGNED, 0x10000 + fid,
                         assignment + fid * K).to(torch.int32)
    return labels.reshape(B * H, W)


def framed_components(assignment, K: int):
    """Components of B stacked frames in one pass over the [B*H, W] stack
    of :func:`framed_labels`: int32 [B, H, W] frame-local labels -> (comp
    int32 [B, H, W] frame-local component ids in leader order, is_leader
    bool [B, H*W]).

    One connected-components launch over the stack gives each frame its
    standalone components, and a frame's pixel (0, 0) leads its first
    component.  The frame's leader ranks are the global exclusive count
    minus its value at that pixel."""
    B, H, W = assignment.shape
    L = connected_components(framed_labels(assignment, K)).reshape(-1)
    is_leader, rank, _ = leader_ranks(L)
    rank = rank.reshape(B, H * W)
    comp = lookup(L, (rank - rank[:, :1]).reshape(-1)).reshape(B, H, W)
    return comp, is_leader.reshape(B, H * W)


@spanned("cca.components")
def framed_cca_parts(assignment, K: int):
    """:func:`cca_parts` for B stacked frames: int32 [B, H, W] frame-local
    labels -> (comp int32 [B, H, W], areas int32 [B, n], orphan target
    int32 [B, n], num_components int64 [B]), n = H*W per frame and every
    id frame-local; one :func:`framed_segment_sum` for all frames."""
    B, H, W = assignment.shape
    n = H * W
    comp, is_leader = framed_components(assignment, K)
    acc = framed_segment_sum(comp.reshape(B, n),
                             segsum_values(comp, is_leader), n)
    return comp, acc[:, 0], acc[:, 1], is_leader.sum(1)


def enforce_connectivity_framed_flagged(assignment, K: int,
                                        min_threshold: int):
    """:func:`enforce_connectivity_flagged` for B stacked frames
    (assignment int32 [B, H, W], frame-local labels in [0, K) or
    UNASSIGNED): the frame-aware CCA of the stacked batch mode
    (fast_slic_tpu/ops/cca.py:445-662 with pitch == frame_h).  Each frame
    is thresholded, top-K selected and renumbered as if alone.  Returns
    (labels int32 [B, H, W], tie flags bool [B]).

    UNASSIGNED regions of two frames never merge (each frame has its own
    sentinel, :func:`framed_cca_parts`) and the component tables have a
    bin for every pixel of the frame, so every frame equals its standalone
    result: the JAX package's unassigned and overflow flags, which send a
    frame to the host there, cannot arise, and only a top-K boundary tie
    flags a frame."""
    B, H, W = assignment.shape
    n = H * W
    comp, areas, target, num_components = framed_cca_parts(assignment, K)
    substitute, boundary_tie = _substitutes(areas, target, num_components, K,
                                            min_threshold)
    with span("cca.relabel"):
        base = torch.arange(B, dtype=torch.int32, device=comp.device) * n
        ids = (comp + base[:, None, None]).reshape(-1)
        return (lookup(ids, substitute.reshape(-1)).reshape(B, H, W),
                boundary_tie)


def cca_relabel(comp_flat, substitute, shape):
    """labels = substitute[comp_flat] through the lookup kernel."""
    with span("cca.relabel"):
        return lookup(comp_flat, substitute).reshape(shape)


def selection_rerun_device(raw, K: int, thres: int):
    """Exact tie escalation: the device recomputes components, areas and
    targets; the host runs the reference's sequential selection
    (:func:`substitutes_np`) on the small per-component arrays; the device
    relabels.  Returns int32 [H, W] labels on the device of ``raw``."""
    comp_flat, areas, target, ncomp_t = cca_parts(raw)
    ncomp = to_host(ncomp_t, int)
    sub = substitutes_np(to_host(areas[:ncomp]).numpy(),
                         to_host(target[:ncomp]).numpy(), ncomp, K, thres)
    sub_t = to_device(torch.from_numpy(sub), raw.device)
    return cca_relabel(comp_flat, sub_t, tuple(raw.shape))


def substitutes_np(areas, target, num_components: int, K: int,
                   min_threshold: int):
    """EXACT host selection of ConnectivityEnforcer::execute
    (cca.cpp:212-264) from per-component arrays: area threshold, the
    libstdc++ partial_sort survivor set, leader-order renumbering, the
    component-0 rule and orphan adoption through the target DAG."""
    nc = int(num_components)
    areas = np.asarray(areas)[:nc]
    target = np.asarray(target)[:nc]
    substitute = np.full([nc], UNASSIGNED, np.int64)
    comps = np.nonzero(areas >= min_threshold)[0]
    if comps.size > K:
        comps = np.sort(heap_select_topk(comps.tolist(), areas, K))
    substitute[comps] = np.arange(comps.size)
    if nc > 0 and substitute[0] == UNASSIGNED:
        substitute[0] = 0
    # ascending resolution: a donor's leader pixel precedes this leader, so
    # its component id is smaller and already resolved (cca.cpp:240-254)
    for c in range(nc):
        if substitute[c] != UNASSIGNED:
            continue
        subs = substitute[target[c]]
        substitute[c] = 0 if subs == UNASSIGNED else subs
    return substitute.astype(np.int32)


def heap_select_topk(seq, areas, K):
    """The exact element set std::partial_sort keeps (libstdc++
    heap_select), as in fast_slic_tpu/oracle/numpy_ref.py:303: a heap over
    the first K elements, whose top is replaced whenever a later element
    compares strictly better (``comp(a, b)`` is areas[a] > areas[b])."""

    def comp(a, b):
        return areas[a] > areas[b]

    def push_heap(h, hole, top, value):
        parent = (hole - 1) // 2
        while hole > top and comp(h[parent], value):
            h[hole] = h[parent]
            hole = parent
            parent = (hole - 1) // 2
        h[hole] = value

    def adjust_heap(h, hole, length, value):
        top = hole
        second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if comp(h[second], h[second - 1]):
                second -= 1
            h[hole] = h[second]
            hole = second
        if (length & 1) == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            h[hole] = h[second - 1]
            hole = second - 1
        push_heap(h, hole, top, value)

    h = list(seq[:K])
    if K >= 2:
        parent = (K - 2) // 2
        while True:
            value = h[parent]
            adjust_heap(h, parent, K, value)
            if parent == 0:
                break
            parent -= 1
    for x in seq[K:]:
        if comp(x, h[0]):
            adjust_heap(h, 0, K, x)
    return h
