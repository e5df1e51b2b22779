"""Wrappers of the CCA kernels (``csrc/cca.cu``): connected components,
which replaces ``fast_slic_tpu/pallas/cca_tpu.py:_cc_pass_kernel``; the
minimum of any seed over each of those components, which replaces the
same kernel as ``propagate_min_pallas`` calls it, per pixel
(``propagate_min``) or kept per component in a table indexed by the
component's root (``region_table``), and that table lowered across one
seam row of a sharded image (``seam_min``); the table lookup, which
replaces ``fast_slic_tpu/pallas/segsum_tpu.py:_lookup_kernel``; and the
component selection with its orphan adoption (``cca_select``), which
replaces the XLA ops of ``fast_slic_tpu/ops/cca.py:308-398`` (the top-K
binary search, the renumbering and the chase of lookups).

The plain PyTorch versions are the JAX package's non-TPU branches:
neighbour-min sweeps with pointer jumping
(``fast_slic_tpu/ops/cca.py:connected_components``), segment minima, a
gather, and the selection's binary search, cumsums and pointer doubling.
A CPU tensor goes to them; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import math

import torch

from ..config import UNASSIGNED
from . import _lib

__all__ = ["cca_select", "cca_select_plain", "connected_components",
           "connected_components_plain", "lookup", "lookup_plain",
           "orphan_tables", "propagate_min", "propagate_min_plain",
           "region_table", "region_table_plain", "resolve_orphans_plain",
           "seam_min", "seam_min_plain"]

_BIG = 0x7FFFFFFF


def _neighbor_min(L, labels):
    """Min over self and the 4-neighbours with an equal label."""
    out = L.clone()
    # (neighbour slice, own slice) pairs for up, down, left, right
    for src, dst in (((slice(None, -1), slice(None)), (slice(1, None), slice(None))),
                     ((slice(1, None), slice(None)), (slice(None, -1), slice(None))),
                     ((slice(None), slice(None, -1)), (slice(None), slice(1, None))),
                     ((slice(None), slice(1, None)), (slice(None), slice(None, -1)))):
        eq = labels[src] == labels[dst]
        cand = torch.where(eq, L[src], _BIG)
        out[dst] = torch.minimum(out[dst], cand)
    return out


def connected_components_plain(labels):
    """[H, W] int32 labels -> [H, W] int32 component ids, each the minimum
    linear pixel index of its 4-connected equal-label region."""
    H, W = labels.shape
    f = torch.arange(H * W, dtype=torch.int64, device=labels.device)
    # Invariant: f[p] is a pixel of p's region with f[p] <= p.  Each round
    # hooks every root f[p] under the smallest id among p's equal-label
    # neighbours, then jumps pointers until every f[p] is a root; a round
    # that changes nothing leaves each region pointing at its minimum.
    while True:
        m = _neighbor_min(f.reshape(H, W), labels).reshape(-1)
        g = f.clone().scatter_reduce_(0, f, m, "amin")
        while True:
            h = g[g]
            if torch.equal(h, g):
                break
            g = h
        if torch.equal(g, f):
            return f.reshape(H, W).to(torch.int32)
        f = g


def connected_components(labels):
    """Dispatch connected components by device; see
    :func:`connected_components_plain`."""
    if labels.ndim != 2:
        raise ValueError("labels must be [H, W]")
    dev = labels.device
    if dev.type == "cpu":
        return connected_components_plain(labels)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    _lib.check(labels, "labels", torch.int32, dev)
    H, W = labels.shape
    out = torch.empty((H, W), dtype=torch.int32, device=dev)
    _lib.launch("fstt_cc", dev, labels.data_ptr(), out.data_ptr(), H, W)
    return out


def propagate_min_plain(m0, roots):
    """int32 seed m0 [H, W] and the regions' roots [H, W] (the
    :func:`connected_components` of the labels) -> [H, W] int32: each pixel
    gets the minimum of m0 over its 4-connected equal-label region."""
    r = roots.reshape(-1).long()
    m = m0.reshape(-1)
    return m.clone().scatter_reduce_(0, r, m, "amin")[r].reshape(m0.shape)


def propagate_min(m0, roots):
    """Dispatch the region minimum by device; see
    :func:`propagate_min_plain`.  On the card one call is the region
    table's two kernels (:func:`region_table`) and the lookup
    ``table[roots]``, in one C call."""
    if m0.ndim != 2 or roots.shape != m0.shape:
        raise ValueError("m0 and roots must be [H, W]")
    dev = m0.device
    if dev.type == "cpu":
        return propagate_min_plain(m0, roots)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    _lib.check(m0, "m0", torch.int32, dev)
    _lib.check(roots, "roots", torch.int32, dev)
    table = torch.empty(m0.numel(), dtype=torch.int32, device=dev)
    out = torch.empty_like(m0)
    _lib.launch("fstt_propagate_min", dev, m0.data_ptr(), roots.data_ptr(),
                table.data_ptr(), out.data_ptr(), m0.numel())
    return out


def region_table_plain(m0, roots):
    """int32 seed m0 and the regions' roots (:func:`connected_components`
    of the labels), both [H, W] -> int32 [H*W] table: slot r holds the
    minimum of m0 over the region whose root is pixel r; every slot that
    is no root holds 0x7FFFFFFF."""
    m = m0.reshape(-1)
    return torch.full_like(m, _BIG).scatter_reduce_(
        0, roots.reshape(-1).long(), m, "amin")


def region_table(m0, roots):
    """Dispatch the region table by device; see :func:`region_table_plain`.
    On the card one call is two kernels: a fill and one atomic-min pass."""
    if m0.ndim != 2 or roots.shape != m0.shape:
        raise ValueError("m0 and roots must be [H, W]")
    dev = m0.device
    if dev.type == "cpu":
        return region_table_plain(m0, roots)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    _lib.check(m0, "m0", torch.int32, dev)
    _lib.check(roots, "roots", torch.int32, dev)
    table = torch.empty(m0.numel(), dtype=torch.int32, device=dev)
    _lib.launch("fstt_region_table", dev, m0.data_ptr(), roots.data_ptr(),
                table.data_ptr(), m0.numel())
    return table


def seam_min_plain(table, roots_row, lab_row, lab_nb, val_nb, changed,
                   stamp: int):
    """One seam of a sharded image, in place: for each pixel x of a slab's
    edge row whose label ``lab_row[x]`` equals the label across the seam
    ``lab_nb[x]``, the slot ``table[roots_row[x]]`` takes the minimum with
    the neighbour's value ``val_nb[x]``.  ``changed`` (int32, one element)
    is set to ``stamp`` if a slot went down, and left as it is otherwise.
    Rows: int32 [W]; table: int32 [n], indexed by the slab's roots."""
    r = roots_row.long()
    v = torch.where(lab_row == lab_nb, val_nb, _BIG)
    lowered = torch.any(v < table[r])
    table.scatter_reduce_(0, r, v, "amin")
    changed.masked_fill_(lowered, stamp)


def seam_min(table, roots_row, lab_row, lab_nb, val_nb, changed,
             stamp: int):
    """Dispatch one seam's minimum by device; see :func:`seam_min_plain`.
    On the card one launch, a thread a pixel of the row."""
    if table.ndim != 1 or roots_row.ndim != 1 or any(
            t.shape != roots_row.shape for t in (lab_row, lab_nb, val_nb)):
        raise ValueError("table and the four rows must be 1-D, the rows "
                         "of one length")
    if changed.numel() != 1:
        raise ValueError("changed must hold one int32")
    dev = table.device
    if dev.type == "cpu":
        return seam_min_plain(table, roots_row, lab_row, lab_nb, val_nb,
                              changed, stamp)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    for t, name in ((table, "table"), (roots_row, "roots_row"),
                    (lab_row, "lab_row"), (lab_nb, "lab_nb"),
                    (val_nb, "val_nb"), (changed, "changed")):
        _lib.check(t, name, torch.int32, dev)
    _lib.launch("fstt_seam_min", dev, table.data_ptr(), roots_row.data_ptr(),
                lab_row.data_ptr(), lab_nb.data_ptr(), val_nb.data_ptr(),
                changed.data_ptr(), int(stamp), roots_row.shape[0],
                table.shape[0])


def lookup_plain(ids, table):
    """out[i] = table[ids[i]]: int32 ids of any shape, int32 table [M]."""
    return table[ids.long()]


def lookup(ids, table):
    """Dispatch the table lookup by device; see :func:`lookup_plain`."""
    if table.ndim != 1:
        raise ValueError("table must be 1-D")
    if not ids.is_cuda:
        if ids.device.type == "cpu":
            return lookup_plain(ids, table)
        raise ValueError("unsupported device %s" % ids.device)
    dev = ids.device
    _lib.check(ids, "ids", torch.int32, dev)
    _lib.check(table, "table", torch.int32, dev)
    out = torch.empty_like(ids)
    _lib.launch("fstt_lookup", dev, ids.data_ptr(), table.data_ptr(),
                out.data_ptr(), ids.numel(), table.shape[0])
    return out


def resolve_orphans_plain(substitute, target):
    """Orphan adoption (cca.cpp:240-254) on int32 tables [n]: each
    UNASSIGNED entry takes the substitute of its target, by pointer doubling
    to the fixpoint (any chain within the table resolves); an entry whose
    chain never reaches an assigned one gets 0."""
    n = substitute.shape[0]
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        if not bool(torch.any(substitute == UNASSIGNED)):
            break
        substitute = torch.where(substitute == UNASSIGNED,
                                 lookup_plain(target, substitute), substitute)
        target = lookup_plain(target, target)
    return torch.where(substitute == UNASSIGNED, 0, substitute)


def _cumsum_last(x, dtype):
    """Inclusive cumsum along the last axis of one frame [n] or B frames
    [B, n], as one scan over the flattened tensor minus each frame's total
    before it."""
    flat = torch.cumsum(x.reshape(-1), 0, dtype=dtype).reshape(x.shape)
    if x.ndim == 1:
        return flat
    return flat - (flat[..., :1] - x[..., :1].to(dtype))


def _topk_keep(areas, kept_pre, k: int, n: int):
    """The top-k-by-area subset of kept_pre along the last axis (one frame
    [n] or B frames [B, n]), ties at the boundary broken by component
    order; and the boundary-tie flag per frame.  The k-th largest area T
    is the least T in [0, n] with fewer than k areas of kept_pre above it,
    found as the JAX package finds it, by a binary search on the value
    range (the card's kernel finds the same T by a radix select)."""
    def cnt_gt(T):
        return torch.sum(kept_pre & (areas > T[..., None]), -1)

    lead = areas.shape[:-1]
    lo = torch.zeros(lead, dtype=torch.int64, device=areas.device)
    hi = torch.full(lead, n, dtype=torch.int64, device=areas.device)
    for _ in range(max(1, math.ceil(math.log2(max(n + 1, 2))))):
        mid = (lo + hi) // 2
        p = cnt_gt(mid) < k
        lo, hi = torch.where(p, lo, mid + 1), torch.where(p, mid, hi)
    T = lo
    fill = k - cnt_gt(T)
    eq = kept_pre & (areas == T[..., None])
    eq_rank = _cumsum_last(eq, torch.int64)             # inclusive
    kept = ((kept_pre & (areas > T[..., None]))
            | (eq & (eq_rank <= fill[..., None])))
    count_pre = torch.sum(kept_pre, -1)
    boundary_tie = (count_pre > k) & (fill < torch.sum(eq, -1))
    return kept, boundary_tie


def orphan_tables(areas, target, num_components, K: int,
                  min_threshold: int, n_pixels=None):
    """The selection of cca.cpp:212-238 on the component tables of one
    frame ([n]) or B frames ([B, n]; frame-local ids): area threshold,
    top-K by area, renumbering in leader order and the "component 0 always
    gets a label" rule (cca.cpp:238).  Returns the tables of the orphan
    chase, flattened over the frames -- substitute int32 [B*n] (UNASSIGNED
    for a dropped component) and target int32 [B*n] (pointers into the
    flattened tables) -- and the boundary-tie flag per frame.
    ``n_pixels`` (default n): the frame's pixel count, the largest area,
    where the tables hold fewer bins than pixels (the row-sharded CCA
    sizes them by the component count)."""
    n = areas.shape[-1]
    n_pixels = n if n_pixels is None else n_pixels
    dev = areas.device
    citoa = torch.arange(n, dtype=torch.int32, device=dev)
    valid_comp = citoa < num_components[..., None]
    kept_pre = valid_comp & (areas >= min_threshold)
    kept, boundary_tie = _topk_keep(areas, kept_pre, min(K, n_pixels),
                                    n_pixels)

    substitute = torch.where(
        kept, _cumsum_last(kept, torch.int32) - 1,
        UNASSIGNED).to(torch.int32)
    substitute[..., 0] = torch.where(kept[..., 0], substitute[..., 0], 0)
    # empty bins beyond num_components are parked at 0 (never read)
    substitute = torch.where(valid_comp, substitute, 0).to(torch.int32)

    # targets strictly decrease in leader order and component 0 is always
    # labelled, so every chain ends inside its frame; empty bins point at
    # themselves.  Pointers index the flattened tables (frame f from f*n).
    target = torch.where(citoa == 0, 0, target)
    target = torch.where(valid_comp, target, citoa)
    base = torch.arange(areas.numel() // max(n, 1), dtype=torch.int32,
                        device=dev).reshape(areas.shape[:-1] + (1,)) * n
    return (substitute.reshape(-1),
            (target + base).reshape(-1).to(torch.int32), boundary_tie)


def cca_select_plain(areas, target, num_components, K: int,
                     min_threshold: int, n_pixels=None):
    """The selection (:func:`orphan_tables`) and the orphan adoption
    (cca.cpp:240-254, :func:`resolve_orphans_plain`) of one frame's
    component tables ([n]) or B frames' ([B, n]): int32 areas and adoption
    targets (frame-local ids, each below its own entry), num_components
    int64 (0-d or [B]).  Returns (substitute int32 of the tables' shape:
    each component's final label, 0 in the bins from num_components on;
    the boundary-tie flag, bool, one a frame)."""
    substitute, pointers, boundary_tie = orphan_tables(
        areas, target, num_components, K, min_threshold, n_pixels)
    return (resolve_orphans_plain(substitute, pointers).reshape(areas.shape),
            boundary_tie)


def cca_select(areas, target, num_components, K: int, min_threshold: int,
               n_pixels=None):
    """Dispatch the selection and orphan adoption by device; see
    :func:`cca_select_plain`.  On the card one launch, a block a frame
    (grid sized by the frames and the bins, the component counts read on
    the device), and nothing waits on the host.  ``areas`` and ``target``
    may be views with a frame stride (the per-frame segment sum's planes);
    the bins of a frame must be consecutive.  The kernel equals the plain
    version on the tables the CCA makes -- each target below its own
    entry, each area at most ``n_pixels``, K of at least 1; a target at or
    past its own entry gives 0 there."""
    if areas.ndim not in (1, 2) or target.shape != areas.shape:
        raise ValueError("areas and target must be [n] or [B, n], alike")
    if num_components.shape != areas.shape[:-1]:
        raise ValueError("num_components must have shape %s"
                         % (tuple(areas.shape[:-1]),))
    if not areas.is_cuda:
        if areas.device.type == "cpu":
            return cca_select_plain(areas, target, num_components, K,
                                    min_threshold, n_pixels)
        raise ValueError("unsupported device %s" % areas.device)
    dev = areas.device
    n = areas.shape[-1]
    B = areas.shape[0] if areas.ndim == 2 else 1
    for t, name in ((areas, "areas"), (target, "target")):
        if t.dtype is not torch.int32:
            raise TypeError("%s must be torch.int32, got %s" % (name, t.dtype))
        if t.get_device() != dev.index:
            raise ValueError("%s must be on %s, got %s" % (name, dev, t.device))
        if n > 1 and t.stride(-1) != 1:
            raise ValueError("%s must hold a frame's bins consecutively"
                             % name)
    if target.stride() != areas.stride():
        raise ValueError("areas and target must have the same strides")
    _lib.check(num_components, "num_components", torch.int64, dev)
    n_pixels = n if n_pixels is None else int(n_pixels)
    frame_stride = areas.stride(0) if areas.ndim == 2 else 0
    substitute = torch.empty(areas.shape, dtype=torch.int32, device=dev)
    tie = torch.empty(areas.shape[:-1], dtype=torch.bool, device=dev)
    _lib.launch("fstt_cca_select", dev, areas.data_ptr(), target.data_ptr(),
                frame_stride, num_components.data_ptr(),
                substitute.data_ptr(), tie.data_ptr(), B, n,
                min(K, n_pixels), int(min_threshold), n_pixels)
    return substitute, tie
