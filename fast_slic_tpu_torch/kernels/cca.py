"""Wrappers of the CCA kernels (``csrc/cca.cu``): connected components,
which replaces ``fast_slic_tpu/pallas/cca_tpu.py:_cc_pass_kernel``; the
table lookup, which replaces ``fast_slic_tpu/pallas/segsum_tpu.py:
_lookup_kernel``; and the orphan chase, which replaces the loop of those
lookups in ``fast_slic_tpu/ops/cca.py:_resolve_orphans``.

The plain PyTorch versions are the JAX package's non-TPU branches:
neighbour-min sweeps with pointer jumping
(``fast_slic_tpu/ops/cca.py:connected_components``), a gather, and pointer
doubling.  A CPU tensor goes to them; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import math

import torch

from ..config import UNASSIGNED
from . import _lib

__all__ = ["connected_components", "connected_components_plain", "lookup",
           "lookup_plain", "resolve_orphans", "resolve_orphans_plain"]

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
    _lib.launch("fstt_cc", labels.data_ptr(), out.data_ptr(), H, W)
    connected_components.launches += 1
    return out


connected_components.launches = 0


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
    _lib.launch("fstt_lookup", ids.data_ptr(), table.data_ptr(),
                out.data_ptr(), ids.numel(), table.shape[0])
    lookup.launches += 1
    return out


lookup.launches = 0


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


def resolve_orphans(substitute, target):
    """Dispatch the orphan chase by device; see
    :func:`resolve_orphans_plain`.  On the card one launch walks every
    entry's chain (at most n hops) and nothing waits on the host."""
    if substitute.ndim != 1 or target.shape != substitute.shape:
        raise ValueError("substitute and target must be [n]")
    if not substitute.is_cuda:
        if substitute.device.type == "cpu":
            return resolve_orphans_plain(substitute, target)
        raise ValueError("unsupported device %s" % substitute.device)
    dev = substitute.device
    _lib.check(substitute, "substitute", torch.int32, dev)
    _lib.check(target, "target", torch.int32, dev)
    out = torch.empty_like(substitute)
    _lib.launch("fstt_resolve_orphans", substitute.data_ptr(),
                target.data_ptr(), out.data_ptr(), substitute.shape[0])
    resolve_orphans.launches += 1
    return out


resolve_orphans.launches = 0
