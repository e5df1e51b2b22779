"""Wrappers of the segment-sum kernels (``csrc/segsum.cu``), which replace
``fast_slic_tpu/pallas/segsum_tpu.py:_update_padded_kernel`` and
``:_segsum_kernel``.

The plain PyTorch versions are ``index_add_`` on int64, cast to int32 (the
JAX package's int32 sums, which wrap the same way).  A CPU tensor goes to
them; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import torch

from ..config import UNASSIGNED
from . import _lib

__all__ = ["slic_update", "slic_update_plain", "segment_sum",
           "segment_sum_plain"]


def _check_update(assignment, planes, K, stride, rem):
    H, W = assignment.shape
    if planes.shape != (3, H, W):
        raise ValueError("planes must be [3, %d, %d]" % (H, W))
    if K <= 0 or not (stride >= 1 and 0 <= rem < stride):
        raise ValueError("need K > 0, stride >= 1 and 0 <= rem < stride")


def slic_update_plain(assignment, planes, K: int, stride: int, rem: int):
    """Per-cluster sums [count, Σi, Σj, ΣL, Σa, Σb] -> int32 [6, K] over the
    rows i % stride == rem of the full-resolution int32 assignment [H, W]
    (pixels with id 0xFFFF do not count)."""
    _check_update(assignment, planes, K, stride, rem)
    H, W = assignment.shape
    dev = assignment.device
    rows = torch.arange(rem, H, stride, device=dev)
    a = assignment[rows].long()
    ii = rows[:, None].expand(a.shape)
    jj = torch.arange(W, device=dev)[None, :].expand(a.shape)
    ok = (a != UNASSIGNED) & (a >= 0) & (a < K)
    p = planes[:, rows].long()
    vals = torch.stack([torch.ones_like(a), ii, jj, p[0], p[1], p[2]])
    out = torch.zeros((6, K), dtype=torch.int64, device=dev)
    out.index_add_(1, a[ok], vals[:, ok])
    return out.to(torch.int32)


def slic_update(assignment, planes, K: int, stride: int, rem: int):
    """Dispatch the SLIC update sums by device; see
    :func:`slic_update_plain`."""
    dev = assignment.device
    if dev.type == "cpu":
        return slic_update_plain(assignment, planes, K, stride, rem)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    _check_update(assignment, planes, K, stride, rem)
    H, W = assignment.shape
    _lib.check(assignment, "assignment", torch.int32, dev)
    _lib.check(planes, "planes", torch.int32, dev)
    out = torch.zeros((6, K), dtype=torch.int32, device=dev)
    _lib.launch("fstt_slic_update", _lib.ptr(assignment), _lib.ptr(planes),
                _lib.ptr(out), H, W, K, stride, rem)
    slic_update.launches += 1
    return out


slic_update.launches = 0


def _check_segsum(ids, vals, num_segments):
    if ids.ndim != 1 or vals.ndim != 2 or vals.shape[1] != ids.shape[0]:
        raise ValueError("need ids [N] and vals [V, N]")
    if num_segments < 0:
        raise ValueError("num_segments must be >= 0")


def segment_sum_plain(ids, vals, num_segments: int):
    """Exact int32 segment sum: ids int32 [N] in [0, num_segments], vals
    int32 [V, N] -> int32 [V, num_segments + 1]."""
    _check_segsum(ids, vals, num_segments)
    out = torch.zeros((vals.shape[0], num_segments + 1), dtype=torch.int64,
                      device=vals.device)
    out.index_add_(1, ids.long(), vals.long())
    return out.to(torch.int32)


def segment_sum(ids, vals, num_segments: int):
    """Dispatch the segment sum by device; see :func:`segment_sum_plain`."""
    dev = ids.device
    if dev.type == "cpu":
        return segment_sum_plain(ids, vals, num_segments)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    _check_segsum(ids, vals, num_segments)
    _lib.check(ids, "ids", torch.int32, dev)
    _lib.check(vals, "vals", torch.int32, dev)
    V, N = vals.shape
    out = torch.zeros((V, num_segments + 1), dtype=torch.int32, device=dev)
    _lib.launch("fstt_segment_sum", _lib.ptr(ids), _lib.ptr(vals),
                _lib.ptr(out), N, V, num_segments + 1)
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
