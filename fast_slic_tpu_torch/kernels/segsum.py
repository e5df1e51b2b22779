"""Wrappers of the segment-sum kernels (``csrc/segsum.cu``), which replace
``fast_slic_tpu/pallas/segsum_tpu.py:_update_padded_kernel``
(:func:`slic_update`), ``:_update_kernel`` (:func:`slic_update_masked`),
``:_segsum_kernel`` (:func:`segment_sum`) and ``:_framed_segsum_kernel``
(:func:`framed_segment_sum`).

The plain PyTorch versions are ``index_add_`` on int64, cast to int32 (the
JAX package's int32 sums, which wrap the same way).  A CPU tensor goes to
them; a CUDA tensor launches the kernel.

The two update sums take one frame (assignment [H, W], planes [3, H, W])
or B stacked frames (assignment [B, H, W], planes [3, B, H, W]: the JAX
stacked layout); the output is int32 [6, B*K] with frame f's cluster k at
column f*K + k ([6, K] for one frame).

The update kernels sum on chip before anything reaches device memory: a
block takes 128 columns x 8 subsampled rows, a lane sums its runs of equal
ids (four pixels of a row), and the runs meet in a shared-memory table that
adds each cluster's six sums to the output once a block.  One global atomic
a value and pixel had serialised on the few clusters a warp's neighbouring
pixels share; ids that find the table full still add to device memory
directly, so random ids are exact too.  What bounds them now is one wave of
loads and the launch (``PERF.md`` §6, kernel designs that lost).

:func:`segment_sum` and :func:`framed_segment_sum` launch one kernel with
the same design (a block sums 1024 consecutive ids of one frame; the frame
is a grid row, and :func:`segment_sum` is one frame).
"""

from __future__ import annotations

import torch

from ..config import UNASSIGNED
from . import _lib

__all__ = ["slic_update", "slic_update_plain", "slic_update_masked",
           "slic_update_masked_plain", "segment_sum", "segment_sum_plain",
           "framed_segment_sum", "framed_segment_sum_plain"]


def _check_update(assignment, planes, mask, K, stride, rem):
    if assignment.ndim not in (2, 3):
        raise ValueError("assignment must be [H, W] or [B, H, W]")
    if planes.shape != (3,) + tuple(assignment.shape):
        raise ValueError("planes must be [3, %s]"
                         % ", ".join(map(str, assignment.shape)))
    if mask is not None and mask.shape != assignment.shape:
        raise ValueError("mask must have the assignment's shape")
    if K <= 0 or not (stride >= 1 and 0 <= rem < stride):
        raise ValueError("need K > 0, stride >= 1 and 0 <= rem < stride")


def _update_plain(assignment, planes, mask, K: int, stride: int, rem: int):
    _check_update(assignment, planes, mask, K, stride, rem)
    if assignment.ndim == 3:
        return torch.cat([
            _update_plain(assignment[f], planes[:, f],
                          None if mask is None else mask[f], K, stride, rem)
            for f in range(assignment.shape[0])], dim=1)
    H, W = assignment.shape
    dev = assignment.device
    # no rows when rem >= H (a short image), as the kernel's launcher skips
    rows = torch.arange(min(rem, H), H, stride, device=dev)
    a = assignment[rows].long()
    ii = rows[:, None].expand(a.shape)
    jj = torch.arange(W, device=dev)[None, :].expand(a.shape)
    ok = (a != UNASSIGNED) & (a >= 0) & (a < K)
    if mask is not None:
        ok = ok & mask[rows]
    p = planes[:, rows].long()
    vals = torch.stack([torch.ones_like(a), ii, jj, p[0], p[1], p[2]])
    out = torch.zeros((6, K), dtype=torch.int64, device=dev)
    out.index_add_(1, a[ok], vals[:, ok])
    return out.to(torch.int32)


def slic_update_plain(assignment, planes, K: int, stride: int, rem: int):
    """Per-cluster sums [count, Σi, Σj, ΣL, Σa, Σb] -> int32 [6, B*K] over
    the rows i % stride == rem of the full-resolution int32 assignment
    (pixels with id 0xFFFF do not count)."""
    return _update_plain(assignment, planes, None, K, stride, rem)


def slic_update_masked_plain(assignment, planes, mask, K: int, stride: int,
                             rem: int):
    """:func:`slic_update_plain` over the pixels whose bool ``mask`` (the
    preemptive grid's active pixels, the assignment's shape) is set; a
    masked pixel adds nothing, not even to the count."""
    return _update_plain(assignment, planes, mask, K, stride, rem)


def _launch_update(name, assignment, planes, mask, K, stride, rem):
    dev = assignment.device
    _check_update(assignment, planes, mask, K, stride, rem)
    _lib.check(assignment, "assignment", torch.int32, dev)
    _lib.check(planes, "planes", torch.int32, dev)
    B = assignment.shape[0] if assignment.ndim == 3 else 1
    H, W = assignment.shape[-2:]
    out = torch.zeros((6, B * K), dtype=torch.int32, device=dev)
    args = [assignment.data_ptr(), planes.data_ptr()]
    if mask is not None:
        _lib.check(mask, "mask", torch.bool, dev)
        args.append(mask.data_ptr())
    _lib.launch(name, dev, *args, out.data_ptr(), H, W, K, B, stride, rem,
                launches=int(rem < H))  # no launch for a pass with no rows
    return out


def slic_update(assignment, planes, K: int, stride: int, rem: int):
    """Dispatch the SLIC update sums by device; see
    :func:`slic_update_plain`."""
    dev = assignment.device
    if dev.type == "cpu":
        return slic_update_plain(assignment, planes, K, stride, rem)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    out = _launch_update("fstt_slic_update", assignment, planes, None, K,
                         stride, rem)
    return out


def slic_update_masked(assignment, planes, mask, K: int, stride: int,
                       rem: int):
    """Dispatch the masked SLIC update sums by device; see
    :func:`slic_update_masked_plain`."""
    dev = assignment.device
    if dev.type == "cpu":
        return slic_update_masked_plain(assignment, planes, mask, K, stride,
                                        rem)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    out = _launch_update("fstt_slic_update_masked", assignment, planes, mask,
                         K, stride, rem)
    return out


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
    _lib.launch("fstt_segment_sum", dev, ids.data_ptr(), vals.data_ptr(),
                out.data_ptr(), N, V, num_segments + 1)
    return out


def _check_framed(ids, vals, num_segments_f):
    if (ids.ndim != 2 or vals.ndim != 3
            or tuple(vals.shape[1:]) != tuple(ids.shape)):
        raise ValueError("need ids [B, Nf] and vals [V, B, Nf]")
    if num_segments_f < 0:
        raise ValueError("num_segments_f must be >= 0")


def framed_segment_sum_plain(ids, vals, num_segments_f: int):
    """Per-frame exact int32 segment sum: ids int32 [B, Nf] frame-local in
    [0, num_segments_f) (others drop), vals int32 [V, B, Nf] -> int32
    [B, V, num_segments_f]; one ``index_add_`` on f*num_segments_f + id."""
    _check_framed(ids, vals, num_segments_f)
    V, B, Nf = vals.shape
    dev = vals.device
    bins = B * num_segments_f
    gid = ids.long() + torch.arange(B, device=dev)[:, None] * num_segments_f
    gid = torch.where((ids >= 0) & (ids < num_segments_f), gid, bins)
    out = torch.zeros((V, bins + 1), dtype=torch.int64, device=dev)
    out.index_add_(1, gid.reshape(-1), vals.reshape(V, -1).long())
    return out[:, :bins].reshape(V, B, num_segments_f).transpose(0, 1).to(
        torch.int32).contiguous()


def framed_segment_sum(ids, vals, num_segments_f: int):
    """Dispatch the per-frame segment sum by device; see
    :func:`framed_segment_sum_plain`."""
    dev = ids.device
    if dev.type == "cpu":
        return framed_segment_sum_plain(ids, vals, num_segments_f)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    _check_framed(ids, vals, num_segments_f)
    _lib.check(ids, "ids", torch.int32, dev)
    _lib.check(vals, "vals", torch.int32, dev)
    V, B, Nf = vals.shape
    out = torch.zeros((B, V, num_segments_f), dtype=torch.int32, device=dev)
    _lib.launch("fstt_framed_segment_sum", dev, ids.data_ptr(),
                vals.data_ptr(), out.data_ptr(), B, Nf, V, num_segments_f)
    return out
