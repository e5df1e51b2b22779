"""Wrapper of the f32 segment-sum kernel (``csrc/fsegsum.cu``), which
replaces ``fast_slic_tpu/pallas/segsum_tpu.py:_fsegsum_kernel``.

:func:`plain` is the plain PyTorch version, an f32 ``index_add_``, which
on the CPU adds index by index.  A CPU tensor goes to it; a CUDA tensor
launches the kernel, which sums every bin in the same pixel order, so the
kernel equals the plain version on the CPU bit for bit.  (On the card,
``index_add_`` adds with float atomics in an order that changes from run
to run.)
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["float_segsum", "plain"]


def _check_args(ids, mask, vals, num_segments, wrow):
    if (ids.ndim != 1 or mask.shape != ids.shape or vals.ndim != 2
            or vals.shape[1] != ids.shape[0]):
        raise ValueError("need ids [N], mask [N] and vals [V, N]")
    if num_segments < 0:
        raise ValueError("num_segments must be >= 0")
    if wrow is not None and not 0 <= wrow < vals.shape[0]:
        raise ValueError("wrow must index a row of vals")


def plain(ids, mask, vals, num_segments: int, wrow=None):
    """ids int32 [N] in [0, num_segments], mask int32 [N] (0 = the pixel
    adds nothing), vals f32 [V, N] -> f32 [V, num_segments + 1] of per-id
    sums.  wrow: rows < wrow are multiplied by row wrow (the per-pixel
    weight) before they are summed."""
    _check_args(ids, mask, vals, num_segments, wrow)
    m = mask != 0
    v = vals * m.to(vals.dtype)
    if wrow is not None:
        v = torch.cat([v[:wrow] * v[wrow], v[wrow:]])
    ids_m = torch.where(m, ids.long(), num_segments)
    out = torch.zeros((vals.shape[0], num_segments + 1), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(1, ids_m, v)


def float_segsum(ids, mask, vals, num_segments: int, wrow=None):
    """Dispatch the f32 segment sum by device; see :func:`plain`.  On the
    card a stable sort groups the pixel indices by bin (masked pixels to
    bin num_segments, as in :func:`plain`) and the kernel sums each bin's
    run in pixel order."""
    dev = ids.device
    if dev.type == "cpu":
        return plain(ids, mask, vals, num_segments, wrow)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    _check_args(ids, mask, vals, num_segments, wrow)
    _lib.check(ids, "ids", torch.int32, dev)
    _lib.check(mask, "mask", torch.int32, dev)
    _lib.check(vals, "vals", torch.float32, dev)
    V, N = vals.shape
    bins = num_segments + 1
    sorted_ids, order = torch.sort(torch.where(mask != 0, ids, num_segments),
                                   stable=True)
    starts = torch.searchsorted(
        sorted_ids, torch.arange(bins + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    out = torch.empty((V, bins), dtype=torch.float32, device=dev)
    _lib.launch("fstt_fsegsum", _lib.ptr(order), _lib.ptr(starts),
                _lib.ptr(mask), _lib.ptr(vals), _lib.ptr(out), N, V, bins,
                -1 if wrow is None else int(wrow))
    float_segsum.launches += 1
    return out


float_segsum.launches = 0
