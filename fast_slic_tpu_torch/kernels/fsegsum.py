"""Wrapper of the f32 segment-sum kernel (``csrc/fsegsum.cu``), which
replaces ``fast_slic_tpu/pallas/segsum_tpu.py:_fsegsum_kernel``.

:func:`plain` is the plain PyTorch version, an f32 ``index_add_``, which
on the CPU adds index by index.  A CPU tensor goes to it; a CUDA tensor
launches the kernel, which sums every bin in the same pixel order, so the
kernel equals the plain version on the CPU bit for bit.  (On the card,
``index_add_`` adds with float atomics in an order that changes from run
to run.)  The kernel leaves masked pixels out, which changes no bit for
finite ``vals``: a masked pixel adds +-0 to a sum that starts at +0.0.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["float_segsum", "plain"]

# csrc/fsegsum.cu's tile of pixels (TILE) and its limits (MAX_ROWS, bins)
_TILE = 2048
MAX_ROWS = 16
MAX_BINS = 65536


def scratch_size(n: int, bins: int) -> int:
    """int32 entries of the kernel's scratch: per-(tile, bin) counts, the
    per-32-bin totals, the bins' starts, and two [n] arrays (the pixels'
    ranks, the pixel indices grouped by bin)."""
    tiles = max(1, -(-n // _TILE))
    return tiles * bins + -(-bins // 32) + bins + 1 + 2 * n


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
    card one call groups the unmasked pixels by bin with a stable counting
    sort and sums each bin's run in pixel order (``csrc/fsegsum.cu``); it
    takes finite ``vals`` with at most 16 rows and at most 65535
    segments."""
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
    if not 1 <= V <= MAX_ROWS or bins > MAX_BINS:
        raise ValueError("the kernel takes 1 to %d rows and at most %d "
                         "segments, got %d and %d"
                         % (MAX_ROWS, MAX_BINS - 1, V, num_segments))
    # one allocation: the sums, then the int32 scratch (4-byte words both)
    n_scratch = scratch_size(N, bins)
    buf = torch.empty(V * bins + n_scratch, dtype=torch.int32, device=dev)
    out = buf[:V * bins].view(torch.float32).view(V, bins)
    _lib.launch("fstt_fsegsum", dev, ids.data_ptr(), mask.data_ptr(),
                vals.data_ptr(), out.data_ptr(),
                buf.data_ptr() + 4 * V * bins, n_scratch, N, V, bins,
                -1 if wrow is None else int(wrow))
    return out
