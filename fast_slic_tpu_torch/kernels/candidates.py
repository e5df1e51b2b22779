"""Wrapper of the candidate-list kernel (``csrc/candidates.cu``), which
replaces ``fast_slic_tpu/pipeline.py:build_candidates`` (XLA ops in the JAX
package; there is no TPU kernel for it).

:func:`plain` is the plain PyTorch version, a sort of (cell, visit key)
pairs; a CPU tensor goes to it, a CUDA tensor launches the kernel, which
needs no sort (see the note at the head of the source).
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["candidates", "plain", "visit_order_key"]

# a block's shared memory on sm_90, the kernel's static part of it, and the
# blocks of its scratch path (csrc/candidates.cu)
SMEM_MAX = 232448
_STATIC_SMEM = 544
SCRATCH_BLOCKS = 132


def visit_order_key(y, x, S: int, K: int):
    """Per-cluster visit rank phase*K + k reproducing the reference's
    4-phase checkerboard assignment order (context.cpp:214-242); see
    fast_slic_tpu.pipeline.visit_order_key.  y, x: [..., K]."""
    T = 2 * S + 32
    ci = y.to(torch.int64) // T
    cj = x.to(torch.int64) // T
    phase = 2 * (ci % 2) + (cj % 2)
    return phase * K + torch.arange(K, device=y.device)


def plain(y, x, is_active, S: int, GH: int, GW: int, C: int, key=None):
    """(cand int32 [B, GH, GW, C], overflow bool []) by torch ops.

    Each cluster is replicated into its up to 9 cells, the (cell, visit key)
    pairs of each frame are sorted as one composite key cell*4K + key along
    the frame's row, and the rank inside each run of one cell gives the
    slot; one flat scatter with per-frame slot blocks (the last slot of each
    block takes the dropped entries) writes all frames
    (fast_slic_tpu/parallel/stack.py:64-118).  Each frame's result equals
    the single-frame build."""
    B, K = y.shape
    num_cells = GH * GW
    dev = y.device

    ci = torch.clamp(y.to(torch.int64) // S, 0, GH - 1)      # [B, K]
    cj = torch.clamp(x.to(torch.int64) // S, 0, GW - 1)
    if key is None:
        key = visit_order_key(y, x, S, K)

    d = torch.arange(-1, 2, device=dev)
    di9 = d.repeat_interleave(3)[:, None]
    dj9 = d.repeat(3)[:, None]
    ni = ci[:, None, :] + di9                                 # [B, 9, K]
    nj = cj[:, None, :] + dj9
    ok = ((is_active != 0)[:, None, :] & (ni >= 0) & (ni < GH)
          & (nj >= 0) & (nj < GW))
    cell9 = torch.where(ok, ni * GW + nj, num_cells).reshape(B, 9 * K)
    key9 = key[:, None, :].expand(B, 9, K).reshape(B, 9 * K)

    span = 4 * K
    comp_key, _ = torch.sort(cell9 * span + key9, dim=1)
    sc = comp_key // span
    okey = comp_key % span
    M = 9 * K
    iota = torch.arange(M, device=dev)
    run_start = torch.ones((B, M), dtype=torch.bool, device=dev)
    run_start[:, 1:] = sc[:, 1:] != sc[:, :-1]
    rank = iota - torch.cummax(torch.where(run_start, iota, 0), 1).values

    valid = sc < num_cells
    kept = valid & (rank < C)
    overflow = torch.any(valid & (rank >= C))
    fstride = num_cells * C + 1
    target = (torch.where(kept, sc * C + rank, num_cells * C)
              + torch.arange(B, device=dev)[:, None] * fstride)
    ckey = torch.full((B * fstride,), 2 ** 30, dtype=torch.int64, device=dev)
    ckey[target.reshape(-1)] = okey.reshape(-1)
    ckey = ckey.reshape(B, fstride)[:, :-1].reshape(B, GH, GW, C)
    cand = torch.where(ckey < 2 ** 30, ckey % K, -1).to(torch.int32)
    return cand, overflow


def _check(y, x, is_active, key, overflow):
    if y.ndim != 2:
        raise ValueError("y must be [B, K], got %s" % (tuple(y.shape),))
    for name, t, dtype in (("y", y, torch.float32), ("x", x, torch.float32),
                           ("is_active", is_active, torch.int32),
                           ("key", key, torch.int64)):
        if t is None:
            continue
        if t.dtype is not dtype:
            raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
        if t.shape != y.shape:
            raise ValueError("%s must have shape %s, got %s"
                             % (name, tuple(y.shape), tuple(t.shape)))
        if t.device != y.device:
            raise ValueError("%s must be on %s, got %s"
                             % (name, y.device, t.device))
    if overflow is not None:
        if overflow.dtype is not torch.bool or overflow.shape != ():
            raise ValueError("overflow must be a bool scalar tensor")
        if overflow.device != y.device:
            raise ValueError("overflow must be on %s, got %s"
                             % (y.device, overflow.device))
    if y.device.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % y.device)


def candidates(y, x, is_active, S: int, GH: int, GW: int, C: int, key=None,
               overflow=None):
    """Per-cell candidate lists of B frames: for every cell of the GH x GW
    grid of S-cells, the active clusters whose centre lies in its 3x3 cell
    neighbourhood, in visit order, -1 in the empty slots.

    y, x f32, is_active int32: [B, K] frame-local.  ``key`` int64 [B, K]:
    the visit-order keys phase*K + k (phase 0..3) when the caller has them
    (a row shard passes those of the image's own coordinates); by default
    :func:`visit_order_key` of y, x.  Returns (cand int32 [B, GH, GW, C],
    overflow: bool [], true where some cell of some frame has more than C
    candidates).  ``overflow`` given: that flag, OR-ed in place and
    returned; the card then makes one launch a build, else two (the flag's
    fill and the kernel)."""
    _check(y, x, is_active, key, overflow)
    if y.device.type == "cpu":
        cand, ovf = plain(y, x, is_active, S, GH, GW, C, key)
        if overflow is None:
            return cand, ovf
        return cand, overflow.logical_or_(ovf)
    dev = y.device
    B, K = y.shape
    for name, t in (("y", y), ("x", x), ("is_active", is_active),
                    ("key", key)):
        if t is not None:
            _lib.check(t, name, t.dtype, dev)
    cand = torch.empty((B, GH, GW, C), dtype=torch.int32, device=dev)
    if overflow is None:
        overflow = torch.zeros((), dtype=torch.bool, device=dev)
    scratch = None
    if 8 * K + _STATIC_SMEM > SMEM_MAX:   # the band list past shared memory
        scratch = torch.empty((min(B * GH, SCRATCH_BLOCKS), K, 2),
                              dtype=torch.int32, device=dev)
    rows = B * GH * GW
    _lib.launch("fstt_candidates", dev, y.data_ptr(), x.data_ptr(),
                is_active.data_ptr(), None if key is None else key.data_ptr(),
                B, K, S, GH, GW, C,
                None if scratch is None else scratch.data_ptr(),
                cand.data_ptr(), overflow.data_ptr(),
                launches=1 if rows else 0)
    return cand, overflow
