"""Wrapper of the assign kernel (``csrc/assign.cu``), which replaces
``fast_slic_tpu/pallas/assign_tpu.py:_assign_kernel``.

:func:`plain` is the plain PyTorch version: the standard branch of
``fast_slic_tpu.pipeline.assign_xla`` restricted to the rows it writes.  A
CPU tensor goes to it; a CUDA tensor launches the kernel.

Both take one frame or B stacked frames (a leading frame dim on every
argument: planes [3, B, H, W], table [B, K, 5], cand [B, GH, GW, C],
assignment and min_dists [B, H, W]); the kernel runs the B frames in one
launch, the plain version one after the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import UNASSIGNED
from . import _lib

__all__ = ["assign", "plain"]

_NONE = 0x7FFFFFFF


def check_frames(planes, table, cand, assignment, S, stride, rem):
    """Validate the shapes of one assign pass (one frame or B frames);
    returns the frame count B (1 for one frame)."""
    if assignment.ndim not in (2, 3):
        raise ValueError("assignment must be [H, W] or [B, H, W]")
    lead = tuple(assignment.shape[:-2])
    H, W = assignment.shape[-2:]
    if planes.shape != (3,) + tuple(assignment.shape):
        raise ValueError("planes must be [3, %s]"
                         % ", ".join(map(str, assignment.shape)))
    if table.ndim != len(lead) + 2 or tuple(table.shape[:-2]) != lead or (
            table.shape[-1] != 5):
        raise ValueError("table must be [%sK, 5]" % ("B, " if lead else ""))
    GH, GW = -(-H // S), -(-W // S)
    if cand.ndim != len(lead) + 3 or tuple(cand.shape[:-1]) != lead + (GH, GW):
        raise ValueError("cand must be [%s%d, %d, C]"
                         % ("B, " if lead else "", GH, GW))
    if cand.shape[-1] >= 128:
        raise ValueError("slot index must fit in 7 bits")
    if not (stride >= 1 and 0 <= rem < stride):
        raise ValueError("need stride >= 1 and 0 <= rem < stride")
    return lead[0] if lead else 1


def plain(planes, table, cand, assignment, coef, S: int, stride: int,
          rem: int, manhattan: bool = True, min_dists=None):
    """One assign pass over the rows i % stride == rem, in place.

    planes int32 [3, H, W]; table f32 [K, 5] (y, x, L, a, b); cand int32
    [GH, GW, C] visit-ordered candidate ids (-1 = empty); assignment int32
    [H, W], updated where a candidate wins; min_dists int32 [H, W] or None,
    set on the processed rows to the winning distance or 0xFFFF.
    ``coef`` is the float32 spatial coefficient.  B stacked frames: a
    leading frame dim on every argument."""
    check_frames(planes, table, cand, assignment, S, stride, rem)
    if assignment.ndim == 3:
        for f in range(assignment.shape[0]):
            plain(planes[:, f], table[f], cand[f], assignment[f], coef, S,
                  stride, rem, manhattan,
                  None if min_dists is None else min_dists[f])
        return assignment
    H, W = assignment.shape
    dev = planes.device
    C = cand.shape[2]
    # no rows when rem >= H (a short image), as the kernel's launcher skips
    rows = torch.arange(min(rem, H), H, stride, device=dev)
    cols = torch.arange(W, device=dev)
    ii = rows[:, None].int()
    jj = cols[None, :].int()
    ci, cj = rows // S, cols // S
    p = planes[:, rows]                                  # [3, Hs, W]
    coef = torch.tensor(np.float32(coef), dtype=torch.float32, device=dev)
    cdata = table[cand.clamp(min=0).long()]              # [GH, GW, C, 5]

    m = torch.full(p.shape[1:], _NONE, dtype=torch.int64, device=dev)
    for s in range(C):
        ids = cand[:, :, s][ci][:, cj]                   # [Hs, W]
        c = cdata[:, :, s][ci][:, cj]                    # [Hs, W, 5]
        ci_c = c.to(torch.int32)                         # trunc, as (int)
        di = ii - ci_c[..., 0]
        dj = jj - ci_c[..., 1]
        inwin = (ids >= 0) & (di.abs() <= S) & (dj.abs() <= S)
        if manhattan:
            sp = coef * (di.abs() + dj.abs()).float()
        else:
            dif, djf = di.float(), dj.float()
            sp = coef * torch.sqrt(dif * dif + djf * djf)
        cd = ((p[0] - ci_c[..., 2]).abs() + (p[1] - ci_c[..., 3]).abs()
              + (p[2] - ci_c[..., 4]).abs())
        dist = torch.trunc(sp).to(torch.int64) + cd
        packed = (dist << 7) | s
        m = torch.minimum(m, torch.where(inwin, packed, _NONE))
    got = m != _NONE
    slot = (m & 0x7F).clamp(max=C - 1)
    win = torch.gather(cand[ci][:, cj].long(), 2, slot[..., None])[..., 0]
    assignment[rows] = torch.where(got, win, assignment[rows].long()).to(
        assignment.dtype)
    if min_dists is not None:
        min_dists[rows] = torch.where(got, m >> 7, UNASSIGNED).to(
            min_dists.dtype)
    return assignment


def assign(planes, table, cand, assignment, coef, S: int, stride: int,
           rem: int, manhattan: bool = True, min_dists=None):
    """Dispatch one assign pass by device; see :func:`plain`."""
    dev = assignment.device
    if dev.type == "cpu":
        return plain(planes, table, cand, assignment, coef, S, stride, rem,
                     manhattan, min_dists)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    B = check_frames(planes, table, cand, assignment, S, stride, rem)
    H, W = assignment.shape[-2:]
    GH, GW, C = cand.shape[-3:]
    _lib.check(planes, "planes", torch.int32, dev)
    _lib.check(table, "table", torch.float32, dev)
    _lib.check(cand, "cand", torch.int32, dev)
    _lib.check(assignment, "assignment", torch.int32, dev)
    md = None
    if min_dists is not None:
        _lib.check(min_dists, "min_dists", torch.int32, dev, assignment.shape)
        md = min_dists.data_ptr()
    _lib.launch("fstt_assign", dev, planes.data_ptr(), table.data_ptr(),
                cand.data_ptr(), assignment.data_ptr(), md,
                float(np.float32(coef)), H, W, S, GH, GW, C, stride, rem,
                int(bool(manhattan)), table.shape[-2], B,
                launches=int(rem < H))  # no launch for a pass with no rows
    return assignment
