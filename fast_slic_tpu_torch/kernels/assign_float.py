"""Wrapper of the float-distance assign kernel (``csrc/assign_float.cu``),
which replaces ``fast_slic_tpu/pallas/assign_tpu.py:_assign_kernel_float``.

:func:`plain` is the plain PyTorch version: the float branch of
``fast_slic_tpu.pipeline.assign_xla`` (real, real_l2, real_noq, lsc)
restricted to the rows it writes, each distance summed in the kernel's
order (LSC's ten squares left to right from 0, as the Pallas kernel does;
``assign_xla`` uses ``jnp.sum``).  A CPU tensor goes to it; a CUDA tensor
launches the kernel.

Both take one frame or B stacked frames (a leading frame dim on every
argument, as in :mod:`.assign`; feats [10, B, H, W], cent [B, K, 10]); the
kernel runs the B frames in one launch, the plain version one after the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import (VARIANT_LSC, VARIANT_REAL, VARIANT_REAL_L2,
                      VARIANT_REAL_NOQ)
from . import _lib
from .assign import check_frames

__all__ = ["assign_float", "plain", "F32_MAX"]

F32_MAX = float(np.finfo(np.float32).max)
_VARIANT_CODE = {VARIANT_REAL: 0, VARIANT_REAL_L2: 1, VARIANT_REAL_NOQ: 2,
                 VARIANT_LSC: 3}
N_FEAT = 10


def _check_args(planes, table, cand, assignment, S, stride, rem, variant,
                feats, cent):
    if variant not in _VARIANT_CODE:
        raise ValueError("no float assign for variant %r" % (variant,))
    B = check_frames(planes, table, cand, assignment, S, stride, rem)
    if variant == VARIANT_LSC:
        if feats is None or feats.shape != (N_FEAT,) + tuple(assignment.shape):
            raise ValueError("lsc needs feats [10, ...] beside the assignment")
        if cent is None or cent.shape != tuple(table.shape[:-1]) + (N_FEAT,):
            raise ValueError("lsc needs cent [..., K, 10] beside the table")
    return B


def plain(planes, table, cand, assignment, coef, S: int, stride: int,
          rem: int, variant: str, manhattan: bool = True, min_dists=None,
          feats=None, cent=None):
    """One float-distance assign pass over the rows i % stride == rem, in
    place.

    planes int32 [3, H, W]; table f32 [K, 5] (y, x, L, a, b); cand int32
    [GH, GW, C] visit-ordered candidate ids (-1 = empty); assignment int32
    [H, W], updated where a candidate wins; min_dists f32 [H, W] or None,
    set on the processed rows to the winning distance or FLT_MAX.  LSC also
    takes feats f32 [10, H, W] and cent f32 [K, 10].  ``coef`` is the
    float32 spatial coefficient.  B stacked frames: a leading frame dim on
    every argument."""
    _check_args(planes, table, cand, assignment, S, stride, rem, variant,
                feats, cent)
    if assignment.ndim == 3:
        lsc = variant == VARIANT_LSC
        for f in range(assignment.shape[0]):
            plain(planes[:, f], table[f], cand[f], assignment[f], coef, S,
                  stride, rem, variant, manhattan,
                  None if min_dists is None else min_dists[f],
                  feats[:, f] if lsc else None, cent[f] if lsc else None)
        return assignment
    H, W = assignment.shape
    dev = planes.device
    C = cand.shape[2]
    # no rows when rem >= H (a short image), as the kernel's launcher skips
    rows = torch.arange(min(rem, H), H, stride, device=dev)
    cols = torch.arange(W, device=dev)
    ii = rows[:, None].int()
    jj = cols[None, :].int()
    iif, jjf = ii.float(), jj.float()
    ci, cj = rows // S, cols // S
    coef = torch.tensor(np.float32(coef), dtype=torch.float32, device=dev)
    safe = cand.clamp(min=0).long()
    cdata = table[safe]                                  # [GH, GW, C, 5]
    if variant == VARIANT_LSC:
        f = feats[:, rows]                               # [10, Hs, W]
        fdata = cent[safe]                               # [GH, GW, C, 10]
    else:
        p = planes[:, rows]                              # [3, Hs, W]

    md = torch.full((rows.numel(), W), F32_MAX, dtype=torch.float32,
                    device=dev)
    ms = torch.full_like(md, -1, dtype=torch.int64)
    for s in range(C):
        ids = cand[:, :, s][ci][:, cj]                   # [Hs, W]
        c = cdata[:, :, s][ci][:, cj]                    # [Hs, W, 5]
        cy, cx = c[..., 0], c[..., 1]
        if variant == VARIANT_REAL_NOQ:
            y_lo = torch.trunc(cy - S).int().clamp(min=0)
            y_hi = torch.trunc((cy + S) + 1).int().clamp(max=H)
            x_lo = torch.trunc(cx - S).int().clamp(min=0)
            x_hi = torch.trunc((cx + S) + 1).int().clamp(max=W)
            inwin = (ii >= y_lo) & (ii < y_hi) & (jj >= x_lo) & (jj < x_hi)
            dr = p[0].float() - c[..., 2]
            dg = p[1].float() - c[..., 3]
            db = p[2].float() - c[..., 4]
            dy = coef * (iif - cy)
            dx = coef * (jjf - cx)
            if manhattan:
                dist = (dr.abs() + dg.abs() + db.abs() + dx.abs()
                        + dy.abs())
            else:
                dist = dr * dr + dg * dg + db * db + dx * dx + dy * dy
        else:
            di = ii - cy.int()                           # trunc, as (int)
            dj = jj - cx.int()
            inwin = (di.abs() <= S) & (dj.abs() <= S)
            if variant == VARIANT_LSC:
                fc = fdata[:, :, s][ci][:, cj]           # [Hs, W, 10]
                dist = torch.zeros_like(md)
                for ch in range(N_FEAT):
                    d = f[ch] - fc[..., ch]
                    dist = dist + d * d
            else:
                ic = c[..., 2:].int()
                if variant == VARIANT_REAL_L2:
                    fy = coef * di.float()
                    fx = coef * dj.float()
                    sp = fy * fy + fx * fx
                    dr = (p[0] - ic[..., 0]).float()
                    dg = (p[1] - ic[..., 1]).float()
                    db = (p[2] - ic[..., 2]).float()
                    dist = sp + dr * dr + dg * dg + db * db
                else:
                    if manhattan:
                        sp = coef * (di.abs() + dj.abs()).float()
                    else:
                        dif, djf = di.float(), dj.float()
                        sp = coef * torch.sqrt(dif * dif + djf * djf)
                    cd = ((p[0] - ic[..., 0]).abs() + (p[1] - ic[..., 1]).abs()
                          + (p[2] - ic[..., 2]).abs())
                    dist = sp + cd.float()
        better = (ids >= 0) & inwin & (dist < md)
        md = torch.where(better, dist, md)
        ms = torch.where(better, s, ms)
    got = ms >= 0
    win = torch.gather(cand[ci][:, cj].long(), 2, ms.clamp(min=0)[..., None])
    assignment[rows] = torch.where(got, win[..., 0], assignment[rows].long()
                                   ).to(assignment.dtype)
    if min_dists is not None:
        min_dists[rows] = torch.where(got, md, F32_MAX)
    return assignment


def assign_float(planes, table, cand, assignment, coef, S: int, stride: int,
                 rem: int, variant: str, manhattan: bool = True,
                 min_dists=None, feats=None, cent=None):
    """Dispatch one float-distance assign pass by device; see
    :func:`plain`."""
    dev = assignment.device
    if dev.type == "cpu":
        return plain(planes, table, cand, assignment, coef, S, stride, rem,
                     variant, manhattan, min_dists, feats, cent)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    B = _check_args(planes, table, cand, assignment, S, stride, rem,
                    variant, feats, cent)
    H, W = assignment.shape[-2:]
    GH, GW, C = cand.shape[-3:]
    _lib.check(planes, "planes", torch.int32, dev)
    _lib.check(table, "table", torch.float32, dev)
    _lib.check(cand, "cand", torch.int32, dev)
    _lib.check(assignment, "assignment", torch.int32, dev)
    fp = cp = md = None
    if variant == VARIANT_LSC:
        _lib.check(feats, "feats", torch.float32, dev)
        _lib.check(cent, "cent", torch.float32, dev)
        fp, cp = feats.data_ptr(), cent.data_ptr()
    if min_dists is not None:
        _lib.check(min_dists, "min_dists", torch.float32, dev,
                   assignment.shape)
        md = min_dists.data_ptr()
    _lib.launch("fstt_assign_float", dev, planes.data_ptr(), fp,
                table.data_ptr(), cp, cand.data_ptr(), assignment.data_ptr(),
                md, float(np.float32(coef)), H, W, S, GH, GW, C, stride, rem,
                _VARIANT_CODE[variant], int(bool(manhattan)),
                table.shape[-2], B,
                launches=int(rem < H))  # no launch for a pass with no rows
    return assignment
