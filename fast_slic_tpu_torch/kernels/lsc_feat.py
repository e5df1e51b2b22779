"""Wrapper of the LSC colour-feature kernel (``csrc/lsc_feat.cu``), which
replaces ``fast_slic_tpu/pallas/lut_tpu.py:_lsc_feat_kernel``.

:func:`plain` is the plain PyTorch version, six table gathers; a CPU tensor
goes to it, a CUDA tensor launches the kernel.  Both clamp the indices to
[0, 255], as an XLA gather does.
"""

from __future__ import annotations

import torch

from . import _lib

__all__ = ["lsc_color_feats", "plain"]


def _check_args(planes, tables):
    if planes.ndim != 3 or planes.shape[0] != 3:
        raise ValueError("planes must be [3, H, W]")
    if len(tables) != 4 or any(t.shape != (256,) for t in tables):
        raise ValueError("need four [256] tables")


def plain(planes, lcos, lsin, ccos, csin):
    """int32 [3, H, W] quantized (L, a, b) planes and four f32 [256] tables
    -> f32 [6, H, W]: L_cos[L], L_sin[L], color_cos[a], color_sin[a],
    color_cos[b], color_sin[b]."""
    _check_args(planes, (lcos, lsin, ccos, csin))
    idx = planes.long().clamp(0, 255)
    L, a, b = idx[0], idx[1], idx[2]
    return torch.stack([lcos[L], lsin[L], ccos[a], csin[a], ccos[b],
                        csin[b]])


def lsc_color_feats(planes, lcos, lsin, ccos, csin):
    """Dispatch the LSC colour features by device; see :func:`plain`."""
    dev = planes.device
    if dev.type == "cpu":
        return plain(planes, lcos, lsin, ccos, csin)
    if dev.type != "cuda":
        raise ValueError("unsupported device %s" % dev)
    _check_args(planes, (lcos, lsin, ccos, csin))
    _lib.check(planes, "planes", torch.int32, dev)
    tables = torch.stack([lcos, lsin, ccos, csin]).to(dev, torch.float32)
    _, H, W = planes.shape
    out = torch.empty((6, H, W), dtype=torch.float32, device=dev)
    _lib.launch("fstt_lsc_feat", dev, planes.data_ptr(), tables.data_ptr(),
                out.data_ptr(), H * W)
    return out
