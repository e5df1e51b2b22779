"""Plain PyTorch reference of fast-slic's ``iterate`` with the preemptive
grid on (``preemptive=True``; the reference C++ core's ``preemptive.h``
and ``context.cpp:176, 218, 332``), for the quantized SLIC distance, over
B independent frames at once.

The grid's semantics, as the reference applies them each call:

- cooldown: every cluster starts the call with ``is_updatable`` 2; after
  each update, an updatable cluster whose centre moved less than
  ``max(roundf(2 S thres), 1)`` in L1 counts down, any other updatable
  one goes back to 2 (``preemptive.h:114-140``);
- activity: a cluster is active when its int-cast centre lies within
  L-inf 2S of an updatable cluster's (``:142-164``);
- assign: a pass visits the active clusters only; a pixel that no active
  cluster reaches keeps its label (``context.cpp:218``);
- update: only the pixels of the 2S x 2S cells that hold an active
  cluster's centre count, or every pixel while every cluster is active
  (``:166-178``, ``context.cpp:332``), and only updatable clusters take
  their new means and member counts;
- finalize: every cluster is active again for the full assign
  (``context.cpp:176``).

Seeding, CIELAB, the assign and update passes and the connectivity
enforcement are ``slic_ref``'s.  ``Options.preemptive = False`` is the
control: the same call without the grid (``slic_ref.iterate``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from reference import slic_ref

COOLDOWN = 2           # preemptive.h:32
# the colour an inactive cluster is given for an assign pass: every
# pixel's distance to it passes the 0xFFFF cap, so no pixel takes it, as
# the reference's loop over active clusters never visits it
_UNREACHABLE = 1e6


@dataclasses.dataclass(frozen=True)
class Params(slic_ref.Params):
    """``slic_ref.Params`` and the grid's movement threshold."""

    preemptive_thres: float = 0.05

    @property
    def l1_thres(self) -> np.float32:
        """max(roundf(2 S thres), 1): the product in float32, rounded
        half away from zero (preemptive.h:126)."""
        l1 = float(np.float32(2 * self.S) * np.float32(self.preemptive_thres))
        return np.float32(max(math.floor(l1 + 0.5), 1.0))


@dataclasses.dataclass(frozen=True)
class Options:
    """The control: ``preemptive=False`` leaves the grid out."""

    preemptive: bool = True


def cooldown(updatable, moved, l1_thres):
    """The counters after an update: int64 [B, K] ``updatable``, float32
    L1 moves ``moved``."""
    return torch.where(updatable > 0,
                       torch.where(moved < float(l1_thres), updatable - 1,
                                   COOLDOWN),
                       updatable)


def active_clusters(st: slic_ref.State, updatable, S: int):
    """bool [B, K]: the clusters whose int-cast centre lies within L-inf
    2S of an updatable cluster's, in the same frame."""
    y, x = st.y.long(), st.x.long()
    near = (((y[:, :, None] - y[:, None, :]).abs() <= 2 * S)
            & ((x[:, :, None] - x[:, None, :]).abs() <= 2 * S))
    return (near & (updatable > 0)[:, :, None]).any(1)


def active_pixels(st: slic_ref.State, active, p: Params):
    """bool [B, H, W]: the pixels of the 2S x 2S cells that hold an active
    cluster's int-cast centre, or every pixel of a frame whose clusters
    are all active."""
    B = active.shape[0]
    S2 = 2 * p.S
    CH, CW = -(-p.H // S2), -(-p.W // S2)
    cy = (st.y.long() // S2).clamp(0, CH - 1)
    cx = (st.x.long() // S2).clamp(0, CW - 1)
    held = torch.zeros((B, CH * CW), dtype=torch.int64, device=active.device)
    held.scatter_add_(1, cy * CW + cx, active.long())
    cells = held.reshape(B, CH, CW) > 0
    px = cells.repeat_interleave(S2, 1).repeat_interleave(S2, 2)
    return px[:, :p.H, :p.W] | active.all(1)[:, None, None]


def _assign(fr, st: slic_ref.State, assignment, stride: int, rem: int,
            active):
    """``slic_ref``'s assign pass over the active clusters only."""
    far = lambda c: torch.where(active, c, torch.full_like(c, _UNREACHABLE))
    seen = dataclasses.replace(st, r=far(st.r), g=far(st.g), b=far(st.b))
    fr.assign(seen, assignment, stride, rem)
    st.y, st.x = seen.y, seen.x         # the pass's clamp of the centres


def _update(fr, st: slic_ref.State, assignment, stride: int, rem: int,
            mask, updatable):
    """``slic_ref``'s update over the pixels ``mask`` passes, taken by the
    updatable clusters only (``mask`` None: every pixel).  Returns the
    pixels it added (a 0-d tensor)."""
    if mask is not None:
        assignment = torch.where(mask.reshape(-1), assignment,
                                 slic_ref.UNASSIGNED)
    new = dataclasses.replace(st)
    fr.update(new, assignment, stride, rem)
    upd = updatable > 0
    for f in ("y", "x", "r", "g", "b", "num_members"):
        setattr(st, f, torch.where(upd, getattr(new, f), getattr(st, f)))
    return new.num_members.sum()


def iterate(images: torch.Tensor, st: slic_ref.State, p: Params,
            opts: Options = Options(), tables=None, record=None):
    """fast-slic's iterate with the preemptive grid over each frame of
    uint8 [B, H, W, 3] (a tensor on the device) from the frames' states
    ``st`` (updated in place).  ``record``: a list that gets, for each
    iteration, (clusters active after its step, pixels its update added)
    summed over the frames.  Returns int64 labels [B, H, W], -1 for
    unassigned."""
    if p.variant != "standard":
        raise ValueError("the preemptive reference covers the quantized "
                         "distance only")
    tables = tables or slic_ref.lab_tables()
    if not opts.preemptive:
        return slic_ref.iterate(images, st, p, tables=tables)
    fr = slic_ref._Frame(images, p, slic_ref.Options(), tables)
    H, W = p.H, p.W
    # colours re-seeded from the LAB image at the int-cast centres
    cy = st.y.long().clamp(0, H - 1)
    cx = st.x.long().clamp(0, W - 1)
    seed = fr.flat[cy * W + cx + fr.base[:, None]].float()   # [B, K, 3]
    st.r, st.g, st.b = seed[..., 0], seed[..., 1], seed[..., 2]
    updatable = torch.full(st.y.shape, COOLDOWN, dtype=torch.int64,
                           device=fr.dev)
    active = torch.ones(st.y.shape, dtype=torch.bool, device=fr.dev)
    mask = None
    assignment = torch.full((fr.B * H * W,), slic_ref.UNASSIGNED,
                            dtype=torch.int64, device=fr.dev)
    stride = p.subsample_stride
    for i in range(p.max_iter):
        rem = i % stride
        _assign(fr, st, assignment, stride, rem, active)
        old_y, old_x = st.y, st.x
        added = _update(fr, st, assignment, stride, rem, mask, updatable)
        moved = (old_x - st.x).abs() + (old_y - st.y).abs()
        updatable = cooldown(updatable, moved, p.l1_thres)
        active = active_clusters(st, updatable, p.S)
        mask = active_pixels(st, active, p)
        if record is not None:
            record.append((int(active.sum()), int(added)))
    fr.assign(st, assignment, 1, 0)          # finalize: every cluster
    thres = int(math.floor(p.S * p.S * p.min_size_factor + 0.5))
    return slic_ref.enforce_connectivity(assignment.reshape(fr.B, H, W),
                                         p.K, thres)
