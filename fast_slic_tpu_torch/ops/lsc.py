"""LSC (Linear Spectral Clustering) feature-space ops.

The counterpart of ``fast_slic_tpu/ops/lsc.py`` (reference ``lsc.cpp``).
LSC lifts every pixel into a 10-D feature vector [C*cos(t), C*sin(t)] for
each of L, a, b, x, y (angles proportional to the value), weights each
pixel by the dot product of its features with the image-mean feature, and
runs the SLIC loop with 10-D squared-L2 distances to per-cluster feature
centroids.

The trig tables are built on the host in numpy, exactly as the JAX package
builds them, so both packages gather the same float32 values.  The colour
lookups go through :mod:`..kernels.lsc_feat` and the weighted accumulation
through :mod:`..kernels.fsegsum`.

The two image-wide reductions (the mean feature and the seed windows) are
summed in float64 and rounded once to float32, so that the CPU and the GPU,
which sum in different orders, get the same float32 result; the JAX
package sums them in float32, so the port agrees with it to rounding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import UNASSIGNED, StaticConfig
from ..kernels.fsegsum import float_segsum
from ..kernels.lsc_feat import lsc_color_feats
from ..utils.timing import to_device

C_COLOR = 20.0  # lsc.h:8
N_FEAT = 10


def trig_tables(cfg: StaticConfig, compactness: float):
    """Host-side trig LUTs, bit-matching the reference's tables
    (lsc.cpp:70-101); numpy code of ``fast_slic_tpu.ops.lsc.trig_tables``.
    Returns a dict of float32 numpy arrays."""
    H, W, S = cfg.H, cfg.W, cfg.S
    halfPI = np.float32(math.pi / 2)
    c_color = np.float32(C_COLOR)
    ratio = np.float32(compactness) / np.float32(100.0)
    c_spatial = c_color * ratio

    xs = np.arange(256, dtype=np.float32)
    theta = halfPI * (xs / np.float32(255.0))
    ti = np.arange(H, dtype=np.float32) * (halfPI / np.float32(S))
    tj = np.arange(W, dtype=np.float32) * (halfPI / np.float32(S))
    return {
        "color_cos": (c_color * np.cos(theta) * np.float32(2.55)).astype(np.float32),
        "color_sin": (c_color * np.sin(theta) * np.float32(2.55)).astype(np.float32),
        "L_cos": (c_color * np.cos(theta)).astype(np.float32),
        "L_sin": (c_color * np.sin(theta)).astype(np.float32),
        "h_cos": (c_spatial * np.cos(ti)).astype(np.float32),
        "h_sin": (c_spatial * np.sin(ti)).astype(np.float32),
        "w_cos": (c_spatial * np.cos(tj)).astype(np.float32),
        "w_sin": (c_spatial * np.sin(tj)).astype(np.float32),
    }


def _raw_features(planes, tables, row0: int = 0):
    """The unnormalised features f32 [10, h, W] of the image rows
    [row0, row0 + h) held in ``planes`` int32 [3, h, W]."""
    _, h, W = planes.shape
    dev = planes.device
    t = {k: to_device(torch.from_numpy(v), dev) for k, v in tables.items()}
    color6 = lsc_color_feats(planes, t["L_cos"], t["L_sin"],
                             t["color_cos"], t["color_sin"])
    return torch.cat([
        color6,
        t["w_cos"][None, None, :].expand(1, h, W),
        t["w_sin"][None, None, :].expand(1, h, W),
        t["h_cos"][None, row0:row0 + h, None].expand(1, h, W),
        t["h_sin"][None, row0:row0 + h, None].expand(1, h, W),
    ])


def _feature_sum(feats):
    """float64 [10] sums of features (module docstring)."""
    return feats.reshape(N_FEAT, -1).sum(1, dtype=torch.float64)


def _normalise(feats, mean_f):
    """lsc.cpp:151-160: the weight of a pixel is its features' dot product
    with the mean feature, added channel by channel (an einsum's order
    differs by device); returns (feats / weights, weights)."""
    weights = feats[0] * mean_f[0]
    for c in range(1, N_FEAT):
        weights = weights + feats[c] * mean_f[c]
    return feats / weights, weights


def features(planes, cfg: StaticConfig, tables):
    """Per-pixel 10-D features and weights (map_image_into_feature_space,
    lsc.cpp:22-163).

    planes: int32 [3, H, W].  tables: :func:`trig_tables`.  Returns (feats
    f32 planar [10, H, W] in the order l1, l2, a1, a2, b1, b2, x1, x2, y1,
    y2, normalised by the weight; weights f32 [H, W])."""
    feats = _raw_features(planes, tables)
    # lsc.cpp:138-150; float64 sum, rounded once (module docstring)
    mean_f = (_feature_sum(feats) / (cfg.H * cfg.W)).to(torch.float32)
    return _normalise(feats, mean_f)


def features_sharded(planes_parts, cfg: StaticConfig, tables, mesh):
    """Row-sharded :func:`features` (fast_slic_tpu/ops/lsc.py:228): shard d
    of the mesh's ``space`` axis holds the image rows [d*Hl, (d+1)*Hl) as
    int32 [3, Hl, W].  The image-mean feature is the psum of the shards'
    float64 sums.  Returns the shards' (feats [10, Hl, W], weights
    [Hl, W])."""
    Hl = planes_parts[0].shape[1]
    raw = [_raw_features(planes, tables, d * Hl)
           for d, planes in enumerate(planes_parts)]
    mean_f = (mesh.psum([_feature_sum(f) for f in raw])
              / (cfg.H * cfg.W)).to(torch.float32)
    return [_normalise(f, m) for f, m in zip(raw, mesh.broadcast(mean_f))]


def seed_centroids(feats, st, cfg: StaticConfig):
    """Centroid features = unweighted mean over the clamped (2r+1)^2 window,
    r = S // 4, around each cluster centre (map_centroids_into_feature_space,
    lsc.cpp:165-195).  Returns f32 [K, 10].

    Only the K windows are summed: their pixels are gathered and added
    directly (no summed-area table: its f32 differences cancel, see the
    JAX package), in float64 (module docstring)."""
    H, W, S = cfg.H, cfg.W, cfg.S
    K = st.K
    r = S // 4
    d = torch.arange(-r, r + 1, device=feats.device)
    yy = st.y.to(torch.int64).clamp(0, H - 1)[:, None] + d    # [K, 2r+1]
    xx = st.x.to(torch.int64).clamp(0, W - 1)[:, None] + d
    inside = (((yy >= 0) & (yy < H))[:, :, None]
              & ((xx >= 0) & (xx < W))[:, None, :]).reshape(K, -1)
    flat = (yy.clamp(0, H - 1)[:, :, None] * W
            + xx.clamp(0, W - 1)[:, None, :]).reshape(-1)
    win = feats.reshape(N_FEAT, -1)[:, flat].reshape(N_FEAT, K, -1)
    sums = (win.double() * inside).sum(2).t().to(torch.float32)  # [K, 10]
    cnt = inside.sum(1).to(torch.float32)
    return (sums / cnt.clamp(min=1.0)[:, None]).contiguous()


def seed_centroids_sharded(feats_parts, st, cfg: StaticConfig, mesh):
    """Row-sharded :func:`seed_centroids` (fast_slic_tpu/ops/lsc.py:269):
    the S/4 windows cross the seams, so each shard extends its rows by r =
    S/4 halo rows from each neighbour (zeros past the image's edge, where
    the window counts nothing), and the shard that holds a centre's row
    sums its window as the single-device path does; the psum adds the
    others' zeros.  ``st``: the clusters on the first shard.  Needs r <
    Hl."""
    H, W, S = cfg.H, cfg.W, cfg.S
    K = st.K
    Hl = feats_parts[0].shape[1]
    r = S // 4
    if r:
        above = mesh.ppermute([f[:, -r:] for f in feats_parts], up=True)
        below = mesh.ppermute([f[:, :r] for f in feats_parts], up=False)
    yy = st.y.to(torch.int64).clamp(0, H - 1)
    xx = st.x.to(torch.int64).clamp(0, W - 1)
    parts = []
    for d, (feats, cy, cx) in enumerate(zip(
            feats_parts, mesh.broadcast(yy), mesh.broadcast(xx))):
        ext = torch.cat([above[d], feats, below[d]], 1) if r else feats
        owns = (cy >= d * Hl) & (cy < (d + 1) * Hl)
        dd = torch.arange(-r, r + 1, device=feats.device)
        gy = cy[:, None] + dd                                 # [K, 2r+1]
        gx = cx[:, None] + dd
        inside = (((gy >= 0) & (gy < H))[:, :, None]
                  & ((gx >= 0) & (gx < W))[:, None, :]).reshape(K, -1)
        # rows of ext: image row gy is ext row gy - d*Hl + r
        ey = (gy - d * Hl + r).clamp(0, Hl + 2 * r - 1)
        flat = (ey[:, :, None] * W
                + gx.clamp(0, W - 1)[:, None, :]).reshape(-1)
        win = ext.reshape(N_FEAT, -1)[:, flat].reshape(N_FEAT, K, -1)
        sums = (win.double() * inside).sum(2).t().to(torch.float32)
        parts.append(torch.where(owns[:, None], sums, 0.0))
    # the clamped window's pixel count in closed form
    cnt = (((yy + r).clamp(max=H - 1) - (yy - r).clamp(min=0) + 1)
           * ((xx + r).clamp(max=W - 1) - (xx - r).clamp(min=0) + 1)
           ).to(torch.float32)
    total = mesh.psum(parts)
    return (total / cnt.clamp(min=1.0)[:, None]).contiguous()


def after_update(feats, weights, st, cent, cfg: StaticConfig, rem: int,
                 stride: int, assignment, pixel_mask=None):
    """Weighted feature re-centroid over the rows i % stride == rem
    (ContextLSC::after_update, lsc.cpp:226-307); ``pixel_mask`` (bool
    [H, W], the preemptive grid's active pixels) restricts it further
    (lsc.cpp:270-287).  Returns f32 [K, 10], contiguous (the assign
    kernel's layout)."""
    acc11 = after_update_acc(
        feats[:, rem::stride], weights[rem::stride], assignment[rem::stride],
        cfg.K, None if pixel_mask is None else pixel_mask[rem::stride])
    return after_update_apply(acc11, st, cent)


def after_update_acc(feats_s, weights_s, asg_s, K: int, pm_s=None):
    """Per-cluster f32 sums [K+1, 11] of w*feat (10 rows) and w over the
    given pixels; unassigned pixels (0xFFFF) and pixels outside the bool
    mask ``pm_s`` add nothing.  The weight multiply happens inside the
    segment sum (``wrow=10``)."""
    ok = asg_s != UNASSIGNED
    ids = torch.where(ok, asg_s, K).reshape(-1).to(torch.int32)
    if pm_s is not None:
        ok = ok & pm_s
    vals = torch.cat([feats_s, weights_s[None]]).reshape(N_FEAT + 1, -1)
    return float_segsum(ids, ok.reshape(-1).to(torch.int32), vals, K,
                        wrow=N_FEAT).t()


def after_update_apply(acc11, st, cent):
    """Centroid = weighted sums / weight sums for updatable clusters; the
    others keep theirs (lsc.cpp:299-307)."""
    K = st.K
    upd = st.is_updatable != 0
    base = torch.where(upd[:, None], acc11[:K, :N_FEAT], cent)
    denom = torch.where(upd, acc11[:K, N_FEAT], 1.0)
    return (base / denom[:, None]).contiguous()
