"""The least time one NVIDIA H100 could take for the work of a frame.

The arithmetic of ``chip_smoke.py`` (``bound`` and the bytes and operations
it counts for each kernel from its shapes): a call must read each input
byte once and write each output byte once, at 3.35 TB/s, or do its
operations at the 67 TFLOP/s of float32 outside the tensor cores; its
bound is the larger.  Here the work is counted per operation of the
algorithm (a LAB conversion, an assign pass, an update, a connectivity
pass), from the frame's shapes, so a kernel that does the same work under
another name is read the same.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12    # NVIDIA's data sheet, H100 SXM
SCALAR_OPS_PER_S = 67e12     # float32, outside the tensor cores

CAND_SLOTS = 16              # candidate slots of a cell (the default list)
LAB_TABLE_BYTES = 4 * (256 + 8193 + 9)    # sRGB, cube root, matrix (int32)
LSC_TABLE_BYTES = 4 * 4 * 256             # four colour tables (f32)
# operations counted per candidate a pixel visits: the arithmetic of the
# kernel's inner statement, not its index math
OPS_PER_VISIT = {"standard": 12, "lsc": 30}


def bound(moved: float, ops: float) -> float:
    """Seconds: bytes over the memory rate or operations over the scalar
    rate, the larger."""
    return max(moved / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


def rows(H: int, stride: int, rem: int) -> int:
    return len(range(rem, H, stride))


def lab(H: int, W: int) -> float:
    n = H * W
    return bound(15 * n + LAB_TABLE_BYTES, 30 * n)


def assign(H: int, W: int, K: int, S: int, stride: int, rem: int,
           variant: str = "standard") -> float:
    """One assign pass over the rows i % stride == rem.  A pixel visits
    at least one candidate; the bytes bound it in every cell."""
    P = rows(H, stride, rem) * W
    cells = math.ceil(H / S) * math.ceil(W / S)
    cand = 4 * cells * CAND_SLOTS
    table = 20 * K
    if variant == "lsc":
        return bound(44 * P + cand + table + 40 * K, OPS_PER_VISIT["lsc"] * P)
    return bound(16 * P + cand + table, OPS_PER_VISIT["standard"] * P)


def slic_update(H: int, W: int, K: int, stride: int, rem: int) -> float:
    P = rows(H, stride, rem) * W
    return bound(16 * P + 24 * K, 6 * P)


def lsc_feat(H: int, W: int) -> float:
    n = H * W
    return bound(36 * n + LSC_TABLE_BYTES, 6 * n)


def fsegsum(H: int, W: int, K: int, stride: int, rem: int) -> float:
    """LSC's weighted re-centring over the rows just assigned: ids, mask
    and 11 float rows in, [K + 1, 11] out."""
    P = rows(H, stride, rem) * W
    return bound(52 * P + 44 * (K + 1), 22 * P)


def connectivity(H: int, W: int) -> float:
    """One connectivity pass: the components (labels in, roots out), the
    segment sum of their areas, the lookup of each pixel's component and
    the orphan chase."""
    n = H * W
    return (bound(8 * n, 10 * n) + bound(20 * n + 8, 2 * n)
            + bound(12 * n, n) + bound(12 * n, n))


def frame(cfg: dict) -> float:
    """Seconds of the least time for one frame of ``cfg`` (a configuration
    file's dict): LAB, max_iter subsampled assign passes and updates (LSC:
    its features and re-centring), the full assign and one connectivity
    pass."""
    H, W, K = cfg["height"], cfg["width"], cfg["num_components"]
    S = max(1, int(math.sqrt(H * W // K)))
    variant = cfg["variant"]
    stride = cfg["subsample_stride"]
    t = lab(H, W) + connectivity(H, W)
    if variant == "lsc":
        t += lsc_feat(H, W)
    for i in range(cfg["max_iter"]):
        rem = i % stride
        t += assign(H, W, K, S, stride, rem, variant)
        t += slic_update(H, W, K, stride, rem)
        if variant == "lsc":
            t += fsegsum(H, W, K, stride, rem)
    return t + assign(H, W, K, S, 1, 0, variant)
