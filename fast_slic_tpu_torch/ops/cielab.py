"""RGB -> CIELAB conversion, bit-faithful to the reference fixed-point path.

The numpy table builders and the numpy oracle are those of
``fast_slic_tpu/ops/cielab.py`` (that module imports jax, so they are
carried here).  The reference converts with integer-only math
(``src/cielab.h``): a 256-entry sRGB inverse-gamma LUT in Q13, a 3x3
white-point-normalized RGB->XYZ matrix in Q16, an 8193-entry cube-root LUT
in Q13, and L,a,b packed to uint8 with ``output_shift = 1``.

:func:`rgb_to_lab_planar` is the plain PyTorch version of the LAB kernel
(``kernels/lab.py``, ``csrc/lab.cu``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import to_device

SRGB_SHIFT = 13
SRGB_MAX = 1 << SRGB_SHIFT        # 8192
LAB_SHIFT = 16
OUTPUT_SHIFT = 1                   # -> color_shift in the quantized pipeline


def _srgb_gamma_table_f32() -> np.ndarray:
    """The 256-entry linearization table (cielab.h:11-19 formula)."""
    a = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(a <= 0.04045, a / 12.92, ((a + 0.055) / 1.055) ** 2.4)
    return lin.astype(np.float32)


# RGB -> (X/Xn, Y/Yn, Z/Zn) matrix, already divided by the D65 white point
# (cielab.h:288-292).
_C_MATRIX = np.array(
    [
        [0.43395633, 0.37621531, 0.18984309],
        [0.2126729, 0.7151522, 0.072175],
        [0.01775782, 0.1094756, 0.87283638],
    ],
    dtype=np.float32,
)


def _powf_c(base: np.ndarray, exponent: float) -> np.ndarray:
    """Element-wise C ``powf`` via libm, so LUT entries match a C build
    bit-for-bit (numpy's float32 power differs by 1 ulp on ~0.3% of inputs,
    which flips ~0.016%% of LAB outputs by +-1)."""
    try:
        import ctypes
        import ctypes.util

        libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        libm.powf.restype = ctypes.c_float
        libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        e = np.float32(exponent)
        return np.array(
            [libm.powf(np.float32(b), e) for b in base.ravel()],
            dtype=np.float32,
        ).reshape(base.shape)
    except OSError:  # pragma: no cover - libm always present on linux
        return np.power(base.astype(np.float32), np.float32(exponent),
                        dtype=np.float32)


def _lab_nonlin_f32(v: np.ndarray) -> np.ndarray:
    """f(t) used by CIELAB: cbrt above the 0.008856 knee (cielab.h:328-332)."""
    v = v.astype(np.float32)
    lo = np.float32(7.787) * v + np.float32(0.137931)
    hi = _powf_c(v, 0.333333)
    return np.where(v > np.float32(0.008856), hi, lo)


def _build_int_tables():
    gamma_f32 = _srgb_gamma_table_f32()
    # (int)(tbl[i] * srgb_max): C truncates toward zero (cielab.h:298-299).
    srgb_tbl = np.trunc(
        (gamma_f32 * np.float32(SRGB_MAX)).astype(np.float32)
    ).astype(np.int32)
    # Cb[i] = roundf(C[i] * (1 << lab_shift)) (cielab.h:300-301).
    cb = np.round(_C_MATRIX * np.float32(1 << LAB_SHIFT)).astype(np.int32)
    # lab_tbl[i] = roundf(lab_nonlin(i / srgb_max) * srgb_max) (cielab.h:302-304).
    # roundf rounds half away from zero (values are positive: floor(x + 0.5)),
    # unlike numpy's round-half-to-even.
    idx = np.arange(SRGB_MAX + 1, dtype=np.float32) / np.float32(SRGB_MAX)
    scaled = (_lab_nonlin_f32(idx) * np.float32(SRGB_MAX)).astype(np.float32)
    lab_tbl = np.floor(scaled + np.float32(0.5)).astype(np.int32)
    return srgb_tbl, cb, lab_tbl


_SRGB_TBL_NP, _CB_NP, _LAB_TBL_NP = _build_int_tables()


def rgb_to_lab_quantized_np(image: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle for the fixed-point conversion (cielab.h:308-325).

    image: uint8 [..., 3].  Returns uint8 [..., 3] packed L,a,b.
    """
    rgb = image.astype(np.int64)
    s = _SRGB_TBL_NP.astype(np.int64)[rgb]  # [..., 3]
    cb = _CB_NP.astype(np.int64)
    xr = (s @ cb[0]) >> LAB_SHIFT
    yr = (s @ cb[1]) >> LAB_SHIFT
    zr = (s @ cb[2]) >> LAB_SHIFT
    fx = _LAB_TBL_NP.astype(np.int64)[xr]
    fy = _LAB_TBL_NP.astype(np.int64)[yr]
    fz = _LAB_TBL_NP.astype(np.int64)[zr]
    ciel = 116 * fy - (16 << SRGB_SHIFT)
    ciea = 500 * (fx - fy) + (128 << SRGB_SHIFT)
    cieb = 200 * (fy - fz) + (128 << SRGB_SHIFT)
    # The C code right-shifts the *unsigned* 32-bit value (cielab.h:322-324);
    # ciel can be slightly negative (rounding), which wraps before the shift.
    sh = SRGB_SHIFT - OUTPUT_SHIFT
    u32 = np.uint64(0xFFFFFFFF)
    l8 = np.clip((ciel.astype(np.int64) & u32.astype(np.int64)) >> sh, 0, 255)
    a8 = np.clip(((ciea.astype(np.int64) & u32.astype(np.int64)) >> sh) - (64 << OUTPUT_SHIFT), 0, 255)
    b8 = np.clip(((cieb.astype(np.int64) & u32.astype(np.int64)) >> sh) - (64 << OUTPUT_SHIFT), 0, 255)
    return np.stack([l8, a8, b8], axis=-1).astype(np.uint8)


def lab_tables(device):
    """(srgb int32 [256], cb int32 [3, 3], lab int32 [8193]) on ``device``."""
    return tuple(to_device(torch.from_numpy(t.copy()), device)
                 for t in (_SRGB_TBL_NP, _CB_NP, _LAB_TBL_NP))


def rgb_to_lab_planar(image: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch fixed-point conversion: uint8 [H, W, 3] -> int32
    planar [3, H, W] L,a,b in [0, 255].  Works in int64 (torch has no
    uint32 arithmetic on the CPU); the unsigned 32-bit wrap before the
    shift is ``& 0xFFFFFFFF`` as in :func:`rgb_to_lab_quantized_np`."""
    srgb, _, lab = (t.long() for t in lab_tables(image.device))
    s = srgb[image.long()]                              # [H, W, 3]
    sr, sg, sb = s[..., 0], s[..., 1], s[..., 2]
    cb = _CB_NP.tolist()
    fx, fy, fz = (lab[(row[0] * sr + row[1] * sg + row[2] * sb) >> LAB_SHIFT]
                  for row in cb)
    ciel = 116 * fy - (16 << SRGB_SHIFT)
    ciea = 500 * (fx - fy) + (128 << SRGB_SHIFT)
    cieb = 200 * (fy - fz) + (128 << SRGB_SHIFT)
    sh = SRGB_SHIFT - OUTPUT_SHIFT
    off = torch.tensor([0, 64 << OUTPUT_SHIFT, 64 << OUTPUT_SHIFT],
                       device=image.device)[:, None, None]
    v = (torch.stack([ciel, ciea, cieb]) & 0xFFFFFFFF) >> sh
    return (v - off).clamp(0, 255).to(torch.int32)
