"""Wrapper of the LAB kernel (``csrc/lab.cu``), which replaces
``fast_slic_tpu/pallas/lut_tpu.py:_lab_kernel``.

A CPU tensor goes to the plain PyTorch version
(:func:`fast_slic_tpu_torch.ops.cielab.rgb_to_lab_planar`); a CUDA tensor
launches the kernel.
"""

from __future__ import annotations

import torch

from ..ops.cielab import lab_tables, rgb_to_lab_planar as plain
from . import _lib

__all__ = ["rgb_to_lab_planar", "plain"]


def rgb_to_lab_planar(image: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] -> int32 planar [3, H, W] fixed-point L, a, b."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("image must be [H, W, 3], got %s" % (tuple(image.shape),))
    if image.device.type == "cpu":
        return plain(image)
    if image.device.type != "cuda":
        raise ValueError("unsupported device %s" % image.device)
    _lib.check(image, "image", torch.uint8, image.device)
    H, W, _ = image.shape
    srgb, cb, lab = lab_tables(image.device)
    out = torch.empty((3, H, W), dtype=torch.int32, device=image.device)
    _lib.launch("fstt_lab", image.data_ptr(), srgb.data_ptr(), cb.data_ptr(),
                lab.data_ptr(), out.data_ptr(), H * W)
    rgb_to_lab_planar.launches += 1
    return out


rgb_to_lab_planar.launches = 0
