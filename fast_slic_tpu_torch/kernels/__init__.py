"""Hand-written CUDA kernels of the ported paths, one wrapper module per
family.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises); it counts its launches in a plain
integer attribute ``launches``.  :data:`KERNELS` lists them with the source
and the TPU kernel each replaces.
"""

from __future__ import annotations

import collections

from . import assign as _assign
from . import assign_float as _assign_float
from . import cca as _cca
from . import fsegsum as _fsegsum
from . import lab as _lab
from . import lsc_feat as _lsc_feat
from . import segsum as _segsum

Kernel = collections.namedtuple(
    "Kernel", "name wrapper route source replaces")

KERNELS = (
    Kernel("lab", _lab.rgb_to_lab_planar, "cuda",
           "fast_slic_tpu_torch/csrc/lab.cu",
           "fast_slic_tpu/pallas/lut_tpu.py:192"),
    Kernel("assign", _assign.assign, "cuda",
           "fast_slic_tpu_torch/csrc/assign.cu",
           "fast_slic_tpu/pallas/assign_tpu.py:59"),
    Kernel("slic_update", _segsum.slic_update, "cuda",
           "fast_slic_tpu_torch/csrc/segsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:211"),
    Kernel("segment_sum", _segsum.segment_sum, "cuda",
           "fast_slic_tpu_torch/csrc/segsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:80"),
    Kernel("connected_components", _cca.connected_components, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/pallas/cca_tpu.py:145"),
    Kernel("lookup", _cca.lookup, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:300"),
    # the chase that called the lookup in a loop, in one launch
    Kernel("resolve_orphans", _cca.resolve_orphans, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:300"),
    Kernel("lsc_feat", _lsc_feat.lsc_color_feats, "cuda",
           "fast_slic_tpu_torch/csrc/lsc_feat.cu",
           "fast_slic_tpu/pallas/lut_tpu.py:321"),
    Kernel("assign_float", _assign_float.assign_float, "cuda",
           "fast_slic_tpu_torch/csrc/assign_float.cu",
           "fast_slic_tpu/pallas/assign_tpu.py:255"),
    Kernel("fsegsum", _fsegsum.float_segsum, "cuda",
           "fast_slic_tpu_torch/csrc/fsegsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:444"),
    Kernel("slic_update_masked", _segsum.slic_update_masked, "cuda",
           "fast_slic_tpu_torch/csrc/segsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:104"),
    Kernel("framed_segment_sum", _segsum.framed_segment_sum, "cuda",
           "fast_slic_tpu_torch/csrc/segsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:90"),
)


def reset_launches() -> None:
    for k in KERNELS:
        k.wrapper.launches = 0


def launch_counts() -> dict:
    return {k.name: k.wrapper.launches for k in KERNELS}
