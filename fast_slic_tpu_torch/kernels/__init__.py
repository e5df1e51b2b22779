"""Hand-written CUDA kernels of the ported paths, one wrapper module per
family.

Each wrapper takes the plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises) through ``_lib.launch``, which
counts the launches of each C entry point in ``utils.timing.COUNTS``.
:data:`KERNELS` lists them with the entry point, the source and the TPU
kernel each replaces.
"""

from __future__ import annotations

import collections

from ..utils.timing import COUNTS
from . import assign as _assign
from . import assign_float as _assign_float
from . import candidates as _candidates
from . import cca as _cca
from . import fsegsum as _fsegsum
from . import knn as _knn
from . import lab as _lab
from . import lsc_feat as _lsc_feat
from . import segsum as _segsum

Kernel = collections.namedtuple(
    "Kernel", "name entry wrapper route source replaces")

KERNELS = (
    Kernel("lab", "fstt_lab", _lab.rgb_to_lab_planar, "cuda",
           "fast_slic_tpu_torch/csrc/lab.cu",
           "fast_slic_tpu/pallas/lut_tpu.py:192"),
    Kernel("assign", "fstt_assign", _assign.assign, "cuda",
           "fast_slic_tpu_torch/csrc/assign.cu",
           "fast_slic_tpu/pallas/assign_tpu.py:59"),
    Kernel("slic_update", "fstt_slic_update", _segsum.slic_update, "cuda",
           "fast_slic_tpu_torch/csrc/segsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:211"),
    Kernel("segment_sum", "fstt_segment_sum", _segsum.segment_sum, "cuda",
           "fast_slic_tpu_torch/csrc/segsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:80"),
    Kernel("connected_components", "fstt_cc",
           _cca.connected_components, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/pallas/cca_tpu.py:145"),
    Kernel("lookup", "fstt_lookup", _cca.lookup, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:300"),
    # not a TPU kernel: the JAX package selects, renumbers and adopts the
    # orphans with XLA ops (a binary search for the K-th largest area, and
    # the chase that calls the lookup in a loop)
    Kernel("cca_select", "fstt_cca_select", _cca.cca_select, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/ops/cca.py:308-398 (XLA ops)"),
    Kernel("lsc_feat", "fstt_lsc_feat", _lsc_feat.lsc_color_feats, "cuda",
           "fast_slic_tpu_torch/csrc/lsc_feat.cu",
           "fast_slic_tpu/pallas/lut_tpu.py:321"),
    Kernel("assign_float", "fstt_assign_float",
           _assign_float.assign_float, "cuda",
           "fast_slic_tpu_torch/csrc/assign_float.cu",
           "fast_slic_tpu/pallas/assign_tpu.py:255"),
    Kernel("fsegsum", "fstt_fsegsum", _fsegsum.float_segsum, "cuda",
           "fast_slic_tpu_torch/csrc/fsegsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:444"),
    Kernel("slic_update_masked", "fstt_slic_update_masked",
           _segsum.slic_update_masked, "cuda",
           "fast_slic_tpu_torch/csrc/segsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:104"),
    Kernel("framed_segment_sum", "fstt_framed_segment_sum",
           _segsum.framed_segment_sum, "cuda",
           "fast_slic_tpu_torch/csrc/segsum.cu",
           "fast_slic_tpu/pallas/segsum_tpu.py:90"),
    # the same TPU kernel as the components, with any seed
    Kernel("propagate_min", "fstt_propagate_min", _cca.propagate_min, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/pallas/cca_tpu.py:145 _cc_pass_kernel "
           "(propagate_min_pallas)"),
    # its per-region form, and one seam of the sharded CCA's fixpoint
    Kernel("region_table", "fstt_region_table", _cca.region_table, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/pallas/cca_tpu.py:145 _cc_pass_kernel "
           "(propagate_min_pallas)"),
    Kernel("seam_min", "fstt_seam_min", _cca.seam_min, "cuda",
           "fast_slic_tpu_torch/csrc/cca.cu",
           "fast_slic_tpu/pallas/cca_tpu.py:145 _cc_pass_kernel "
           "(propagate_min_pallas)"),
    # not TPU kernels: the JAX package runs this function as host C++; the
    # walk over the windows, and its bucketing by cell
    Kernel("knn", "fstt_knn", _knn.knn, "cuda",
           "fast_slic_tpu_torch/csrc/knn.cu",
           "fast_slic_tpu/native/cca_native.cpp:125 (host C++)"),
    Kernel("knn_buckets", "fstt_knn_buckets", _knn.knn_buckets, "cuda",
           "fast_slic_tpu_torch/csrc/knn.cu",
           "fast_slic_tpu/native/cca_native.cpp:125 (host C++)"),
    # not a TPU kernel: the JAX package builds the lists with XLA ops (a
    # sort of (cell, visit key) pairs)
    Kernel("candidates", "fstt_candidates", _candidates.candidates, "cuda",
           "fast_slic_tpu_torch/csrc/candidates.cu",
           "fast_slic_tpu/pipeline.py:build_candidates (XLA ops)"),
)


def reset_launches() -> None:
    for k in KERNELS:
        COUNTS["launch." + k.entry] = 0


def launch_counts() -> dict:
    """Launches of each kernel since :func:`reset_launches`, by name."""
    return {k.name: COUNTS["launch." + k.entry] for k in KERNELS}
