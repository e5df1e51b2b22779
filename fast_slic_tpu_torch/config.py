"""Configuration objects for the PyTorch/CUDA SLIC pipeline.

Mirrors ``fast_slic_tpu/config.py``: :class:`StaticConfig` holds what
shapes the computation (image size, K, variant, switches), and
:class:`RuntimeParams` the per-call scalars.

The implementation is chosen by the DEVICE of the tensors, not by the arch
name: a CPU tensor goes to each kernel's plain PyTorch version, a CUDA tensor
to the hand-written kernel (or the wrapper raises).  The arch names are
accepted for API parity with the reference and the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

# Sentinel label for "unassigned" (reference fast-slic-common.h:10).
UNASSIGNED = 0xFFFF

# Hard cap on the number of superpixels (reference cfast_slic.pyx:24-25).
MAX_NUM_COMPONENTS = 65534

VARIANT_STANDARD = "standard"
VARIANT_REAL = "real"
VARIANT_REAL_L2 = "real_l2"
VARIANT_REAL_NOQ = "real_noq"
VARIANT_LSC = "lsc"

VARIANTS = (
    VARIANT_STANDARD,
    VARIANT_REAL,
    VARIANT_REAL_L2,
    VARIANT_REAL_NOQ,
    VARIANT_LSC,
)

# Arch names accepted for API parity (the reference's CPU arch names and the
# JAX package's backend names).  All run the same code here: the device of
# the tensors decides between plain torch and the kernels.
_ARCHS = ("xla", "pallas", "standard", "x64/avx2", "arm/neon")


def check_arch(arch_name: str) -> None:
    """Raise NotImplementedError for an unknown arch name
    (cfast_slic.pyx:21-22)."""
    if arch_name not in _ARCHS:
        raise NotImplementedError("Unsupported arch " + repr(arch_name))


def is_supported_arch(arch_name: str) -> bool:
    return arch_name in _ARCHS


def get_supported_archs():
    return list(_ARCHS)


def not_ported(what: str, roadmap_item: str):
    """The error for a path outside the ported slice."""
    return NotImplementedError(
        "%s is not ported to fast_slic_tpu_torch yet (ROADMAP.md, Open items "
        "%s); use fast_slic_tpu for it" % (what, roadmap_item))


@dataclasses.dataclass(frozen=True)
class StaticConfig:
    """Shape-level configuration of one iterate() call."""

    H: int
    W: int
    K: int
    variant: str = VARIANT_STANDARD
    convert_to_lab: bool = True
    manhattan_spatial_dist: bool = True
    float_color: bool = True   # ContextRealDistNoQ.float_color (no-op; context.h:116)
    preemptive: bool = False   # the preemptive grid (preemptive.h)
    # Per-cell candidate list length (see pipeline.build_candidates); an
    # overflow is flagged and the runner re-runs with 3x the slots (max 48).
    cand_slots: int = 16

    @property
    def S(self) -> int:
        """Superpixel sampling interval floor(sqrt(H*W/K)), min 1
        (reference context.h:60)."""
        if self.K <= 0:
            return 1
        return max(1, int(math.sqrt(self.H * self.W // self.K)))

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise RuntimeError("No such real_dist_type " + repr(self.variant))
        if self.cand_slots >= 128:
            raise ValueError("cand_slots must fit in 7 bits")


@dataclasses.dataclass
class RuntimeParams:
    """Per-call scalars; defaults mirror fast_slic/base_slic.py:6-17."""

    compactness: float = 10.0
    min_size_factor: float = 0.25
    subsample_stride: int = 3
    max_iter: int = 10
    preemptive_thres: float = 0.05
