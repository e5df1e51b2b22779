"""fast_slic_tpu_torch — the SLIC superpixel pipeline in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The port of ``fast_slic_tpu`` (JAX on a TPU), which stays the reference it
is tested against.  It imports torch and numpy, never jax.

Dispatch rule: the device decides.  ``Slic(..., device="cuda")`` (the
default) runs every per-pixel stage through a CUDA kernel of
``fast_slic_tpu_torch/csrc`` and raises without a GPU; ``device="cpu"``
runs each kernel's plain PyTorch version.  The arch names ("standard",
"x64/avx2", "arm/neon", "xla", "pallas") are accepted for API parity.

Ported: every distance variant (``Slic``; ``SlicRealDist``,
``SlicRealDistL2``, ``SlicRealDistNoQ``, ``LSC``) with CIELAB conversion,
the subsampled assign/update loop and its preemptive grid
(``preemptive=True``), the full assign and connectivity enforcement with
its exact tie escalation, and batched video frames
(``fast_slic_tpu_torch.parallel.batch.BatchedSlic``, map and stack modes).
Debug/profile reports, multi-device meshes and the graph utilities raise
NotImplementedError naming their ROADMAP.md item.
"""

from .models.slic import (  # noqa: F401
    BaseSlic,
    Slic,
    SlicRealDist,
    SlicRealDistL2,
    SlicRealDistNoQ,
    LSC,
)
from .avx2 import LSCAvx2, SlicAvx2  # noqa: F401
from .neon import LSCNeon, SlicNeon  # noqa: F401
from .model import SlicModel  # noqa: F401
from .config import get_supported_archs, is_supported_arch  # noqa: F401

supported_archs = tuple(get_supported_archs())

__version__ = "0.1.0"
