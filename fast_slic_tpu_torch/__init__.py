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
``SlicRealDistL2``, ``SlicRealDistNoQ``, ``LSC``; the aliases ``SlicAvx2``,
``LSCAvx2``, ``SlicNeon``, ``LSCNeon``, ``SlicPallas`` and ``LSCPallas``)
with CIELAB conversion, the subsampled assign/update loop and its
preemptive grid (``preemptive=True``), the full assign and connectivity
enforcement with its exact tie escalation, the debug recorder
(``debug_mode=True``: ``slic_model.last_recorder_report``) and the
per-iteration timing report (``slic_model.profile = True``), the standalone
:func:`enforce_connectivity`, batched video frames
(``fast_slic_tpu_torch.parallel.batch.BatchedSlic``, map and stack modes),
the graph and density utilities (``SlicModel.get_connectivity``,
``get_knn_connectivity``, ``get_mask_density``,
``broadcast_density_to_mask``; the KNN is a CUDA kernel on the card) and
the temporal mean-field CRF (``SimpleCRF``, ``device="cuda"`` by default)
and device meshes (``parallel.mesh.make_mesh``; a batch over the mesh's
``data`` axis with ``BatchedSlic(mesh=...)``, one image's rows over its
``space`` axis with ``parallel.spatial_shardmap.ShardedSlicExplicit`` and
``parallel.spatial.ShardedSlic``; the shards may share one card).
"""

from .models.slic import (  # noqa: F401
    BaseSlic,
    Slic,
    SlicRealDist,
    SlicRealDistL2,
    SlicRealDistNoQ,
    LSC,
    SlicPallas,
    LSCPallas,
)
from .avx2 import LSCAvx2, SlicAvx2  # noqa: F401
from .neon import LSCNeon, SlicNeon  # noqa: F401
from .model import SlicModel  # noqa: F401
from .models.crf import SimpleCRF, SimpleCRFFrame  # noqa: F401
from .ops.graph import NodeConnectivity  # noqa: F401
from .config import get_supported_archs, is_supported_arch  # noqa: F401

supported_archs = tuple(get_supported_archs())

__version__ = "0.1.0"


def enforce_connectivity(assignments, min_threshold, device="cuda"):
    """Standalone connectivity enforcement (cfast_slic.pyx:371-396), as
    ``fast_slic_tpu.enforce_connectivity``.

    assignments: integer [H, W] label map.  Labels are cast to uint16
    (``& 0xFFFF``; 0xFFFF is unassigned) and K is the largest other label
    plus 1 (1 if there is none).  Returns the relabelled map in the input's
    dtype, also written back into the input when it is writable.  Runs
    the device CCA on ``device`` (the card by default, raising without
    one; ``"cpu"`` for the plain path), with the exact tie escalation."""
    import numpy as np
    import torch

    from .config import UNASSIGNED
    from .model import resolve_device
    from .ops.cca import enforce_connectivity_exact
    from .utils.timing import to_device, to_host

    arr = np.asarray(assignments)
    u = arr.astype(np.int64) & 0xFFFF
    labels = u[u != UNASSIGNED]
    K = int(labels.max()) + 1 if labels.size else 1
    dev = resolve_device(device)
    out, _ = enforce_connectivity_exact(
        to_device(torch.from_numpy(u.astype(np.int32)), dev), K,
        int(min_threshold))
    out = to_host(out).numpy().astype(arr.dtype)
    try:
        arr[...] = out
        return arr
    except (ValueError, TypeError):
        return out
