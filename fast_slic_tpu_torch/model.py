"""SlicModel: the persistent state of a SLIC segmenter.

The counterpart of ``fast_slic_tpu/model.py`` (reference
``cfast_slic.pyx:15-328``).  The only state kept between ``iterate`` calls
is the cluster array, held on the host as numpy; each call moves it to the
model's device and back.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cluster as cluster_lib
from .config import (
    MAX_NUM_COMPONENTS,
    VARIANT_LSC,
    VARIANT_REAL,
    VARIANT_REAL_L2,
    VARIANT_REAL_NOQ,
    VARIANT_STANDARD,
    RuntimeParams,
    StaticConfig,
    check_arch,
    not_ported,
)

_REAL_DIST_TO_VARIANT = {
    "standard": VARIANT_REAL,
    "l2": VARIANT_REAL_L2,
    "noq": VARIANT_REAL_NOQ,
    "lsc": VARIANT_LSC,
}


def resolve_device(device) -> torch.device:
    """torch.device for ``device``; a CUDA device without a GPU raises
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path" % str(device))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r" % str(device))
    return dev


class SlicModel:
    """Owns Cluster[K]; runs the pipeline on ``device``.

    Matches the reference constructor contract (cfast_slic.pyx:16-43): an
    unsupported arch raises NotImplementedError, K outside (0, 65534)
    raises ValueError.
    """

    def __init__(self, num_components: int, arch_name: str = "standard",
                 real_dist: bool = False, device="cuda"):
        check_arch(arch_name)
        if num_components >= MAX_NUM_COMPONENTS:
            raise ValueError("num_components cannot exceed 65534")
        if num_components <= 0:
            raise ValueError("num_components should be a non-negative integer")
        self.device = resolve_device(device)

        self.num_components = num_components
        self.num_threads = -1  # accepted for API parity; no-op
        self.arch_name = arch_name
        self.real_dist = real_dist
        self.real_dist_type = "standard"
        self.convert_to_lab = False
        self.float_color = True
        self.debug_mode = False
        self.profile = False
        self.preemptive = False
        self.preemptive_thres = 0.05
        self.manhattan_spatial_dist = True

        self._clusters = cluster_lib.zeros(num_components)
        self.initialized = False
        self.last_cca_tie = False  # the last iterate took the tie escalation
        self.last_timing_report = ""

    # -- cluster state accessors (cfast_slic.pyx:45-121) --------------------

    def copy(self) -> "SlicModel":
        result = SlicModel(self.num_components, self.arch_name,
                           device=self.device)
        result._clusters = self._clusters.copy()
        result.initialized = self.initialized
        return result

    @property
    def clusters(self):
        return cluster_lib.clusters_to_dicts(self._clusters)

    @clusters.setter
    def clusters(self, dicts):
        self._clusters = cluster_lib.dicts_to_clusters(dicts)
        self.num_components = self._clusters.K
        self.initialized = True

    def to_yxmrgb(self):
        return cluster_lib.to_yxmrgb(self._clusters)

    # -- configuration -------------------------------------------------------

    def _variant(self) -> str:
        if not self.real_dist:
            return VARIANT_STANDARD
        try:
            return _REAL_DIST_TO_VARIANT[self.real_dist_type]
        except KeyError:
            raise RuntimeError(
                "No such real_dist_type " + repr(self.real_dist_type)
            ) from None

    def _static_config(self, H: int, W: int) -> StaticConfig:
        if self.debug_mode:
            raise not_ported("debug_mode=True", "§1.15")
        if self.profile:
            raise not_ported("profile=True", "§1.15")
        return StaticConfig(
            H=H, W=W, K=self.num_components,
            variant=self._variant(),
            convert_to_lab=bool(self.convert_to_lab),
            manhattan_spatial_dist=bool(self.manhattan_spatial_dist),
            float_color=bool(self.float_color),
            preemptive=bool(self.preemptive),
        )

    # -- pipeline entry points ----------------------------------------------

    def initialize(self, image) -> None:
        """Grid-seed the clusters from an image (cfast_slic.pyx:124-147)."""
        image = np.ascontiguousarray(image)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("nchan != 3")
        self._clusters = cluster_lib.initialize_clusters(
            image, self.num_components)
        self.initialized = True

    def iterate(self, image, max_iter, compactness, min_size_factor,
                subsample_stride):
        """Run the full pipeline; returns int16 [H, W] labels with -1 for
        unassigned (cfast_slic.pyx:150-260)."""
        if not self.initialized:
            raise RuntimeError("Slic model is not initialized")
        image = np.ascontiguousarray(image, dtype=np.uint8)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("nchan != 3")
        H, W = int(image.shape[0]), int(image.shape[1])
        cfg = self._static_config(H, W)

        from . import runner
        res = runner.run_iterate(
            cfg, image, self._clusters,
            RuntimeParams(
                compactness=float(compactness),
                min_size_factor=float(min_size_factor),
                subsample_stride=int(subsample_stride),
                max_iter=int(max_iter),
                preemptive_thres=float(self.preemptive_thres),
            ),
            self.device,
        )
        self._clusters = res.clusters
        self.last_cca_tie = res.cca_tie
        self.last_timing_report = res.timing_json
        return res.labels

    # -- graph / density utilities (cfast_slic.pyx:262-324) ------------------

    def get_connectivity(self, assignments):
        raise not_ported("get_connectivity", "§1.10")

    def get_knn_connectivity(self, assignments, num_neighbors):
        raise not_ported("get_knn_connectivity", "§1.10")

    def get_mask_density(self, mask, assignments):
        raise not_ported("get_mask_density", "§1.10")

    def broadcast_density_to_mask(self, densities, assignments):
        raise not_ported("broadcast_density_to_mask", "§1.10")
