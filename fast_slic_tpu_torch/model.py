"""SlicModel: the persistent state of a SLIC segmenter.

The counterpart of ``fast_slic_tpu/model.py`` (reference
``cfast_slic.pyx:15-328``).  The state kept between ``iterate`` calls is
the cluster array, held on the host as numpy (each call moves it to the
model's device and back), and the candidate slots of the last kept run,
which the next call on a frame of the same shape starts at.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import cluster as cluster_lib
from . import runner
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
)
from .utils.timing import spanned

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
        # profile=True: one assign / update section an iteration in
        # last_timing_report (context.cpp:158-175), without debug_mode's
        # snapshots
        self.profile = False
        self.preemptive = False
        self.preemptive_thres = 0.05
        self.manhattan_spatial_dist = True

        self._clusters = cluster_lib.zeros(num_components)
        self.initialized = False
        self._slots = runner.CarriedSlots()
        self.last_cand_slots = None  # the slots the last iterate started at
        self.last_cca_tie = False  # the last iterate took the tie escalation
        self.last_timing_report = ""
        self.last_recorder_report = ""
        # debug_mode: the last iterate's snapshots (utils.recorder.Snapshots)
        self.last_recorder_snapshots = None
        # preemptive: the last iterate's grid activity, int32 [max_iter, 2]
        # on the device (row i: clusters active after iteration i's step,
        # pixels its masked update added; the kept run's), else None
        self.last_preemptive_activity = None

    # -- cluster state accessors (cfast_slic.pyx:45-121) --------------------

    def copy(self) -> "SlicModel":
        result = SlicModel(self.num_components, self.arch_name,
                           device=self.device)
        result._clusters = self._clusters.copy()
        result.initialized = self.initialized
        result._slots = copy.copy(self._slots)
        return result

    @property
    def clusters(self):
        return cluster_lib.clusters_to_dicts(self._clusters)

    @clusters.setter
    def clusters(self, dicts):
        self._clusters = cluster_lib.dicts_to_clusters(dicts)
        self.num_components = self._clusters.K
        self.initialized = True
        self._slots.reset()

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
        """The call's configuration; its candidate slots are those the
        model carries (runner.CarriedSlots)."""
        return StaticConfig(
            H=H, W=W, K=self.num_components,
            variant=self._variant(),
            convert_to_lab=bool(self.convert_to_lab),
            manhattan_spatial_dist=bool(self.manhattan_spatial_dist),
            float_color=bool(self.float_color),
            preemptive=bool(self.preemptive),
            debug_mode=bool(self.debug_mode),
            cand_slots=self._slots.start(H, W))

    # -- pipeline entry points ----------------------------------------------

    @spanned("entry.seed")
    def initialize(self, image) -> None:
        """Grid-seed the clusters from an image (cfast_slic.pyx:124-147)."""
        image = np.ascontiguousarray(image)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("nchan != 3")
        self._clusters = cluster_lib.initialize_clusters(
            image, self.num_components)
        self.initialized = True
        self._slots.reset()

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
            profile=bool(self.profile),
            carry=self._slots,
        )
        self._clusters = res.clusters
        self.last_cand_slots = cfg.cand_slots
        self.last_cca_tie = res.cca_tie
        self.last_timing_report = res.timing_json
        self.last_recorder_snapshots = res.snapshots
        self.last_preemptive_activity = res.preemptive_activity
        self._recorder_report = None
        return res.labels

    @property
    def last_recorder_report(self) -> str:
        """The debug recorder's JSON report of the last iterate ("" without
        debug_mode), rendered from :attr:`last_recorder_snapshots` on the
        first read."""
        if self._recorder_report is None:
            snaps = self.last_recorder_snapshots
            self._recorder_report = "" if snaps is None else snaps.render()
        return self._recorder_report

    @last_recorder_report.setter
    def last_recorder_report(self, report: str):
        self._recorder_report = report

    # -- graph / density utilities (cfast_slic.pyx:262-324) ------------------

    def get_connectivity(self, assignments):
        from .ops import graph
        nbr, lens = graph.adjacency_matrix(_host_or_tensor(assignments),
                                           self.num_components, self.device)
        return graph.NodeConnectivity(matrix=nbr, lens=lens)

    def get_knn_connectivity(self, assignments, num_neighbors):
        from .ops import graph
        nbr, lens = graph.knn(self._clusters, int(num_neighbors),
                              _host_or_tensor(assignments).shape,
                              self.device)
        return graph.NodeConnectivity(matrix=nbr, lens=lens)

    def get_mask_density(self, mask, assignments):
        from .ops import graph
        mask = _host_or_tensor(mask)
        assignments = _host_or_tensor(assignments)
        if tuple(mask.shape) != tuple(assignments.shape):
            raise ValueError(
                "The shape of mask does not match the one of assignments")
        return graph.mask_density(mask, assignments, self._clusters,
                                  self.device)

    def broadcast_density_to_mask(self, densities, assignments):
        from .ops import graph
        densities = _host_or_tensor(densities)
        if densities.shape[0] != self.num_components:
            raise ValueError(
                "The shape of densities should match the number of clusters")
        return graph.density_to_mask(densities, _host_or_tensor(assignments),
                                     self.num_components, self.device)


def _host_or_tensor(a):
    """A tensor as it is (on any device), anything else as a numpy array."""
    return a if isinstance(a, torch.Tensor) else np.asarray(a)
