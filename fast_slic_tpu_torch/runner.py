"""Host-side execution of the pipeline (the "binding layer").

The counterpart of ``fast_slic_tpu/runner.py:run_iterate``: moves the image
and cluster state to the device, runs :func:`pipeline.iterate_graph`,
re-runs with more candidate slots on overflow, escalates a CCA tie to the
exact selection, and returns int16 labels with -1 for unassigned.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import pipeline
from .cluster import Clusters
from .config import UNASSIGNED, RuntimeParams, StaticConfig
from .ops.cca import selection_rerun_device
from .utils.timing import Timer


class RunResult(NamedTuple):
    labels: np.ndarray       # int16 [H, W], -1 = unassigned
    clusters: Clusters       # final state (numpy)
    timing_json: str         # utils.timing report, one section per phase
    cca_tie: bool            # the tie escalation ran
    cand_slots: int          # candidate slots of the run that was kept


def run_iterate(cfg: StaticConfig, image: np.ndarray, clusters: Clusters,
                params: RuntimeParams, device) -> RunResult:
    """Execute iterate() on ``device``.

    If the pipeline flags candidate overflow (more than cand_slots clusters
    in a 3x3 cell neighbourhood), re-run at 3x the slots, capped at 48, at
    most twice (fast_slic_tpu/runner.py:71-81)."""
    device = torch.device(device)
    timer = Timer(device)
    with timer.scope("iterate"):
        scalars = pipeline.derive_scalars(cfg, params.compactness,
                                          params.min_size_factor,
                                          params.preemptive_thres)
        with timer.scope("write_to_buffer"):
            image_t = torch.from_numpy(np.ascontiguousarray(image)).to(device)
            st = clusters.to_torch(device)
        for escalation in range(3):
            out = pipeline.iterate_graph(image_t, st, cfg, scalars,
                                         params.max_iter,
                                         params.subsample_stride, timer)
            if escalation == 2 or not bool(out.cand_overflow):
                break
            cfg = dataclasses.replace(cfg,
                                      cand_slots=min(cfg.cand_slots * 3, 48))
        with timer.scope("write_back"):
            tie = bool(out.cca_tie)
            if tie:
                # component areas tie at the top-K boundary: the survivors
                # are those of the reference's std::partial_sort, which has
                # no data-parallel form; the host selects, the device
                # relabels (ops.cca.selection_rerun_device)
                fixed = selection_rerun_device(out.raw_assignment, cfg.K,
                                               int(scalars.thres))
                lab = torch.where(fixed == UNASSIGNED, -1, fixed)
            else:
                lab = out.labels
            labels = lab.cpu().numpy().astype(np.int16)
            final = out.clusters.as_numpy()
    return RunResult(labels, final, timer.report(), tie, cfg.cand_slots)
