"""Host-side execution of the pipeline (the "binding layer").

The counterpart of ``fast_slic_tpu/runner.py:run_iterate``: moves the image
and cluster state to the device, runs :func:`pipeline.iterate_graph`,
re-runs with more candidate slots on overflow (each re-run counted in
``utils.timing.COUNTS["runner.reruns"]``), escalates a CCA tie to the
exact selection, and returns int16 labels with -1 for unassigned, the
timing report and, under ``debug_mode``, the recorder's snapshots.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import pipeline
from .cluster import Clusters
from .config import (CAND_RERUNS, UNASSIGNED, RuntimeParams, StaticConfig,
                     more_cand_slots)
from .ops.cca import selection_rerun_device
from .utils.recorder import Recorder, Snapshots
from .utils.timing import COUNTS, Timer, span, to_device, to_host


class RunResult(NamedTuple):
    labels: np.ndarray       # int16 [H, W], -1 = unassigned
    clusters: Clusters       # final state (numpy)
    timing_json: str         # utils.timing report, one section per phase
    cca_tie: bool            # the tie escalation ran
    cand_slots: int          # candidate slots of the run that was kept
    snapshots: Optional[Snapshots] = None  # debug_mode: the recorder's

    @property
    def recorder_json(self) -> str:
        """The debug recorder's JSON report ("" without debug_mode),
        rendered from the snapshots on each read."""
        return "" if self.snapshots is None else self.snapshots.render()


def run_iterate(cfg: StaticConfig, image: np.ndarray, clusters: Clusters,
                params: RuntimeParams, device, profile: bool = False
                ) -> RunResult:
    """Execute iterate() on ``device``.

    If the pipeline flags candidate overflow (more than cand_slots clusters
    in a 3x3 cell neighbourhood), re-run at 3x the slots, capped at 48, at
    most twice (fast_slic_tpu/runner.py:71-81); a run at 48 slots is kept
    even when it overflows, since its re-run would build the same lists.
    The snapshots are those of the run that is kept.

    The timing report (fast_slic_tpu/runner.py:46-66): by default
    ``iterate`` holds ``write_to_buffer`` (the uploads), the pipeline's
    phases and ``write_back``.  ``profile`` (without ``cfg.debug_mode``)
    puts the phases under ``execute`` with one ``assign`` / ``update``
    (/ ``after_update``) section an iteration; ``cfg.debug_mode`` puts
    them under ``execute`` with the loop as one ``iteration_loop``
    section, and adds ``recorder`` (the snapshots' copy to the host).  In
    both, ``cielab_conversion`` takes the uploads."""
    device = torch.device(device)
    timer = Timer(device)
    staged = profile or cfg.debug_mode
    with timer.scope("iterate"):
        scalars = pipeline.derive_scalars(cfg, params.compactness,
                                          params.min_size_factor,
                                          params.preemptive_thres)
        if not staged:
            with timer.scope("write_to_buffer"):
                image_t, st = _upload(image, clusters, device)
        for escalation in range(CAND_RERUNS + 1):
            recorder = Recorder() if cfg.debug_mode else None
            if staged:
                with timer.scope("execute"):
                    with timer.scope("cielab_conversion"):
                        image_t, st = _upload(image, clusters, device)
                        setup = pipeline.stage_setup(image_t, st, cfg,
                                                     scalars)
                    out = pipeline.iterate_from_setup(
                        setup, cfg, scalars, params.max_iter,
                        params.subsample_stride, timer,
                        profile=profile and not cfg.debug_mode,
                        recorder=recorder)
            else:
                out = pipeline.iterate_graph(image_t, st, cfg, scalars,
                                             params.max_iter,
                                             params.subsample_stride, timer)
            slots = more_cand_slots(cfg.cand_slots)
            if (escalation == CAND_RERUNS or not _overflowed(out)
                    or slots == cfg.cand_slots):
                break
            COUNTS["runner.reruns"] += 1
            cfg = dataclasses.replace(cfg, cand_slots=slots)
        with timer.scope("write_back"):
            tie = to_host(out.cca_tie, bool)
            if tie:
                # component areas tie at the top-K boundary: the survivors
                # are those of the reference's std::partial_sort, which has
                # no data-parallel form; the host selects, the device
                # relabels (ops.cca.selection_rerun_device)
                with span("runner.tie_escalation"):
                    fixed = selection_rerun_device(out.raw_assignment, cfg.K,
                                                   int(scalars.thres))
                    lab = torch.where(fixed == UNASSIGNED, -1, fixed)
            else:
                lab = out.labels
            with span("runner.labels_to_host"):
                labels = to_host(lab).numpy().astype(np.int16)
            with span("runner.state_to_host"):
                final = out.clusters.as_numpy()
        snapshots = None
        if recorder is not None:
            with timer.scope("recorder"):
                snapshots = recorder.to_host()
    return RunResult(labels, final, timer.report(), tie, cfg.cand_slots,
                     snapshots)


def _overflowed(out) -> bool:
    """The host's read of the candidate-overflow flag."""
    with span("runner.overflow_check"):
        return to_host(out.cand_overflow, bool)


def _upload(image, clusters: Clusters, device):
    return (to_device(torch.from_numpy(np.ascontiguousarray(image)), device),
            clusters.to_torch(device))
