"""Host-side execution of the pipeline (the "binding layer").

The counterpart of ``fast_slic_tpu/runner.py:run_iterate``: moves the image
and cluster state to the device, runs :func:`pipeline.iterate_graph`,
re-runs with more candidate slots on overflow, escalates a CCA tie to the
exact selection, and returns int16 labels with -1 for unassigned, the
timing report and, under ``debug_mode``, the recorder's snapshots.

It also owns the exactness escalation of every entry (``SlicModel``,
``BatchedSlic``, ``ShardedSlicExplicit``, ``ShardedSlic``): the
candidate-slot schedule (:func:`rerun_slots`), the slots an entry carries
from call to call and its re-runs, each counted in
``utils.timing.COUNTS["runner.reruns"]`` (:class:`CarriedSlots`), and the
tie's exact labels (:func:`tie_labels`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import pipeline
from .cluster import Clusters
from .config import UNASSIGNED, RuntimeParams, StaticConfig
from .ops.cca import selection_rerun_device
from .utils.recorder import Recorder, Snapshots
from .utils.timing import COUNTS, Timer, span, to_device, to_host

# The candidate-slot schedule: a call starts at StaticConfig's default (16)
# or at the slots its entry carries; an overflow re-runs it at 3x the
# slots, capped at MAX_CAND_SLOTS; a run at MAX_CAND_SLOTS is kept even
# when it overflows, since its re-run would build the same lists.
FIRST_CAND_SLOTS = StaticConfig.cand_slots
MAX_CAND_SLOTS = 48


def rerun_slots(slots: int) -> int:
    """The slots to re-run a run that overflowed at ``slots`` with, or 0:
    a run at MAX_CAND_SLOTS is kept."""
    return min(3 * slots, MAX_CAND_SLOTS) if slots < MAX_CAND_SLOTS else 0


class CarriedSlots:
    """The candidate slots of an entry's last kept run (``slots``) on
    frames of one shape (``shape``): the entry's next call on a frame of
    that shape starts there.  A list that does not overflow is the same
    list at any slot count, so the carry changes no result, only how often
    the entry re-runs.  The count never decays: the largest is what a
    carried frame's kept run takes almost every time anyway.  The entry
    asks :meth:`start` where a call starts and :meth:`rerun` (or
    :meth:`hand_off`) whether an overflowed run is run again; those count
    every re-run in ``COUNTS["runner.reruns"]``.  The entry calls
    :meth:`reset` when it takes new cluster state; ``copy.copy`` keeps the
    count."""

    def __init__(self):
        self.shape, self.slots = None, FIRST_CAND_SLOTS

    def start(self, H: int, W: int) -> int:
        """The slots a call on an (H, W) frame starts at; a new shape goes
        back to FIRST_CAND_SLOTS."""
        if self.shape != (H, W):
            self.shape, self.slots = (H, W), FIRST_CAND_SLOTS
        return self.slots

    def reset(self) -> None:
        self.shape = None

    def rerun(self, slots: int, overflowed: bool) -> int:
        """After a run at ``slots``: the slots to run it again with
        (:func:`rerun_slots`), which the next call also starts at, or 0:
        the run is kept."""
        more = rerun_slots(slots) if overflowed else 0
        if more:
            self._rerun_at(more)
        return more

    def hand_off(self, slots: int) -> None:
        """An overflow at ``slots`` that another path runs again
        (``ShardedSlic``'s single-device run): a re-run, after which the
        next call starts no lower than :meth:`rerun` would have."""
        self._rerun_at(rerun_slots(slots) or slots)

    def _rerun_at(self, slots: int) -> None:
        COUNTS["runner.reruns"] += 1
        self.slots = max(self.slots, slots)


def tie_labels(raw, K: int, thres: int) -> torch.Tensor:
    """The labels of a frame whose CCA ties at the top-K boundary: the
    survivors are those of the reference's std::partial_sort, which has no
    data-parallel form; the host selects, the device relabels
    (``ops.cca.selection_rerun_device``).  int32 [H, W] on the device of
    ``raw`` (the pre-CCA assignment), -1 for unassigned."""
    with span("runner.tie_escalation"):
        fixed = selection_rerun_device(raw, K, thres)
        return torch.where(fixed == UNASSIGNED, -1, fixed)


class RunResult(NamedTuple):
    labels: np.ndarray       # int16 [H, W], -1 = unassigned
    clusters: Clusters       # final state (numpy)
    timing_json: str         # utils.timing report, one section per phase
    cca_tie: bool            # the tie escalation ran
    cand_slots: int          # candidate slots of the run that was kept
    snapshots: Optional[Snapshots] = None  # debug_mode: the recorder's
    # preemptive: the kept run's int32 [max_iter, 2] activity, on the device
    # (pipeline.count_activity)
    preemptive_activity: Optional[torch.Tensor] = None

    @property
    def recorder_json(self) -> str:
        """The debug recorder's JSON report ("" without debug_mode),
        rendered from the snapshots on each read."""
        return "" if self.snapshots is None else self.snapshots.render()


def run_iterate(cfg: StaticConfig, image: np.ndarray, clusters: Clusters,
                params: RuntimeParams, device, profile: bool = False,
                carry: Optional[CarriedSlots] = None) -> RunResult:
    """Execute iterate() on ``device``.

    The run starts at ``cfg.cand_slots``.  If the pipeline flags candidate
    overflow (more than cand_slots clusters in a 3x3 cell neighbourhood),
    it is re-run on the schedule of :func:`rerun_slots`
    (fast_slic_tpu/runner.py:71-81), through ``carry``, the calling
    entry's :class:`CarriedSlots` (a new one if None), which keeps the
    slots of the run that is kept.  The snapshots are those of that run.

    The timing report (fast_slic_tpu/runner.py:46-66): by default
    ``iterate`` holds ``write_to_buffer`` (the uploads), the pipeline's
    phases and ``write_back``.  ``profile`` (without ``cfg.debug_mode``)
    puts the phases under ``execute`` with one ``assign`` / ``update``
    (/ ``after_update``) section an iteration; ``cfg.debug_mode`` puts
    them under ``execute`` with the loop as one ``iteration_loop``
    section, and adds ``recorder`` (the snapshots' copy to the host).  In
    both, ``cielab_conversion`` takes the uploads."""
    device = torch.device(device)
    carry = CarriedSlots() if carry is None else carry
    timer = Timer(device)
    staged = profile or cfg.debug_mode
    with timer.scope("iterate"):
        scalars = pipeline.derive_scalars(cfg, params.compactness,
                                          params.min_size_factor,
                                          params.preemptive_thres)
        if not staged:
            with timer.scope("write_to_buffer"):
                image_t, st = _upload(image, clusters, device)
        while True:
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
            slots = carry.rerun(cfg.cand_slots, _overflowed(out))
            if not slots:
                break
            cfg = dataclasses.replace(cfg, cand_slots=slots)
        with timer.scope("write_back"):
            tie = to_host(out.cca_tie, bool)
            lab = (tie_labels(out.raw_assignment, cfg.K, int(scalars.thres))
                   if tie else out.labels)
            with span("runner.labels_to_host"):
                labels = to_host(lab).numpy().astype(np.int16)
            with span("runner.state_to_host"):
                final = out.clusters.as_numpy()
        snapshots = None
        if recorder is not None:
            with timer.scope("recorder"):
                snapshots = recorder.to_host()
    return RunResult(labels, final, timer.report(), tie, cfg.cand_slots,
                     snapshots, out.preemptive_activity)


def _overflowed(out) -> bool:
    """The host's read of the candidate-overflow flag."""
    with span("runner.overflow_check"):
        return to_host(out.cand_overflow, bool)


def _upload(image, clusters: Clusters, device):
    return (to_device(torch.from_numpy(np.ascontiguousarray(image)), device),
            clusters.to_torch(device))
