"""``stream_preemptive``: ``stream`` with fast-slic's preemptive grid on.
One object of the configuration's class, built with its ``preemptive``
and ``preemptive_thres``, one frame a call, clusters carried from call to
call (a live video pipeline that exits early where the clusters have
settled); judged against ``reference/slic_preemptive_ref.py``.

Its entry's report carries the grid's activity of the call
(``SlicModel.last_preemptive_activity``, copied to the host only when the
report is read: traced calls), which ``metrics/preemptive.*`` read."""

from __future__ import annotations

import dataclasses
import json

import torch

import faults as slic_faults
import loops
from reference import slic_preemptive_ref, slic_ref

Loop = loops.Clips

# a size at which the grid deactivates clusters and masks cells
TINY = {"config": {"height": 96, "width": 128, "num_components": 48},
        "traffic": {"clip_frames": 4, "warmup_calls": 1, "trace_calls": 2}}

GRID_IGNORED = "grid ignored"


def params(cfg: dict) -> slic_preemptive_ref.Params:
    return slic_preemptive_ref.Params(
        **dataclasses.asdict(loops.params(cfg)),
        preemptive_thres=float(cfg["preemptive_thres"]))


class Entry(loops.SingleEntry):
    """``<class>(num_components=K, ..., preemptive=..., preemptive_thres=...)
    .iterate(frame)`` of the program."""

    def __init__(self, cfg: dict, device):
        import fast_slic_tpu_torch as fst
        cls = getattr(fst, cfg["class"])
        self.cfg = cfg
        self.obj = cls(num_components=cfg["num_components"],
                       compactness=cfg["compactness"],
                       min_size_factor=cfg["min_size_factor"],
                       subsample_stride=cfg["subsample_stride"],
                       preemptive=cfg["preemptive"],
                       preemptive_thres=cfg["preemptive_thres"],
                       device=device)

    def report(self):
        """The timing report, with the call's activity rows under
        ``"preemptive_activity"`` where the program keeps them."""
        model = self.obj.slic_model
        rep = model.last_timing_report
        act = getattr(model, "last_preemptive_activity", None)
        if not rep or act is None:
            return rep
        out = json.loads(rep)
        out["preemptive_activity"] = act.tolist()
        return json.dumps(out)


def entry(cfg: dict, traffic: dict, device) -> Entry:
    return Entry(cfg, device)


class ReferenceEntry(loops.ReferenceEntry):
    """The preemptive reference in the program's place (the control)."""

    def __init__(self, cfg: dict, device, opts: slic_preemptive_ref.Options):
        super().__init__(cfg, device, slic_ref.Options())
        self.p, self.grid = params(cfg), opts

    def call(self, images):
        if self.st is None:
            self.st = slic_ref.seed_state(images, self.p.K, self.device)
        out = slic_preemptive_ref.iterate(
            torch.from_numpy(images).to(self.device), self.st, self.p,
            self.grid, self.tables)
        return out.to(torch.int16).cpu().numpy()


def control_entry(cfg: dict, traffic: dict, device) -> ReferenceEntry:
    """The configuration's ``"control"``: the reference without the
    grid."""
    return ReferenceEntry(cfg, device,
                          slic_preemptive_ref.Options(**cfg["control"]))


def faults(cfg: dict) -> tuple:
    """Every fault of a single entry, and the program run with the grid
    switched off."""
    return slic_faults.SINGLE + (GRID_IGNORED,)


def plant(fault: str):
    """Plant ``fault`` in ``runner.run_iterate``; returns the undo."""
    if fault != GRID_IGNORED:
        return slic_faults.plant_single(fault)
    from fast_slic_tpu_torch import runner
    real = runner.run_iterate

    def run_iterate(cfg, *args, **kw):
        return real(dataclasses.replace(cfg, preemptive=False), *args, **kw)

    runner.run_iterate = run_iterate
    return lambda: setattr(runner, "run_iterate", real)


class Judge(loops.Judge):
    """``loops.Judge`` with the preemptive reference's calls."""

    def __init__(self, cfg: dict, device):
        super().__init__(cfg, device)
        self.p = params(cfg)

    def run(self, images, st: slic_ref.State):
        lab = slic_preemptive_ref.iterate(
            torch.from_numpy(images).to(self.device), st, self.p,
            tables=self.tables)
        return lab, st.yxmrgb()


def compare(loop: loops.Clips, kept: dict, device) -> dict:
    """``loops.compare_clips`` with the preemptive reference: every call up
    to the last kept one replayed from the seeding."""
    judge = Judge(loop.cfg, device)
    st = None
    for t in range(max(kept) + 1 if kept else 0):
        images, _ = loop.images(t)
        if st is None:
            st = judge.seed(images)
        ref = judge.run(images, st)
        if t in kept:
            judge(*kept[t][:2], *ref)
    return judge.out
