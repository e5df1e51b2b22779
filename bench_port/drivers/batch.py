"""``batch``: one ``BatchedSlic``, one frame of each of ``streams``
streams a call, the labels left on the device (several cameras at once)."""

import faults as slic_faults
import loops

Loop = loops.Clips
compare = loops.compare_clips
control_entry = loops.control_entry
plant = slic_faults.plant_batch

TINY = {"config": {"height": 72, "width": 96, "num_components": 24},
        "traffic": {"clip_frames": 4, "warmup_calls": 1, "trace_calls": 2}}


def entry(cfg: dict, traffic: dict, device) -> loops.BatchEntry:
    return loops.BatchEntry(cfg, device, traffic["batch_mode"])


def faults(cfg: dict) -> tuple:
    return slic_faults.BATCH
