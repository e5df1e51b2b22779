"""``stream``: one object of the configuration's class, one frame a call,
clusters carried from call to call (a live video pipeline)."""

import faults as slic_faults
import loops

Loop = loops.Clips
compare = loops.compare_clips
control_entry = loops.control_entry
plant = slic_faults.plant_single

TINY = {"config": {"height": 72, "width": 96, "num_components": 24},
        "traffic": {"clip_frames": 4, "warmup_calls": 1, "trace_calls": 2}}


def entry(cfg: dict, traffic: dict, device) -> loops.SingleEntry:
    return loops.SingleEntry(cfg, device)


def faults(cfg: dict) -> tuple:
    """Every fault of a single entry; one pixel altered only where the
    limits hold every pixel (LSC is held to a share of them)."""
    exact = cfg["limits"].get("labels_differ_px") == 0
    return tuple(f for f in slic_faults.SINGLE
                 if exact or f != "one pixel altered")
