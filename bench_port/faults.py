"""Faults planted in the SLIC program's timed path, which ``correct`` has
to catch: each breaks the program's public call underneath the harness and
returns a function that takes the fault out again.  The SLIC drivers
(``drivers/stream.py``, ``stills.py``, ``batch.py``) list and plant them.

- ``state unchanged``: a call returns its labels but leaves the carried
  clusters as they were before it;
- ``answer altered``: every region shifted one column over (single
  entries), or one pixel of the last frame renumbered (the batch);
- ``one pixel altered``: the middle pixel of a frame renumbered;
- ``half the batch left out``: the second half of a batch's labels are a
  copy of the first half's.

Used through a driver by ``control.py --fault`` on the card at a cell's
own size and by the tests on the CPU.
"""

from __future__ import annotations

import numpy as np

SINGLE = ("state unchanged", "answer altered", "one pixel altered")
BATCH = ("state unchanged", "answer altered", "half the batch left out")


def plant_single(fault: str):
    """Break ``<class>.iterate`` (``runner.run_iterate``) with ``fault``;
    returns the undo function."""
    if fault not in SINGLE:
        raise ValueError("no fault %r of a single entry" % fault)
    from fast_slic_tpu_torch import runner
    real = runner.run_iterate

    def run_iterate(cfg, image, clusters, *args, **kw):
        res = real(cfg, image, clusters, *args, **kw)
        if fault == "state unchanged":
            return res._replace(clusters=clusters)
        if fault == "answer altered":
            return res._replace(labels=np.roll(res.labels, 1, axis=1))
        labels = res.labels.copy()
        labels[labels.shape[0] // 2, labels.shape[1] // 2] += 1
        return res._replace(labels=labels)

    runner.run_iterate = run_iterate
    return lambda: setattr(runner, "run_iterate", real)


def plant_batch(fault: str):
    """Break ``BatchedSlic.iterate`` with ``fault``; returns the undo
    function."""
    if fault not in BATCH:
        raise ValueError("no fault %r of the batch" % fault)
    from fast_slic_tpu_torch.parallel import batch
    real = batch.BatchedSlic.iterate

    def iterate(self, images, max_iter=10):
        if fault == "half the batch left out":
            half = images.shape[0] // 2
            labels = real(self, images, max_iter)
            labels[half:] = labels[:half]
            return labels
        before = self.state
        labels = real(self, images, max_iter)
        if fault == "state unchanged" and before is not None:
            self.state = before
        if fault == "answer altered":
            labels[-1, 0, 0] += 1
        return labels

    batch.BatchedSlic.iterate = iterate
    return lambda: setattr(batch.BatchedSlic, "iterate", real)
