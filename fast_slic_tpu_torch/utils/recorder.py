"""Debug recorder: per-iteration snapshots serialized to JSON.

The counterpart of ``fast_slic_tpu/utils/recorder.py`` (the reference's
``src/recorder.h``): with ``debug_mode`` on, the loop snapshots
(assignment, min_dists, clusters) after the setup (iteration -1) and after
every iteration, and ``slic_model.last_recorder_report`` is the JSON::

    {"height": H, "width": W, "snapshots": [
        {"iteration": i, "clusters": [...], "assignment": [...],
         "min_dists": [...]}, ...]}

:class:`Recorder` keeps the snapshots on the pipeline's device and copies
them to the host once, at the end (:meth:`Recorder.to_host`);
:func:`render_report` writes the JSON byte for byte as the JAX package
does.
"""

from __future__ import annotations

import io
from typing import List, NamedTuple

import numpy as np
import torch

from ..cluster import Clusters
from .timing import to_host


def _fmt(v) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_report(H, W, iterations, assignments, min_dists, clusters_seq) -> str:
    """iterations: list of ints; assignments/min_dists: [T, H, W] arrays;
    clusters_seq: list of Clusters (numpy)."""
    out = io.StringIO()
    out.write('{"height": %d, "width": %d, "snapshots": [' % (H, W))
    for t, it in enumerate(iterations):
        if t > 0:
            out.write(",")
        st = clusters_seq[t]
        out.write('{"iteration": %d, "clusters": [' % it)
        K = st.K
        for k in range(K):
            if k > 0:
                out.write(",")
            out.write(
                '{"yx": [%s,%s], "color": [%s,%s,%s], "is_updatable": %d, '
                '"is_active": %d, "number": %d, "num_members": %d}'
                % (_fmt(st.y[k]), _fmt(st.x[k]), _fmt(st.r[k]), _fmt(st.g[k]),
                   _fmt(st.b[k]), int(st.is_updatable[k]),
                   int(st.is_active[k]), k, int(st.num_members[k]))
            )
        out.write('], "assignment": [')
        out.write(",".join(map(str, np.asarray(assignments[t]).ravel().tolist())))
        out.write('], "min_dists": [')
        md = np.asarray(min_dists[t]).ravel()
        out.write(",".join(_fmt(v) for v in md.tolist()))
        out.write("]}")
    out.write("]}")
    return out.getvalue()


class Snapshots(NamedTuple):
    """A run's snapshots on the host."""

    H: int
    W: int
    iterations: List[int]
    assignments: np.ndarray   # int32 [T, H, W]
    min_dists: np.ndarray     # [T, H, W]: int32 (standard) or f32
    clusters: List[Clusters]  # T numpy states

    def render(self) -> str:
        return render_report(self.H, self.W, self.iterations,
                             self.assignments, self.min_dists, self.clusters)


class Recorder:
    """Collects (iteration, assignment, min_dists, clusters) snapshots on
    the device.  The assignment is copied when taken (the loop rewrites it
    in place); min_dists and the cluster fields are fresh tensors each
    pass and are kept as they are."""

    def __init__(self):
        self._snaps = []

    def snap(self, iteration: int, assignment, min_dists, st: Clusters):
        self._snaps.append((iteration, assignment.clone(), min_dists, st))

    def to_host(self) -> Snapshots:
        """Stack every snapshot on the device and copy each array to the
        host once."""
        its = [s[0] for s in self._snaps]
        assignments = torch.stack([s[1] for s in self._snaps])
        H, W = assignments.shape[1:]
        fields = [torch.stack(f) for f in
                  zip(*(s[3].fields() for s in self._snaps))]
        host = Clusters(*fields).as_numpy()
        clusters = [Clusters(*(f[t] for f in host.fields()))
                    for t in range(len(its))]
        return Snapshots(int(H), int(W), its, to_host(assignments).numpy(),
                         to_host(torch.stack([s[2] for s in self._snaps])
                                 ).numpy(), clusters)
