"""SimpleCRF: temporal mean-field CRF over superpixel graphs.

The counterpart of ``fast_slic_tpu/models/crf.py`` (reference
``simple-crf.{h,hpp,cpp}``, Python face ``csimple_crf.pyx``).  Frames keep
their state on the host as numpy; :meth:`SimpleCRF.inference` stacks them
into ``[T, C, N]`` tensors on the CRF's device and runs the whole
mean-field loop there, leaving the posteriors on the device until a frame
asks for them.

Graph representation: a neighbour-index matrix ``[N, D]`` padded with -1
(the SLIC adjacency is capped at 12 neighbours, fast-slic.cpp:17).  The
message of node i is a gather over its D neighbours,
``msg[t, c, i] = sum_d w[t, i, d] * q[t, c, nbr[t, i, d]]``: the same sum the
JAX package takes as a product with a densified ``[T, N, N]`` matrix, a
TPU workaround.  Everything is float32 and no step is a matrix product, so
TF32 never applies.

Tracing (``utils/timing``): ``push_slic_frame`` runs in the span
``fstt.crf.push``; each :meth:`SimpleCRF.inference` is a timer section
``crf_inference`` (span ``fstt.crf.inference``) with the children
``crf_stage``, ``crf_energies`` and ``crf_meanfield`` (spans
``fstt.crf.stage``, ``.energies``, ``.meanfield``), and the posteriors'
download is the span ``fstt.crf.posteriors_to_host``.  Every transfer goes
through ``to_device`` / ``to_host``, which count it in ``COUNTS``.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..model import resolve_device
from ..utils.timing import Timer, span, spanned, to_device, to_host


class CRFParams:
    """Mirror of SimpleCRFParams with reference defaults (simple-crf.hpp:80-88)."""

    FIELDS = ("spatial_w", "temporal_w", "spatial_srgb", "temporal_srgb",
              "spatial_sxy", "spatial_smooth_w", "spatial_smooth_sxy")

    def __init__(self):
        self.spatial_w = 10.0
        self.temporal_w = 10.0
        self.spatial_srgb = 13.0
        self.temporal_srgb = 13.0
        self.spatial_sxy = 80.0
        self.spatial_smooth_w = 0.0
        self.spatial_smooth_sxy = 3.0

    def as_array(self):
        return np.array([getattr(self, f) for f in self.FIELDS], np.float32)


def _spatial_energy(c1, c2, p):
    """calc_spatial_pairwise_energy (simple-crf.hpp:149-174).

    c1, c2: [..., 6] (y, x, m, r, g, b) float32.  p: float32 params [7].
    """
    dy = (c1[..., 0] - c2[..., 0]) / p[4]
    dx = (c1[..., 1] - c2[..., 1]) / p[4]
    dr = (c1[..., 3] - c2[..., 3]) / p[2]
    dg = (c1[..., 4] - c2[..., 4]) / p[2]
    db = (c1[..., 5] - c2[..., 5]) / p[2]
    expo = -(dr * dr + dg * dg + db * db) / 2.0 - (dx * dx + dy * dy) / 2.0
    sdy = (c1[..., 0] - c2[..., 0]) / p[6]
    sdx = (c1[..., 1] - c2[..., 1]) / p[6]
    sexpo = -(sdx * sdx + sdy * sdy) / 2.0
    return p[0] * torch.exp(expo) + p[5] * torch.exp(sexpo)


def _temporal_energy(c1, c2, p):
    """calc_temporal_pairwise_energy (simple-crf.hpp:135-147)."""
    dr = (c1[..., 3] - c2[..., 3]) / p[3]
    dg = (c1[..., 4] - c2[..., 4]) / p[3]
    db = (c1[..., 5] - c2[..., 5]) / p[3]
    return p[1] * torch.exp(-(dr * dr + dg * dg + db * db) / 2.0)


def _energies(yxmrgb, nbr, p):
    """The graph's pairwise weights, staged once per (graph, params).

    yxmrgb: [T, N, 6]; nbr: [T, N, D] (-1 pad); p: float32 params [7].
    Returns (gather index [T, 1, N*D], w_s [T, N, D], w_prev [T-1, N],
    w_next [T-1, N]; None for both at T=1)."""
    T, N, D = nbr.shape
    dev = yxmrgb.device
    valid = nbr >= 0
    safe = torch.where(valid, nbr, 0).to(torch.int64)
    t_idx = torch.arange(T, device=dev)[:, None, None]

    m = yxmrgb[..., 2]                                       # [T, N]
    m_center = torch.clamp(m, min=1.0)                       # <=0 -> 1
    nbr_feat = yxmrgb[t_idx, safe]                           # [T, N, D, 6]
    center = yxmrgb[:, :, None, :]                           # [T, N, 1, 6]
    e_s = _spatial_energy(nbr_feat, center, p)               # [T, N, D]
    # self-pairs contribute 0 (node_i == node_j guard, hpp:150)
    not_self = safe != torch.arange(N, device=dev)[None, :, None]
    e_s = torch.where(valid & not_self, e_s, 0.0)
    m_nbr = m[t_idx, safe]                                   # [T, N, D]
    w_s = torch.where(valid, e_s * torch.sqrt(m_nbr / m_center[:, :, None]),
                      0.0)

    # temporal energies between consecutive frames: e_t[t] couples t+1, t
    if T > 1:
        e_t = _temporal_energy(yxmrgb[1:], yxmrgb[:-1], p)  # [T-1, N]
        w_prev = e_t * torch.sqrt(m[:-1] / m_center[1:])     # into frame t+1
        w_next = e_t * torch.sqrt(m[1:] / m_center[:-1])     # into frame t
    else:
        w_prev = w_next = None
    return safe.reshape(T, 1, N * D), w_s, w_prev, w_next


def _class_sum(a):
    """Sum of [T, C, N] over the classes, added in class order as XLA
    reduces that axis on the CPU.  A tree or vectorised sum rounds
    otherwise, and over the mean-field rounds that doubled the port's
    distance from the JAX posteriors at 720p (2.2e-4 against 1.0e-4
    relative, past the 2e-4 of the tests).  On the card one cumsum does it:
    PyTorch's CUDA scan over an outer axis adds each column in order in
    float32 (tests/test_torch_gpu.py holds it to the loop); on the CPU its
    cumsum accumulates in float64, so the classes are added one by one.
    That order is PyTorch's implementation, not its contract: a release
    that scans otherwise moves the posteriors, and the GPU test and
    chip_smoke.py's crf phase show it (ROADMAP.md §3)."""
    if a.is_cuda:
        # the whole [T, C, N] prefix is written only to read its last
        # plane: torch has no ordered sum over an axis, and this is one
        # launch where a loop over the C classes is C
        return torch.cumsum(a, 1)[:, -1:]
    s = a[:, :1]
    for c in range(1, a.shape[1]):
        s = s + a[:, c:c + 1]
    return s


def _meanfield(q, unaries, energies, compat, max_iter: int):
    """``max_iter`` rounds of infer_once (simple-crf.cpp:62-151) on
    [T, C, N] posteriors."""
    idx, w_s, w_prev, w_next = energies
    T, C, N = unaries.shape
    D = w_s.shape[-1]
    idx = idx.expand(T, C, N * D)
    w = w_s[:, None]                                         # [T, 1, N, D]
    compat = compat[None, :, None]
    for _ in range(max_iter):
        msg = (torch.gather(q, 2, idx).reshape(T, C, N, D) * w).sum(-1)
        if T > 1:
            msg[1:] += w_prev[:, None, :] * q[:-1]
            msg[:-1] += w_next[:, None, :] * q[1:]
        # Potts compatibility transform (simple-crf.cpp:105-114)
        cm = compat * msg
        gathered = _class_sum(cm) - cm
        new_q = torch.exp(-(unaries + gathered))
        sums = torch.clamp(_class_sum(new_q), min=1e-5)
        q = new_q / sums
    return q


class SimpleCRFFrame:
    """One time-frame: cluster features, adjacency, unaries, inferred q.

    State lives in numpy on the host between calls; inference stacks all
    frames onto the device (csimple_crf.pyx:66-239 API surface).
    """

    def __init__(self, parent_crf, time):
        self.parent_crf = parent_crf  # keeps the CRF alive (GC parity)
        self.time = time
        C, N = parent_crf.num_classes, parent_crf.num_nodes
        self.num_classes = C
        self.num_nodes = N
        self._yxmrgb = np.zeros([N, 6], np.float32)
        self._yxmrgb[:, 2] = 1.0  # num_members = 1 (simple-crf.hpp:30-32)
        self._nbr = np.full([N, 1], -1, np.int32)   # padded neighbour matrix
        self._lens = np.zeros([N], np.int64)
        self._unaries = np.zeros([C, N], np.float32)
        # posterior state: "host" (in self._q), "device" (a slice of a
        # [T, C, N] stack left on the device by inference()), or "unary"
        # (implied q = exp(-unary), reset_inferred not yet materialized)
        self._q = np.zeros([C, N], np.float32)
        self._q_mode = "host"
        self._q_stack = None   # (device stack, index) when mode == "device"

    # -- cluster features ----------------------------------------------------

    def _invalidate(self):
        if self.parent_crf is not None:
            self.parent_crf._cache = None

    def set_yxmrgb(self, yxmrgb):
        self._invalidate()
        arr = np.asarray(yxmrgb)
        if arr.shape[0] != self.num_nodes:
            raise ValueError(
                "Expected the first dimension of yxmrgb to equal to {}".format(
                    self.num_nodes))
        if arr.shape[1] != 6:
            raise ValueError(
                "Expected the second dimension of yxmrgb to equal to 6")
        # int32 truncation of inputs, then float storage (csimple_crf.pyx:111-121)
        self._yxmrgb = arr.astype(np.int32).astype(np.float32)

    def get_yxmrgb(self):
        return self._yxmrgb.tolist()

    # -- connectivity --------------------------------------------------------

    def set_connectivity(self, connectivity):
        self._invalidate()
        if hasattr(connectivity, "matrix"):
            nbr, lens = connectivity.matrix()
            if nbr.shape[0] != self.num_nodes:
                raise ValueError("Expected len(connectivity) to be {}".format(
                    self.num_nodes))
            self._nbr = nbr
            self._lens = lens
            return
        lists = (connectivity.tolist()
                 if hasattr(connectivity, "tolist") else connectivity)
        if len(lists) != self.num_nodes:
            raise ValueError("Expected len(connectivity) to be {}".format(
                self.num_nodes))
        from ..ops.graph import NodeConnectivity
        self._nbr, self._lens = NodeConnectivity(lists).matrix()

    def get_connectivity(self):
        return [self._nbr[i, :self._lens[i]].tolist()
                for i in range(self.num_nodes)]

    def connected_nodes(self, node):
        return self._nbr[node, :self._lens[node]].tolist()

    # -- unaries (simple-crf.cpp:34-55) --------------------------------------

    @property
    def unaries(self):
        return self._unaries.copy()

    @unaries.setter
    def unaries(self, new_value):
        self._invalidate()
        self._check_dimension(new_value)
        self._unaries = np.array(new_value, np.float32)

    def set_unbiased(self):
        self._invalidate()
        self._unaries[:] = np.log(np.float32(self.num_classes))

    def set_mask(self, classes, confidence):
        classes = np.asarray(classes)
        if classes.shape[0] != self.num_nodes:
            raise ValueError(
                "The dimension of class array should match the number of "
                "nodes {}".format(self.num_nodes))
        C = self.num_classes
        lowest = 1.0 / C
        active_p = lowest + (1 - lowest) * confidence
        inactive_p = (1 - active_p) / (C - 1)
        self._invalidate()
        self._unaries[:] = -np.log(np.float32(inactive_p))
        self._unaries[classes, np.arange(self.num_nodes)] = -np.log(
            np.float32(active_p))

    def set_proba(self, proba):
        self._invalidate()
        self._check_dimension(proba)
        self._unaries = -np.log(np.asarray(proba, np.float32))

    def get_unary(self):
        return self._unaries.copy()

    # -- state ---------------------------------------------------------------

    def reset_inferred(self):
        # lazy: inference() computes exp(-unary) on the device when every
        # frame is in this state, so a streaming initialize();inference()
        # cycle uploads nothing (simple-crf.cpp:153-157 semantics preserved)
        self._q_mode = "unary"
        self._q_stack = None

    def _materialize_q(self):
        if self._q_mode == "unary":
            self._q = np.exp(-self._unaries)
        elif self._q_mode == "device":
            stack, idx = self._q_stack
            self._q = self.parent_crf._download_stack(stack)[idx].copy()
        self._q_mode = "host"
        self._q_stack = None
        return self._q

    def get_inferred(self):
        return self._materialize_q().copy()

    def normalize(self):
        q = self._materialize_q()
        s = q.sum(axis=0, keepdims=True)
        self._q = q / s

    # -- pairwise energies (host-side singles for API parity) ----------------

    def spatial_pairwise_energy(self, node_i, node_j):
        if node_i >= self.num_nodes or node_j >= self.num_nodes:
            raise ValueError("node number is out of range")
        if node_i == node_j:
            return 0.0
        p = torch.from_numpy(self.parent_crf.params.as_array())
        return float(_spatial_energy(
            torch.from_numpy(self._yxmrgb[node_i]),
            torch.from_numpy(self._yxmrgb[node_j]), p))

    def temporal_pairwise_energy(self, node_i, other):
        if not isinstance(other, SimpleCRFFrame):
            raise TypeError("not a crf frame")
        if node_i >= self.num_nodes:
            raise ValueError("node number is out of range")
        if other is self:
            return 0.0
        p = torch.from_numpy(self.parent_crf.params.as_array())
        return float(_temporal_energy(
            torch.from_numpy(self._yxmrgb[node_i]),
            torch.from_numpy(other._yxmrgb[node_i]), p))

    @property
    def space_size(self):
        return self.num_classes * self.num_nodes

    def _check_dimension(self, arr):
        arr = np.asarray(arr)
        if arr.shape[0] != self.num_classes:
            raise ValueError(
                "The first dimension of array should match the number of "
                "classes {}".format(self.num_classes))
        if arr.shape[1] != self.num_nodes:
            raise ValueError(
                "The second dimension of array should match the number of "
                "nodes {}".format(self.num_nodes))


class SimpleCRF:
    """Deque of frames + params, with batched inference on ``device``
    (simple-crf.hpp:69-133).  ``device="cuda"`` (the default) raises when
    there is no GPU; pass ``device="cpu"`` for the CPU."""

    def __init__(self, num_classes, num_nodes, device="cuda"):
        self.num_classes = int(num_classes)
        self.num_nodes = int(num_nodes)
        self.device = resolve_device(device)
        self.params = CRFParams()
        self.compat_by_class = np.ones([self.num_classes], np.float32)
        self._frames = OrderedDict()  # time -> frame
        self._next_time = 0
        self._cache = None  # device-side (nbr, yxmrgb, unaries) staging
        self._dl_cache = None  # (device stack, host copy) of posteriors
        self._energy_cache = None  # staged energies per graph+params
        self._compat_cache = None  # (compat key, device tensor)
        self._timer = None  # the last inference's

    # params as properties, mirroring csimple_crf.pyx:248-302
    def _param_prop(name):  # noqa: N805
        def get(self):
            return getattr(self.params, name)

        def set_(self, v):
            setattr(self.params, name, float(v))

        return property(get, set_)

    spatial_w = _param_prop("spatial_w")
    temporal_w = _param_prop("temporal_w")
    spatial_srgb = _param_prop("spatial_srgb")
    temporal_srgb = _param_prop("temporal_srgb")
    spatial_sxy = _param_prop("spatial_sxy")
    spatial_smooth_w = _param_prop("spatial_smooth_w")
    spatial_smooth_sxy = _param_prop("spatial_smooth_sxy")
    del _param_prop

    @property
    def first_time(self):
        return next(iter(self._frames), -1)

    @property
    def last_time(self):
        return next(reversed(self._frames), -1)

    @property
    def num_frames(self):
        return len(self._frames)

    @property
    def space_size(self):
        return self.num_classes * self.num_nodes

    def push_frame(self):
        self._cache = None
        t = self._next_time
        self._next_time += 1
        frame = SimpleCRFFrame(self, t)
        self._frames[t] = frame
        return frame

    def pop_frame(self):
        self._cache = None
        if not self._frames:
            return -1
        t, _ = self._frames.popitem(last=False)
        return t

    def get_frame(self, time):
        try:
            return self._frames[time]
        except KeyError:
            raise IndexError("Time out of range") from None

    @spanned("crf.push")
    def push_slic_frame(self, slic, knn=None):
        """Wire a Slic result into a new frame (csimple_crf.pyx:326-334)."""
        frame = self.push_frame()
        frame.set_yxmrgb(slic.slic_model.to_yxmrgb())
        if knn is None:
            frame.set_connectivity(
                slic.slic_model.get_connectivity(slic.last_assignment))
        else:
            frame.set_connectivity(
                slic.slic_model.get_knn_connectivity(slic.last_assignment, knn))
        frame.set_unbiased()
        return frame

    def initialize(self):
        for f in self._frames.values():
            f.reset_inferred()

    def _download_stack(self, stack):
        """Host copy of a device posterior stack, cached per stack object
        (one [T, C, N] device->host transfer no matter how many frames
        materialize from it)."""
        if self._dl_cache is None or self._dl_cache[0] is not stack:
            with span("crf.posteriors_to_host"):
                self._dl_cache = (stack, to_host(stack).numpy())
        return self._dl_cache[1]

    @property
    def last_timing_report(self) -> str:
        """The last :meth:`inference` as the reference's nested JSON: the
        section ``crf_inference`` (durations in microseconds; on the card
        device time between CUDA events) with ``crf_stage``,
        ``crf_energies`` and ``crf_meanfield``, and under ``counters`` the
        host syncs and bytes that it moved (its staging).  "" before any
        inference.  Reading it synchronises with the device."""
        return "" if self._timer is None else self._timer.report()

    def inferred_stack(self):
        """The [T, C, N] float32 posteriors left on the device by the last
        :meth:`inference`, or None if no inference ran (or a frame has
        since materialized or mutated its q on the host).  A consumer on
        the device reads this instead of each frame's ``get_inferred()``,
        which copies the whole stack to the host."""
        frames = list(self._frames.values())
        if not frames:
            return None
        f0 = frames[0]
        if f0._q_mode != "device" or f0._q_stack is None:
            return None
        stack = f0._q_stack[0]
        if all(f._q_mode == "device" and f._q_stack is not None
               and f._q_stack[0] is stack and f._q_stack[1] == t
               for t, f in enumerate(frames)):
            return stack
        return None

    def _compat(self):
        key = tuple(float(v) for v in self.compat_by_class)
        if self._compat_cache is None or self._compat_cache[0] != key:
            self._compat_cache = (key, to_device(
                torch.tensor(key, dtype=torch.float32), self.device))
        return self._compat_cache[1]

    def inference(self, max_iter):
        """Mean-field inference over all frames on the device
        (N x infer_once, simple-crf.cpp:62-151).

        The graph and unary staging is cached until a frame mutates, the
        pairwise weights per (graph, params), and the posteriors stay on
        the device between calls (a repeat inference continues from the
        device stack, an initialize() starts from exp(-unary) computed on
        the device); nothing is copied back until some frame's
        get_inferred() asks.  A steady ``initialize(); inference(n)``
        cycle uploads nothing."""
        if not self._frames:
            return
        timer = Timer(self.device)
        with timer.scope("crf_inference", "crf.inference"):
            self._inference(timer, int(max_iter))
        self._timer = timer

    def _inference(self, timer, max_iter: int):
        frames = list(self._frames.values())
        T, N = len(frames), self.num_nodes
        dev = self.device
        with timer.scope("crf_stage", "crf.stage"):
            if self._cache is None:
                D = max(1, max(int(f._nbr.shape[1]) for f in frames))
                nbr = np.full([T, N, D], -1, np.int32)
                for t, f in enumerate(frames):
                    nbr[t, :, : f._nbr.shape[1]] = f._nbr
                self._cache = tuple(
                    to_device(torch.from_numpy(a), dev) for a in (
                        nbr, np.stack([f._yxmrgb for f in frames]),
                        np.stack([f._unaries for f in frames])))
        nbr_d, yxmrgb_d, unaries_d = self._cache

        with timer.scope("crf_energies", "crf.energies"):
            params = self.params.as_array()
            params_key = tuple(float(v) for v in params)
            if (self._energy_cache is None
                    or self._energy_cache[0] is not self._cache
                    or self._energy_cache[1] != params_key):
                energies = _energies(yxmrgb_d, nbr_d, to_device(
                    torch.from_numpy(params), dev))
                self._energy_cache = (self._cache, params_key, energies)
            energies = self._energy_cache[2]

        with timer.scope("crf_meanfield", "crf.meanfield"):
            modes = {f._q_mode for f in frames}
            if modes == {"unary"}:
                q_in = torch.exp(-unaries_d)
            elif modes == {"device"} and all(
                    f._q_stack is not None
                    and f._q_stack[0] is frames[0]._q_stack[0]
                    and f._q_stack[1] == t for t, f in enumerate(frames)):
                q_in = frames[0]._q_stack[0]  # continue from the device stack
            else:
                q_in = to_device(torch.from_numpy(np.stack(
                    [f._materialize_q() for f in frames])), dev)
            out = _meanfield(q_in, unaries_d, energies, self._compat(),
                             max_iter)
        self._dl_cache = None
        for t, f in enumerate(frames):
            f._q_mode = "device"
            f._q_stack = (out, t)
