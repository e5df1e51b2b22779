"""Cluster (superpixel centroid) state as a struct of arrays.

The counterpart of ``fast_slic_tpu/cluster.py`` without the JAX pytree
registration.  Fields hold numpy arrays on the host (the state a
``SlicModel`` keeps between calls) or torch tensors on a device (inside the
pipeline); :meth:`Clusters.to_torch` and :meth:`Clusters.as_numpy` move
between the two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from .config import MAX_NUM_COMPONENTS
from .utils.timing import to_device, to_host

_FIELDS = ("y", "x", "r", "g", "b", "num_members", "is_active",
           "is_updatable")
# torch has no uint32 arithmetic on every device, so num_members is int64
# on the device and uint32 on the host
_NP_DTYPES = (np.float32,) * 5 + (np.uint32, np.int32, np.int32)
_TORCH_DTYPES = (torch.float32,) * 5 + (torch.int64, torch.int32,
                                        torch.int32)


@dataclasses.dataclass
class Clusters:
    """Struct-of-arrays centroid state; every field has leading dim K.

    y, x, r, g, b are float32 (the reference stores floats even on the
    quantized path, context.cpp:368-373)."""

    y: Any
    x: Any
    r: Any
    g: Any
    b: Any
    num_members: Any
    is_active: Any
    is_updatable: Any

    @property
    def K(self) -> int:
        return int(self.y.shape[-1])

    def fields(self):
        return tuple(getattr(self, f) for f in _FIELDS)

    def replace(self, **kw) -> "Clusters":
        return dataclasses.replace(self, **kw)

    def as_numpy(self) -> "Clusters":
        out = []
        for f, dt in zip(self.fields(), _NP_DTYPES):
            if isinstance(f, torch.Tensor):
                f = to_host(f.detach()).numpy()
            out.append(np.asarray(f).astype(dt, copy=False))
        return Clusters(*out)

    def to_torch(self, device) -> "Clusters":
        out = []
        for f, dt in zip(self.fields(), _TORCH_DTYPES):
            if not isinstance(f, torch.Tensor):
                a = np.ascontiguousarray(f)
                if dt == torch.int64:
                    a = a.astype(np.int64)
                f = torch.from_numpy(a)
            out.append(to_device(f, device, dt))
        return Clusters(*out)

    def copy(self) -> "Clusters":
        return Clusters(*(np.array(f, copy=True)
                          for f in self.as_numpy().fields()))


def zeros(K: int) -> Clusters:
    """All-zero state (SlicModel.__cinit__ memset, cfast_slic.pyx:38-39)."""
    f = np.zeros([K], np.float32)
    return Clusters(
        y=f.copy(), x=f.copy(), r=f.copy(), g=f.copy(), b=f.copy(),
        num_members=np.zeros([K], np.uint32),
        is_active=np.zeros([K], np.int32),
        is_updatable=np.zeros([K], np.int32),
    )


def clusters_from_numpy(y, x, r, g, b, num_members, is_active,
                        is_updatable) -> Clusters:
    """Host state from the eight arrays of a JAX ``Clusters``, so that both
    packages start from the same state."""
    return Clusters(*(np.array(a, dtype=dt) for a, dt in zip(
        (y, x, r, g, b, num_members, is_active, is_updatable), _NP_DTYPES)))


def initialize_clusters(image: np.ndarray, K: int) -> Clusters:
    """Grid seeding, exactly BaseContext::initialize_clusters
    (reference context.cpp:43-97); host integer math, no random numbers."""
    H, W = int(image.shape[0]), int(image.shape[1])
    state = zeros(K)
    if H <= 0 or W <= 0 or K <= 0:
        return state

    n_y = int(math.sqrt(K))
    n_xs = [K // n_y] * n_y
    remainder = K % n_y
    row = 0
    while remainder > 0:
        remainder -= 1
        n_xs[row] += 1
        row += 2
        if row >= n_y:
            row = 1 % n_y

    def ceil_int(a, b):
        return (a + b - 1) // b

    ys = np.zeros([K], np.int64)
    xs = np.zeros([K], np.int64)
    h = ceil_int(H, n_y)
    acc_k = 0
    for i in range(0, H, h):
        w = ceil_int(W, n_xs[min(i // h, n_y - 1)])
        for j in range(0, W, w):
            if acc_k >= K:
                break
            ys[acc_k] = min(max(i + h // 2, 0), H - 1)
            xs[acc_k] = min(max(j + w // 2, 0), W - 1)
            acc_k += 1
    while acc_k < K:
        ys[acc_k] = H // 2
        xs[acc_k] = W // 2
        acc_k += 1

    img = np.asarray(image)
    state.y = ys.astype(np.float32)
    state.x = xs.astype(np.float32)
    state.r = img[ys, xs, 0].astype(np.float32)
    state.g = img[ys, xs, 1].astype(np.float32)
    state.b = img[ys, xs, 2].astype(np.float32)
    state.is_active = np.ones([K], np.int32)
    state.is_updatable = np.ones([K], np.int32)
    state.num_members = np.zeros([K], np.uint32)
    return state


def clusters_to_dicts(state: Clusters):
    """List of dicts like SlicModel.clusters (cfast_slic.pyx:51-66)."""
    s = state.as_numpy()
    return [
        dict(
            number=k,
            yx=(float(s.y[k]), float(s.x[k])),
            color=(float(s.r[k]), float(s.g[k]), float(s.b[k])),
            num_members=int(s.num_members[k]),
        )
        for k in range(s.K)
    ]


def dicts_to_clusters(dicts) -> Clusters:
    """Inverse of :func:`clusters_to_dicts` with the setter's casts
    (cfast_slic.pyx:68-98)."""
    K = len(dicts)
    if K > MAX_NUM_COMPONENTS:
        raise ValueError("num_components cannot exceed 65534")
    state = zeros(K)
    for i, d in enumerate(dicts):
        y, x = d["yx"]
        r, g, b = d["color"]
        state.y[i] = np.float32(np.uint16(y))
        state.x[i] = np.float32(np.uint16(x))
        state.r[i] = np.float32(np.uint8(r))
        state.g[i] = np.float32(np.uint8(g))
        state.b[i] = np.float32(np.uint8(b))
        state.num_members[i] = np.uint32(d["num_members"])
    state.is_active[:] = 1
    state.is_updatable[:] = 1
    return state


def to_yxmrgb(state: Clusters) -> np.ndarray:
    """[K, 6] float64 array of (y, x, num_members, r, g, b)
    (cfast_slic.pyx:100-113)."""
    s = state.as_numpy()
    return np.stack(
        [s.y, s.x, s.num_members.astype(np.float32), s.r, s.g, s.b], axis=1
    ).astype(np.float64)
