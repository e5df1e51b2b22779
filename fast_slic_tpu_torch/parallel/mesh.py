"""A (data, space) grid of devices and the collectives between its shards.

The counterpart of ``fast_slic_tpu/parallel/mesh.py``.  The JAX package
drives its mesh from one Python process and lets ``shard_map`` place the
shards; so does this port, with a :class:`Mesh` of ``torch.device`` s that
the caller may name, repeats allowed:

* ``make_mesh(devices=[torch.device("cpu")] * 8, ...)``: eight shards on the
  CPU (the tests, as the JAX tests use eight virtual CPU devices);
* ``make_mesh(data=1, space=4, devices=[torch.device("cuda:0")] * 4)``:
  four shards on one card, which run the same code, halos and seams as four
  cards would; only the copies are local;
* ``make_mesh()``: one shard a visible GPU.

The axes mean what they mean in the JAX package: ``data`` splits the
frames of a batch (``parallel.batch.BatchedSlic(mesh=...)``), ``space``
the rows of one image (``parallel.spatial_shardmap``).

The collectives are plain functions over the shards' tensors, one per
shard in shard order: :meth:`Mesh.ppermute` (a halo from the neighbour
shard, zeros at the axis's ends), :meth:`Mesh.psum` (a sum in shard order
0..D-1), :meth:`Mesh.all_gather` (scalars), :meth:`Mesh.broadcast` (a
replicated value to every shard) and :meth:`Mesh.gather` (shards joined
on one device: the escalation's one pixel-sized transfer).  A value that
JAX replicates over an axis is held once, on the axis's first shard, and
broadcast where a shard needs it.  Every collective adds the bytes that
cross from one shard to another to :attr:`Mesh.bytes_moved`, also where
two shards share a device and the copy is free.  ``torch.distributed`` is
not used: NCCL refuses two ranks on one card and gloo has no card-to-card
send.

``batch_sharding`` and ``replicated`` of the JAX module are GSPMD
shardings, which PyTorch has no counterpart of; they are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """A [data, space] grid of ``torch.device`` s with the collectives of
    the shards of one axis."""

    axis_names = ("data", "space")

    def __init__(self, devices):
        grid = np.empty(np.shape(devices)[:2], dtype=object)
        for idx, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            grid[idx] = torch.device(dev)
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError("devices must be a non-empty [data, space] grid")
        self.devices = grid
        self.shape = {"data": grid.shape[0], "space": grid.shape[1]}
        self.bytes_moved = 0

    def __repr__(self):
        return "Mesh(%s, %s)" % (self.shape, sorted(set(map(
            str, self.devices.ravel()))))

    def axis_devices(self, axis: str, index: int = 0):
        """The devices of one axis: the ``space`` shards of data row
        ``index``, or the ``data`` shards of space column ``index``."""
        if axis == "space":
            return list(self.devices[index, :])
        if axis == "data":
            return list(self.devices[:, index])
        raise ValueError("axis must be 'data' or 'space'")

    # -- collectives over the shards of one axis (one tensor a shard) ----
    def _move(self, t, device, crosses: bool):
        if crosses:
            self.bytes_moved += t.numel() * t.element_size()
        return t.to(device)

    def ppermute(self, parts, up: bool, axis: str = "space"):
        """Shard d receives shard d-1's tensor (``up``: sent down the
        axis) or shard d+1's; the first (last) shard receives zeros."""
        devs = self.axis_devices(axis)
        D = len(devs)
        out = []
        for d in range(D):
            src = d - 1 if up else d + 1
            if 0 <= src < D:
                out.append(self._move(parts[src], devs[d], True))
            else:
                out.append(torch.zeros_like(parts[d]))
        return out

    def psum(self, parts, axis: str = "space"):
        """The sum of the shards' tensors, added in shard order 0..D-1 on
        the first shard's device."""
        devs = self.axis_devices(axis)
        acc = parts[0].to(devs[0])
        for t in parts[1:]:
            acc = acc + self._move(t, devs[0], True)
        return acc

    def all_gather(self, parts, axis: str = "space"):
        """The shards' scalars (or small tensors) stacked in shard order
        on the first shard's device."""
        devs = self.axis_devices(axis)
        return torch.stack([self._move(t, devs[0], d > 0)
                            for d, t in enumerate(parts)])

    def broadcast(self, t, axis: str = "space"):
        """A value held on the first shard, on every shard's device."""
        return [self._move(t, dev, d > 0)
                for d, dev in enumerate(self.axis_devices(axis))]

    def gather(self, parts, dim: int = 0, axis: str = "space"):
        """The shards' tensors joined along ``dim`` on the first shard's
        device."""
        devs = self.axis_devices(axis)
        return torch.cat([self._move(t, devs[0], d > 0)
                          for d, t in enumerate(parts)], dim)


def make_mesh(n_devices: int | None = None, data: int | None = None,
              space: int | None = None, devices=None) -> Mesh:
    """A (data, space) mesh over the first ``n_devices`` of ``devices``.

    ``devices``: a list of ``torch.device`` (or names); repeats put several
    shards on one device.  By default every visible GPU, and a RuntimeError
    without one (no shard is quietly placed on the CPU).  Defaults as in
    the JAX package: all devices on the data axis, space = 1."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() takes the visible GPUs and there is none; "
                "pass devices=[torch.device('cpu')] * n for a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError("%d devices asked, %d given" % (n_devices,
                                                        len(devices)))
    devices = devices[:n_devices]
    if data is None and space is None:
        data, space = n_devices, 1
    elif data is None:
        data = n_devices // space
    elif space is None:
        space = n_devices // data
    if data * space != n_devices:
        raise ValueError("mesh %dx%d != %d devices" % (data, space,
                                                        n_devices))
    grid = np.empty((data, space), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // space, i % space] = dev
    return Mesh(grid)
