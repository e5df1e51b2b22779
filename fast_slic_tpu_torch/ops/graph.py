"""Superpixel graph and density utilities.

The counterpart of ``fast_slic_tpu/ops/graph.py`` (reference
``fast-slic.cpp:16-168``), as torch ops on the model's device:

* :func:`adjacency_matrix` / :func:`adjacency` — superpixel adjacency from
  a 2x2 neighbourhood scan with first-come order and a 12-neighbour cap;
* :func:`knn` — grid-bucketed nearest neighbours of the cluster centres,
  with the reference's early-skip quirk (``kernels/knn.py``: two CUDA
  kernels on the card, the plain version ``knn_plain`` on the CPU);
* :func:`mask_density` / :func:`density_to_mask` — mask -> cluster density
  pooling and its broadcast back to the pixels.

Each takes numpy arrays or tensors and returns numpy arrays, like the JAX
package's functions.  The device decides, as in the rest of the package:
tensor arguments are used where they lie, and numpy input goes to
``device``, the card by default (which raises without a GPU).  Uploads
and downloads go through ``utils/timing.to_device`` / ``to_host``, which
count them; :func:`knn` and :func:`density_to_mask` run in the spans
``fstt.graph.knn`` and ``fstt.graph.density_to_mask``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.knn import knn as _knn_kernel
from ..model import resolve_device
from ..utils.timing import spanned, to_device, to_host

MAX_ADJ_NEIGHBORS = 12  # fast-slic.cpp:17


class NodeConnectivity:
    """API-parity wrapper over a neighbour-list graph (cfast_slic.pyx:330-351).

    Stores either python lists or a padded [K, D] matrix; the CRF reads
    ``matrix()``."""

    def __init__(self, neighbor_lists=None, matrix=None, lens=None):
        if matrix is not None:
            self._matrix = (np.asarray(matrix, np.int32),
                            np.asarray(lens, np.int64))
            self._lists = None
        else:
            self._lists = [list(map(int, l)) for l in neighbor_lists]
            self._matrix = None

    @property
    def num_nodes(self):
        if self._lists is not None:
            return len(self._lists)
        return self._matrix[0].shape[0]

    def tolist(self):
        if self._lists is None:
            nbr, lens = self._matrix
            self._lists = [nbr[i, :lens[i]].tolist()
                           for i in range(nbr.shape[0])]
        return [list(l) for l in self._lists]

    def matrix(self):
        """(nbr [K, D] int32 padded with -1, lens [K]) — insertion order."""
        if self._matrix is None:
            lists = self._lists
            K = len(lists)
            lens = np.fromiter(map(len, lists), np.int64, count=K)
            D = max(1, int(lens.max()) if K else 1)
            nbr = np.full((K, D), -1, np.int32)
            flat = np.fromiter((v for l in lists for v in l), np.int32,
                               count=int(lens.sum()))
            cols = np.arange(D)[None, :] < lens[:, None]
            nbr[cols] = flat
            self._matrix = (nbr, lens)
        return self._matrix


def _work_device(device, *args) -> torch.device:
    """The device the work runs on: that of the tensor arguments, else
    ``device`` (the card when None).  Tensors on several devices, or on
    another device than an explicit ``device``, raise ValueError; nothing
    is moved between devices behind the caller's back."""
    devs = {a.device for a in args if isinstance(a, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError("tensor arguments on several devices: %s"
                         % sorted(map(str, devs)))
    if not devs:
        return resolve_device("cuda" if device is None else device)
    (dev,) = devs
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or (want.index is not None
                                     and want.index != dev.index):
            raise ValueError("tensor argument on %s, device %s requested"
                             % (dev, want))
    return dev


def _as_tensor(a, dev: torch.device) -> torch.Tensor:
    """A tensor as it is (``_work_device`` put it on ``dev``), a numpy array
    uploaded to ``dev``."""
    if isinstance(a, torch.Tensor):
        return a
    return to_device(torch.from_numpy(np.ascontiguousarray(a)), dev)


def adjacency(assignment, K: int, device=None):
    """Neighbour lists from the label map (fast_slic_get_connectivity).
    List-of-lists view of :func:`adjacency_matrix`."""
    nbr, lens = adjacency_matrix(assignment, K, device)
    return [nbr[i, :lens[i]].tolist() for i in range(K)]


def _first_occurrences(key: torch.Tensor) -> torch.Tensor:
    """Positions of the first element of each distinct key, ascending."""
    sk, perm = torch.sort(key, stable=True)
    head = torch.ones_like(sk, dtype=torch.bool)
    head[1:] = sk[1:] != sk[:-1]
    return torch.sort(perm[head]).values


def _cap_hot_edges(s, t, hot, accept):
    """Sequential 12-neighbour cap over the edges touching a hot node, in
    stream order, on the host (fast-slic.cpp:60-62).  A cold endpoint
    (total degree <= 12) is never at the cap when checked, so only hot
    degrees are tracked."""
    idx = torch.nonzero(~accept).reshape(-1)
    ss_all = s[idx].tolist()
    tt_all = t[idx].tolist()
    hd = {int(i): 0 for i in torch.nonzero(hot).reshape(-1).tolist()}
    keep = []
    for ss, tt in zip(ss_all, tt_all):
        ds = hd.get(ss)
        dt = hd.get(tt)
        if ((ds is not None and ds >= MAX_ADJ_NEIGHBORS)
                or (dt is not None and dt >= MAX_ADJ_NEIGHBORS)):
            keep.append(False)
            continue
        keep.append(True)
        if ds is not None:
            hd[ss] = ds + 1
        if dt is not None:
            hd[tt] = dt + 1
    accept = accept.clone()
    accept[idx] = torch.tensor(keep, dtype=torch.bool, device=accept.device)
    return accept


def adjacency_matrix(assignment, K: int, device=None):
    """Adjacency from the label map as (nbr [K, D] int32 padded -1,
    lens [K] int64), numpy, in the reference's insertion order
    (fast_slic_get_connectivity, fast-slic.cpp:16-78).

    For every pixel (i, j) with i < H-1, j < W-1 the reference examines the
    pairs (right, down, down-right) in row-major scan order and records
    each distinct label pair once, in both directions, skipping a pair if
    either endpoint already has 12 neighbours.  On the work's device
    (the label tensor's, else ``device``, the card by default): the
    boundary pairs compacted in scan order (pixel-major, then direction),
    the first occurrence of each undirected pair (a stable sort), the
    degrees and the insertion ranks.  Only the edges that touch a node
    with more than 12 candidate edges walk the sequential cap, on the
    host.
    """
    dev = _work_device(device, assignment)
    a = _as_tensor(assignment, dev).to(torch.int64)
    H, W = a.shape
    if H < 2 or W < 2:
        return np.full((K, 1), -1, np.int32), np.zeros(K, np.int64)
    a = torch.where((a < 0) | (a >= K), K, a)  # out-of-range labels ignored

    base = a[:-1, :-1].reshape(-1)
    nbs = torch.stack([a[:-1, 1:].reshape(-1), a[1:, :-1].reshape(-1),
                       a[1:, 1:].reshape(-1)], 1)              # [P, 3]
    pair = (nbs != base[:, None]) & (base[:, None] < K) & (nbs < K)
    # the flat position p * 3 + d is the scan-order key, and nonzero
    # returns it ascending
    flat = torch.nonzero(pair.reshape(-1)).reshape(-1)
    s = base[flat // 3]
    t = nbs.reshape(-1)[flat]
    key = torch.minimum(s, t) * (K + 1) + torch.maximum(s, t)
    first = _first_occurrences(key)
    s, t = s[first], t[first]

    occ = torch.bincount(torch.cat([s, t]), minlength=K)
    hot = occ > MAX_ADJ_NEIGHBORS
    accept = ~(hot[s] | hot[t])
    if not bool(accept.all()):
        accept = _cap_hot_edges(s, t, hot, accept)
    sa, ta = s[accept], t[accept]

    # directed insertion stream: target first, then source, per edge
    # (fast-slic.cpp:65-66)
    owners = torch.stack([ta, sa], 1).reshape(-1)
    partners = torch.stack([sa, ta], 1).reshape(-1)
    counts = torch.bincount(owners, minlength=K)
    D = max(1, int(counts.max()) if owners.numel() else 1)
    so, perm = torch.sort(owners, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.empty_like(owners)
    ranks[perm] = torch.arange(owners.numel(), device=dev) - starts[so]
    nbr = torch.full((K, D), -1, dtype=torch.int32, device=dev)
    nbr[owners, ranks] = partners.to(torch.int32)
    return nbr.cpu().numpy(), counts.cpu().numpy().astype(np.int64)


@spanned("graph.knn")
def knn(clusters, num_neighbors: int, shape, device=None):
    """Grid-bucketed nearest-neighbour lists (fast_slic_knn_connectivity)
    as (nbr [K, D] int32 padded -1, lens [K] int64), numpy, each row in
    the heap's array order; D = max(1, longest list).

    Candidates are visited in the reference's order (cells in ascending
    (cy, cx) over the half-open window [c-3, c+3), clusters in ascending
    number within a cell) and a candidate is rejected whenever its
    distance is >= the current heap maximum, even if the heap is not yet
    full (fast-slic.cpp:103-108).  Where the centres lie on the card (the
    clusters' tensors, else ``device``, the card by default) this launches
    the ``knn_buckets`` and ``knn`` kernels and downloads their lists and
    counts as one buffer; on the CPU it runs ``kernels.knn.knn_plain``."""
    dev = _work_device(device, clusters.y, clusters.x)
    ys = _as_tensor(clusters.y, dev).to(torch.float32)
    xs = _as_tensor(clusters.x, dev).to(torch.float32)
    K, m = ys.shape[0], max(int(num_neighbors), 0)
    # nbr's rows, then the counts: one download
    packed = to_host(_knn_kernel(ys, xs, int(shape[0]), int(shape[1]), m,
                                 packed=True)).numpy()
    nbr = packed[:K * m].reshape(K, m)
    lens = packed[K * m:].astype(np.int64)
    D = max(1, int(lens.max()) if lens.size else 1)
    out = np.full((K, D), -1, np.int32)
    w = min(D, m)
    out[:, :w] = nbr[:, :w]
    return out, lens


def mask_density(mask, assignment, clusters, device=None) -> np.ndarray:
    """Per-cluster mean mask value, clamped to u8
    (fast_slic_get_mask_density, fast-slic.cpp:141-156).  The float64 sums
    of integer masks are exact in any order of addition."""
    dev = _work_device(device, mask, assignment, clusters.num_members)
    K = clusters.K
    a = _as_tensor(assignment, dev).to(torch.int64).reshape(-1)
    m = _as_tensor(mask, dev).reshape(-1)
    valid = (a >= 0) & (a < K)
    sums = torch.zeros(K, dtype=torch.float64, device=dev).index_add_(
        0, a[valid], m[valid].to(torch.float64)).to(torch.int64)
    members = clusters.num_members
    if not isinstance(members, torch.Tensor):  # uint32 on the host
        members = np.asarray(members).astype(np.int64)
    members = _as_tensor(members, dev).to(torch.int64)
    dens = torch.clamp(sums // torch.clamp(members, min=1), max=255)
    return dens.to(torch.uint8).cpu().numpy()


@spanned("graph.density_to_mask")
def density_to_mask(densities, assignment, K: int,
                    device=None) -> np.ndarray:
    """Broadcast per-cluster densities back to the pixels
    (fast_slic_cluster_density_to_mask, fast-slic.cpp:158-168)."""
    dev = _work_device(device, densities, assignment)
    a = _as_tensor(assignment, dev).to(torch.int64)
    d = _as_tensor(densities, dev).to(torch.uint8)
    valid = (a >= 0) & (a < K)
    out = torch.where(valid, d[torch.where(valid, a, 0)],
                      torch.zeros((), dtype=torch.uint8, device=dev))
    return to_host(out).numpy()
