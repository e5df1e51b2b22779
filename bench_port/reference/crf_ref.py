"""Plain PyTorch reference of fast-slic's temporal CRF over a window of
superpixel frames: each frame's KNN graph of the cluster centres
(``fast_slic_knn_connectivity``, fast-slic.cpp:80-120), the pairwise
energies (``calc_spatial_pairwise_energy`` and
``calc_temporal_pairwise_energy``, simple-crf.hpp:135-174) and ``max_iter``
rounds of ``infer_once`` (simple-crf.cpp:62-151) from ``initialize``'s
q = exp(-unary) (simple-crf.cpp:153-157).  The cluster states come from
``reference/slic_ref.py``; nothing of the measured program is used.

Float32 throughout (``dtype`` makes the CRF's control: bfloat16), TF32 off
while it runs; it runs on whatever device its tensors are on.

The KNN, per cluster k of B frames at once: the cells of side
S = max(1, int(sqrt(H W / K))), a cluster bucketed in the cell of its
int-cast centre; the candidates visited cell by cell over the half-open
window [cy - 3, cy + 3) x [cx - 3, cx + 3) in ascending (row, column), the
clusters of a cell in ascending number, k itself skipped; the distance
int(|x_n - x_k| + |y_n - y_k|) in float32; a candidate rejected when the
heap is non-empty and its largest distance is >= the candidate's, else
pushed into a max-heap of (distance, number) and the largest popped while
it holds more than m.  The list is the heap's array order.  Written as a
lockstep over every cluster's candidates, one visit a step.

One round of the mean field, per frame t, class c and node i, from the
round's q (double-buffered: every new q from the old):

    msg = sum_j w_s[t, i, j] q[t, c, j]       (j in list order)
        + w_prev[t, i] q[t-1, c, i] + w_next[t, i] q[t+1, c, i]
    w_s = spatial_w exp(-|rgb_i - rgb_j|^2 / (2 srgb^2) - |yx_i - yx_j|^2
          / (2 sxy^2)) + smooth_w exp(-|yx_i - yx_j|^2 / (2 ssxy^2)),
          times sqrt(m_j / m_i)
    w_prev, w_next = temporal_w exp(-|rgb_i(t) - rgb_i(t-+1)|^2 /
          (2 trgb^2)) sqrt(m_i(t-+1) / m_i(t))
    q' = exp(-(unary + sum_{c' != c} compat[c'] msg[c'])),
    q  = q' / max(sum_c q'[c], 1e-5)

Where this departs from the C++ or fixes what it leaves open:

- features are the SLIC state's y, x, members, r, g, b cast to int and back
  to float (``SimpleCRFFrame.set_yxmrgb``'s int32 storage); the KNN reads
  the float centres;
- a cluster with no members counts as one in the denominator m_i (the C++
  would divide by zero);
- a node's pair with itself weighs 0, padding of a shorter list 0;
- the spatial sum runs over the neighbour list in order, then the earlier
  frame's term, then the later frame's; the sums over classes add the
  classes in order; the Potts sum is the class total less the class's own
  term, not a sum that skips it;
- each difference is divided by its scale (true division, as the C++
  divides);
- the unaries are -log(p) of float32 probabilities by numpy's float32 log,
  as the Python face stores them: a mean field this stiff (a spatial weight
  of 10 on up to 4 neighbours) carries unaries a last bit apart (torch's
  log against numpy's) to posteriors 3.7e-4 apart after five rounds;
- the heap's pop moves the last entry to the root and sifts it down, as the
  port's and the JAX package's executable specifications do.
"""

from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Params:
    """SimpleCRFParams' defaults (simple-crf.hpp:80-88)."""

    spatial_w: float = 10.0
    temporal_w: float = 10.0
    spatial_srgb: float = 13.0
    temporal_srgb: float = 13.0
    spatial_sxy: float = 80.0
    spatial_smooth_w: float = 0.0
    spatial_smooth_sxy: float = 3.0


@contextmanager
def _no_tf32():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# -- the graph ---------------------------------------------------------------

def _tdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="trunc")


def knn(ys: torch.Tensor, xs: torch.Tensor, H: int, W: int, m: int):
    """The KNN lists of K centres in each of B frames (ys, xs float32
    [B, K]) as (nbr int64 [B, K, m] in heap array order, -1 past the list;
    lens int64 [B, K])."""
    ys, xs = ys.float(), xs.float()
    B, K = ys.shape
    dev = ys.device
    nbr = torch.full((B, K, m), -1, dtype=torch.int64, device=dev)
    lens = torch.zeros((B, K), dtype=torch.int64, device=dev)
    if K == 0 or m == 0:
        return nbr, lens
    S = max(int(math.sqrt(H * W // K)), 1)
    nh, nw = -(-H // S), -(-W // S)
    cy = _tdiv(ys.to(torch.int64), S)               # the walk's cell
    cx = _tdiv(xs.to(torch.int64), S)
    cell = cy.clamp(0, nh - 1) * nw + cx.clamp(0, nw - 1)
    ks = torch.arange(K, device=dev)
    # clusters by cell, ascending number within one
    order = torch.argsort(cell * K + ks, dim=1)
    count = torch.zeros((B, nh * nw), dtype=torch.int64, device=dev)
    count.scatter_add_(1, cell, torch.ones_like(cell))
    start = torch.cumsum(count, 1) - count
    most = int(count.max())

    # candidates in visit order: window cells row-major, then members
    off = torch.arange(-3, 3, device=dev)
    gy = (cy[..., None] + off)[..., :, None].expand(B, K, 6, 6)
    gx = (cx[..., None] + off)[..., None, :].expand(B, K, 6, 6)
    inside = (gy >= 0) & (gy < nh) & (gx >= 0) & (gx < nw)
    c = torch.where(inside, gy * nw + gx, 0).reshape(B, K, 36)
    slot = torch.arange(most, device=dev)
    n_in = torch.gather(count, 1, c.reshape(B, -1)).reshape(B, K, 36, 1)
    pos = torch.gather(start, 1, c.reshape(B, -1)).reshape(B, K, 36, 1)
    ok = inside.reshape(B, K, 36, 1) & (slot < n_in)
    cand = torch.gather(order, 1, (pos + slot).clamp(max=K - 1)
                        .reshape(B, -1)).reshape(B, K, 36, most)
    ok = (ok & (cand != ks[None, :, None, None])).reshape(B, K, -1)
    cand = cand.reshape(B, K, -1)
    # the valid candidates first, in order
    L = cand.shape[-1]
    idx = torch.arange(L, device=dev)
    first = torch.argsort(torch.where(ok, idx, L + idx), dim=-1)
    cand = torch.gather(cand, -1, first).reshape(B * K, L)
    ok = torch.gather(ok, -1, first).reshape(B * K, L)
    steps = int(ok.sum(-1).max())

    R = B * K
    fy, fx = ys.reshape(R), xs.reshape(R)
    frame = torch.arange(B, device=dev).repeat_interleave(K)
    # heap entries (distance, number) as one key: distance * (K + 1) + number
    key = torch.full((R, m + 1), -1, dtype=torch.int64, device=dev)
    n = torch.zeros(R, dtype=torch.int64, device=dev)
    rows = torch.arange(R, device=dev)
    depth = max(1, int(m + 1).bit_length())
    for j in range(steps):
        other = cand[:, j]
        flat = frame * K + other
        d = ((ys.reshape(-1)[flat] - fy).abs()
             + (xs.reshape(-1)[flat] - fx).abs()).to(torch.int64)
        push = ok[:, j] & ~((n > 0) & (key[:, 0] // (K + 1) <= d))
        # push: append, sift up
        i = n.clone()
        key[rows, i] = torch.where(push, d * (K + 1) + other, key[rows, i])
        n = n + push.long()
        moving = push.clone()
        for _ in range(depth):
            p = ((i - 1) // 2).clamp(min=0)
            swap = moving & (i > 0) & (key[rows, p] < key[rows, i])
            _swap(key, rows, i, p, swap)
            i = torch.where(swap, p, i)
            moving = swap
        # more than m: the root goes, the last entry sifts down from it
        pop = n > m
        last = (n - 1).clamp(min=0)
        key[rows, 0] = torch.where(pop, key[rows, last], key[rows, 0])
        n = n - pop.long()
        i = torch.zeros_like(n)
        moving = pop
        for _ in range(depth):
            big = i.clone()
            for child in (2 * i + 1, 2 * i + 2):
                cc = child.clamp(max=m)
                take = moving & (child < n) & (key[rows, big] < key[rows, cc])
                big = torch.where(take, cc, big)
            swap = moving & (big != i)
            _swap(key, rows, i, big, swap)
            i = torch.where(swap, big, i)
            moving = swap
    live = torch.arange(m + 1, device=dev)[None, :] < n[:, None]
    out = torch.where(live, key % (K + 1), -1)[:, :m]
    return out.reshape(B, K, m), n.reshape(B, K)


def _swap(key, rows, a, b, where):
    ka, kb = key[rows, a], key[rows, b]
    key[rows, a] = torch.where(where, kb, ka)
    key[rows, b] = torch.where(where, ka, kb)


# -- the mean field ----------------------------------------------------------

def features(y, x, num_members, r, g, b) -> torch.Tensor:
    """[..., K, 6] float32 (y, x, members, r, g, b), each cast to int and
    back."""
    return torch.stack([t.to(torch.int64) for t in (y, x, num_members, r, g,
                                                    b)], -1).float()


def unaries(proba: np.ndarray) -> torch.Tensor:
    """-log p of float32 class probabilities [C, N], the values
    ``set_proba`` stores (numpy's float32 log)."""
    return torch.from_numpy(-np.log(np.asarray(proba, np.float32)))


def energies(feat: torch.Tensor, nbr: torch.Tensor, p: Params, dtype):
    """(w_s [T, N, D], w_prev [T, N], w_next [T, N]) of a window: w_prev[t]
    weighs frame t-1's q into frame t, w_next[t] frame t+1's (0 at the
    window's ends)."""
    feat = feat.to(dtype)
    T, N, D = nbr.shape
    valid = (nbr >= 0) & (nbr != torch.arange(N, device=nbr.device)[:, None])
    j = nbr.clamp(min=0)
    other = torch.gather(feat, 1, j.reshape(T, N * D, 1).expand(-1, -1, 6)
                         ).reshape(T, N, D, 6)
    me = feat[:, :, None, :]
    d = me - other
    # the scales as device values: a division by a host number runs on the
    # card as a product with its reciprocal, which rounds otherwise
    srgb, sxy, ssxy, trgb = torch.tensor(
        [p.spatial_srgb, p.spatial_sxy, p.spatial_smooth_sxy,
         p.temporal_srgb], dtype=dtype, device=feat.device)
    rgb = (d[..., 3] / srgb) ** 2 + (d[..., 4] / srgb) ** 2 \
        + (d[..., 5] / srgb) ** 2
    yx = (d[..., 1] / sxy) ** 2 + (d[..., 0] / sxy) ** 2
    sm = (d[..., 1] / ssxy) ** 2 + (d[..., 0] / ssxy) ** 2
    e = (p.spatial_w * torch.exp(-rgb / 2 - yx / 2)
         + p.spatial_smooth_w * torch.exp(-sm / 2))
    m = feat[..., 2]
    m_me = torch.where(m > 0, m, torch.ones_like(m))
    w_s = torch.where(valid, e * torch.sqrt(other[..., 2] / m_me[..., None]),
                      torch.zeros_like(e))
    w_prev = torch.zeros_like(m)
    w_next = torch.zeros_like(m)
    if T > 1:
        dt = feat[1:] - feat[:-1]
        e_t = p.temporal_w * torch.exp(-((dt[..., 3] / trgb) ** 2
                                         + (dt[..., 4] / trgb) ** 2
                                         + (dt[..., 5] / trgb) ** 2) / 2)
        w_prev[1:] = e_t * torch.sqrt(m[:-1] / m_me[1:])
        w_next[:-1] = e_t * torch.sqrt(m[1:] / m_me[:-1])
    return w_s, w_prev, w_next


def _class_sum(a: torch.Tensor) -> torch.Tensor:
    s = a[:, 0]
    for c in range(1, a.shape[1]):
        s = s + a[:, c]
    return s[:, None]


def meanfield(feat: torch.Tensor, nbr: torch.Tensor, unary: torch.Tensor,
              max_iter: int, p: Params = Params(), compat=None,
              dtype=torch.float32) -> torch.Tensor:
    """Posteriors [T, C, N] (float32) after ``max_iter`` rounds from
    q = exp(-unary), over a window's features [T, N, 6], neighbour lists
    [T, N, D] (-1 pad) and unaries [T, C, N], computed in ``dtype``."""
    with _no_tf32():
        T, C, N = unary.shape
        D = nbr.shape[-1]
        w_s, w_prev, w_next = energies(feat, nbr, p, dtype)
        u = unary.to(dtype)
        compat = (torch.ones(C, device=u.device) if compat is None
                  else torch.as_tensor(compat, device=u.device)).to(dtype)
        j = nbr.clamp(min=0)
        q = torch.exp(-u)
        for _ in range(max_iter):
            msg = torch.zeros_like(q)
            for d in range(D):
                idx = j[:, None, :, d].expand(T, C, N)
                msg = msg + w_s[:, None, :, d] * torch.gather(q, 2, idx)
            prev = torch.zeros_like(q)
            nxt = torch.zeros_like(q)
            prev[1:] = q[:-1]
            nxt[:-1] = q[1:]
            msg = msg + w_prev[:, None] * prev
            msg = msg + w_next[:, None] * nxt
            cm = compat[None, :, None] * msg
            new_q = torch.exp(-(u + (_class_sum(cm) - cm)))
            q = new_q / torch.clamp(_class_sum(new_q), min=1e-5)
        return q.float()


def broadcast(classes: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W]: each pixel the class of its cluster, 0 where its label
    is outside [0, N) (``fast_slic_cluster_density_to_mask``)."""
    N = classes.shape[0]
    lab = labels.long()
    valid = (lab >= 0) & (lab < N)
    return torch.where(valid, classes.to(torch.uint8)[lab.clamp(0, N - 1)],
                       torch.zeros((), dtype=torch.uint8,
                                   device=classes.device))


def dirichlet(seed: int, index: int, C: int, N: int) -> np.ndarray:
    """Class probabilities float32 [C, N], Dirichlet(1) over the C classes
    for each node, drawn from (seed, index)."""
    rng = np.random.default_rng([int(seed), 7, int(index)])
    return np.ascontiguousarray(rng.dirichlet(np.ones(C), N).T
                                .astype(np.float32))
