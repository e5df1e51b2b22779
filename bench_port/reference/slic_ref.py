"""Plain PyTorch reference of fast-slic's ``iterate``: the grid seeding, the
fixed-point CIELAB conversion, the subsampled assign/update loop, the full
assign and the connectivity enforcement (the reference C++ core's
``context.cpp``, ``cielab.h``, ``lsc.cpp`` and ``cca.cpp`` semantics), for
the quantized SLIC distance and LSC, over B independent frames at once.

Written whole-array: every (cluster, window pixel) pair of a pass is one
row of a tensor, and each pixel takes the pair with the least
``(distance, visit phase, cluster)`` key.  That is the reference's result:
it visits clusters in 4-phase checkerboard order, ascending within a phase,
and replaces a pixel's label only on a strictly smaller distance, so the
first visitor among equals keeps the pixel.  Components are labelled by
pointer jumping and the top-K survivors chosen as libstdc++'s
``std::partial_sort`` chooses them.

It runs on whatever device its tensors are on and uses no kernel of the
measured program.  ``Options`` holds the controls: LSC's features and
distances in bfloat16, and equal distances given to the smallest cluster
number instead of the first in the visit order.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import math

import numpy as np
import torch

UNASSIGNED = 0xFFFF
SENTINEL = 1 << 62    # a pair that does not exist


@dataclasses.dataclass(frozen=True)
class Params:
    """What one ``iterate`` call is configured with."""

    H: int
    W: int
    K: int
    variant: str = "standard"    # "standard" (quantized) or "lsc"
    compactness: float = 10.0
    min_size_factor: float = 0.25
    subsample_stride: int = 3
    max_iter: int = 10

    @property
    def S(self) -> int:
        return max(1, int(math.sqrt(self.H * self.W // self.K)))


@dataclasses.dataclass(frozen=True)
class Options:
    """The controls: deliberately weaker versions of the reference."""

    lsc_dtype: torch.dtype = torch.float32   # bfloat16: the precision control
    visit_order: bool = True                 # False: equal distances go to
                                             # the smallest cluster number


@dataclasses.dataclass
class State:
    """Per-frame cluster state, fields [B, K] on the device."""

    y: torch.Tensor
    x: torch.Tensor
    r: torch.Tensor
    g: torch.Tensor
    b: torch.Tensor
    num_members: torch.Tensor

    def yxmrgb(self) -> np.ndarray:
        """[B, K, 6] float64 (y, x, num_members, r, g, b), the layout of
        ``SlicModel.to_yxmrgb``."""
        return torch.stack([self.y.double(), self.x.double(),
                            self.num_members.double(), self.r.double(),
                            self.g.double(), self.b.double()],
                           -1).cpu().numpy()


# -- seeding (context.cpp:43-97) -------------------------------------------

def seed_state(images: np.ndarray, K: int, device) -> State:
    """Grid seeding of each frame of uint8 [B, H, W, 3]: sqrt(K) rows, the
    remainder given to every other row from row 0, centres at the cell
    midpoints, colours sampled from the raw image."""
    B, H, W = images.shape[:3]
    n_y = int(math.sqrt(K))
    n_xs = [K // n_y] * n_y
    left, row = K % n_y, 0
    while left > 0:
        left -= 1
        n_xs[row] += 1
        row += 2
        if row >= n_y:
            row = 1 % n_y
    ys = np.full([K], H // 2, np.int64)
    xs = np.full([K], W // 2, np.int64)
    h = -(-H // n_y)
    k = 0
    for i in range(0, H, h):
        w = -(-W // n_xs[min(i // h, n_y - 1)])
        for j in range(0, W, w):
            if k >= K:
                break
            ys[k] = min(max(i + h // 2, 0), H - 1)
            xs[k] = min(max(j + w // 2, 0), W - 1)
            k += 1
    rgb = images[:, ys, xs, :].astype(np.float32)          # [B, K, 3]
    t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return State(y=t(np.broadcast_to(ys.astype(np.float32), (B, K))),
                 x=t(np.broadcast_to(xs.astype(np.float32), (B, K))),
                 r=t(rgb[..., 0]), g=t(rgb[..., 1]), b=t(rgb[..., 2]),
                 num_members=torch.zeros((B, K), dtype=torch.int64,
                                         device=device))


def state_from_yxmrgb(a: np.ndarray, device) -> State:
    """A State from [B, K, 6] (y, x, num_members, r, g, b)."""
    t = lambda i: torch.from_numpy(np.ascontiguousarray(
        a[..., i], dtype=np.float32)).to(device)
    return State(y=t(0), x=t(1), r=t(3), g=t(4), b=t(5),
                 num_members=t(2).to(torch.int64))


# -- CIELAB, fixed point (cielab.h:281-325) --------------------------------

_C_MATRIX = np.array([[0.43395633, 0.37621531, 0.18984309],
                      [0.2126729, 0.7151522, 0.072175],
                      [0.01775782, 0.1094756, 0.87283638]], np.float32)


def _powf(base: np.ndarray, e: float) -> np.ndarray:
    """C's powf element by element, as the C tables are built."""
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    libm.powf.restype = ctypes.c_float
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    return np.array([libm.powf(float(b), e) for b in base], np.float32)


def lab_tables():
    """(sRGB Q13 table [256], matrix Q16 [3, 3], cube-root Q13 table
    [8193]) as int64."""
    a = np.arange(256, dtype=np.float64) / 255.0
    gamma = np.where(a <= 0.04045, a / 12.92,
                     ((a + 0.055) / 1.055) ** 2.4).astype(np.float32)
    srgb = np.trunc((gamma * np.float32(8192)).astype(np.float32))
    cb = np.round(_C_MATRIX * np.float32(1 << 16))
    v = np.arange(8193, dtype=np.float32) / np.float32(8192)
    lo = np.float32(7.787) * v + np.float32(0.137931)
    f = np.where(v > np.float32(0.008856), _powf(v, 0.333333), lo)
    lab = np.floor((f * np.float32(8192)).astype(np.float32)
                   + np.float32(0.5))
    return srgb.astype(np.int64), cb.astype(np.int64), lab.astype(np.int64)


def rgb_to_lab(images: torch.Tensor, tables) -> torch.Tensor:
    """uint8 [..., 3] -> int64 [..., 3] quantized L, a, b (output shift 1;
    the 32-bit unsigned wrap before the shift, as in C)."""
    dev = images.device
    srgb, cb, lab = (torch.from_numpy(t).to(dev) for t in tables)
    s = srgb[images.long()]                                 # [..., 3]
    xyz = [(s * cb[r]).sum(-1) >> 16 for r in range(3)]
    fx, fy, fz = (lab[t] for t in xyz)
    ciel = 116 * fy - (16 << 13)
    ciea = 500 * (fx - fy) + (128 << 13)
    cieb = 200 * (fy - fz) + (128 << 13)
    u = lambda v: (v & 0xFFFFFFFF) >> 12
    return torch.stack([u(ciel).clamp(0, 255),
                        (u(ciea) - 128).clamp(0, 255),
                        (u(cieb) - 128).clamp(0, 255)], -1)


# -- LSC feature space (lsc.cpp:22-195, 226-307) ---------------------------

def lsc_tables(p: Params):
    half_pi = np.float32(math.pi / 2)
    c_color = np.float32(20.0)
    c_spatial = c_color * (np.float32(p.compactness) / np.float32(100.0))
    theta = half_pi * (np.arange(256, dtype=np.float32) / np.float32(255.0))
    ti = np.arange(p.H, dtype=np.float32) * (half_pi / np.float32(p.S))
    tj = np.arange(p.W, dtype=np.float32) * (half_pi / np.float32(p.S))
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        L_cos=f32(c_color * np.cos(theta)), L_sin=f32(c_color * np.sin(theta)),
        c_cos=f32(c_color * np.cos(theta) * np.float32(2.55)),
        c_sin=f32(c_color * np.sin(theta) * np.float32(2.55)),
        h_cos=f32(c_spatial * np.cos(ti)), h_sin=f32(c_spatial * np.sin(ti)),
        w_cos=f32(c_spatial * np.cos(tj)), w_sin=f32(c_spatial * np.sin(tj)))


def lsc_features(planes: torch.Tensor, p: Params):
    """planes int64 [B, H, W, 3] -> (features f32 [B, H, W, 10] divided by
    their weight, weights f32 [B, H, W]).  Order l1 l2 a1 a2 b1 b2 x1 x2 y1
    y2; the mean feature summed in float64; the weight added channel by
    channel."""
    dev = planes.device
    t = {k: torch.from_numpy(v).to(dev) for k, v in lsc_tables(p).items()}
    B, H, W = planes.shape[:3]
    L, A, Bc = planes[..., 0], planes[..., 1], planes[..., 2]
    col = lambda v: v[None, None, :].expand(B, H, W)
    row = lambda v: v[None, :, None].expand(B, H, W)
    f = torch.stack([t["L_cos"][L], t["L_sin"][L], t["c_cos"][A],
                     t["c_sin"][A], t["c_cos"][Bc], t["c_sin"][Bc],
                     col(t["w_cos"]), col(t["w_sin"]),
                     row(t["h_cos"]), row(t["h_sin"])], -1)
    mean = (f.double().sum((1, 2)) / (H * W)).float()        # [B, 10]
    w = f[..., 0] * mean[:, None, None, 0]
    for c in range(1, 10):
        w = w + f[..., c] * mean[:, None, None, c]
    return f / w[..., None], w


def lsc_seed_centroids(feats, st: State, p: Params):
    """The mean feature over each centre's (2r+1)^2 window, r = S // 4,
    clamped to the image.  feats [B, H, W, 10] -> [B, K, 10]."""
    B, H, W = feats.shape[:3]
    r = p.S // 4
    d = torch.arange(-r, r + 1, device=feats.device)
    yy = st.y.long()[..., None] + d                          # [B, K, 2r+1]
    xx = st.x.long()[..., None] + d
    inside = (((yy >= 0) & (yy < H))[..., :, None]
              & ((xx >= 0) & (xx < W))[..., None, :])        # [B, K, w, w]
    idx = (yy.clamp(0, H - 1)[..., :, None] * W
           + xx.clamp(0, W - 1)[..., None, :])
    idx = idx + (torch.arange(B, device=feats.device) * (H * W))[:, None,
                                                                  None, None]
    win = feats.reshape(-1, 10)[idx.reshape(-1)].reshape(idx.shape + (10,))
    sums = (win.double() * inside[..., None]).sum((2, 3))
    cnt = inside.sum((2, 3)).clamp(min=1)
    return (sums / cnt[..., None]).float()


# -- the loop ---------------------------------------------------------------

class _Frame:
    """One call's per-frame constants on the device."""

    def __init__(self, images: torch.Tensor, p: Params, opts: Options,
                 tables):
        self.p, self.opts = p, opts
        self.B = images.shape[0]
        self.dev = images.device
        self.planes = rgb_to_lab(images, tables)             # [B, H, W, 3]
        self.flat = self.planes.reshape(-1, 3)
        self.lab32 = [self.flat[:, c].to(torch.int32).contiguous()
                      for c in range(3)]
        self.base = (torch.arange(self.B, device=self.dev)
                     * (p.H * p.W))                           # [B]
        S = p.S
        coef = (np.float32(1.0) / (np.float32(S) / np.float32(p.compactness))
                * np.float32(2.0))                            # color shift 1
        # manhattan patch: trunc(coef * (|dy| + |dx|)), C's float->uint16
        self.patch = torch.from_numpy(np.trunc(
            coef * np.arange(2 * S + 1, dtype=np.float32)).astype(
                np.int64)).to(self.dev)
        self.feats = self.cent = self.weights = None
        if p.variant == "lsc":
            self.feats, self.weights = lsc_features(self.planes, p)

    def clamp(self, st: State):
        st.y = st.y.clamp(0, self.p.H - 1)
        st.x = st.x.clamp(0, self.p.W - 1)

    def assign(self, st: State, assignment, stride: int, rem: int):
        """One pass over the rows i % stride == rem, in place."""
        p, S = self.p, self.p.S
        H, W, K = p.H, p.W, p.K
        dev = self.dev
        self.clamp(st)
        cy, cx = st.y.long(), st.x.long()                     # [B, K]
        T = 2 * S + 32
        phase = 2 * ((cy // T) % 2) + (cx // T) % 2
        nt = -(-(2 * S + 1) // stride)
        first = torch.remainder(rem - (cy - S), stride)
        dy = (first - S)[..., None] + stride * torch.arange(nt, device=dev)
        rows = cy[..., None] + dy                             # [B, K, nt]
        row_ok = (dy <= S) & (rows >= 0) & (rows < H)
        dx = torch.arange(-S, S + 1, device=dev)
        cols = cx[..., None] + dx                             # [B, K, w]
        col_ok = (cols >= 0) & (cols < W)
        ok = row_ok[..., :, None] & col_ok[..., None, :]      # [B, K, nt, w]
        pix = (rows.clamp(0, H - 1)[..., :, None] * W
               + cols.clamp(0, W - 1)[..., None, :]
               + self.base[:, None, None, None])
        if p.variant == "lsc":
            dt = self.opts.lsc_dtype
            f = self.feats.reshape(-1, 10)[pix.reshape(-1)].to(dt)
            c = self.cent.to(dt)[:, :, None, None, :].expand(
                pix.shape + (10,)).reshape(-1, 10)
            d = ((f - c) * (f - c)).sum(-1).float().reshape(pix.shape)
            ok = ok & (d < torch.finfo(torch.float32).max)
            dist = d.view(torch.int32).long()
        else:
            flat = pix.reshape(-1)
            dist = self.patch[dy.abs().clamp(max=S)[..., :, None]
                              + dx.abs()].to(torch.int32)
            for plane, c in zip(self.lab32, (st.r, st.g, st.b)):
                ci = c.to(torch.int32)[:, :, None, None]      # int casts
                dist = dist + (plane[flat].reshape(pix.shape) - ci).abs()
            ok = ok & (dist < 65535)
            dist = dist.long()
        k = torch.arange(K, device=dev)
        if not self.opts.visit_order:
            phase = torch.zeros_like(phase)
        key = (dist << 18) | ((phase << 16) | k)[:, :, None, None]
        key = torch.where(ok, key, SENTINEL)
        best = torch.full((self.B * H * W,), SENTINEL, dtype=torch.int64,
                          device=dev)
        best.scatter_reduce_(0, pix.reshape(-1), key.reshape(-1), "amin")
        won = best < SENTINEL
        assignment.copy_(torch.where(won, best & 0xFFFF, assignment))

    def update(self, st: State, assignment, stride: int, rem: int):
        """Members' mean position and colour over the rows just assigned,
        rounded as round_int; LSC re-centres its feature centroids."""
        p = self.p
        H, W, K, B = p.H, p.W, p.K, self.B
        dev = self.dev
        a = assignment.reshape(B, H, W)[:, rem::stride]      # rows assigned
        m = a != UNASSIGNED
        ids = torch.where(m, a + (torch.arange(B, device=dev) * K)[
            :, None, None], B * K).reshape(-1)               # B*K: dropped
        h = a.shape[1]
        ii = torch.arange(rem, H, stride, device=dev)[None, :, None].expand(
            B, h, W)
        jj = torch.arange(W, device=dev)[None, None, :].expand(B, h, W)
        lab = self.planes[:, rem::stride]
        vals = torch.stack([ii, jj, lab[..., 0], lab[..., 1], lab[..., 2]],
                           -1).reshape(-1, 5)
        counts = torch.bincount(ids, minlength=B * K + 1)[:B * K]
        sums = torch.zeros((B * K + 1, 5), dtype=torch.int64, device=dev)
        sums.index_add_(0, ids, vals)
        sums = sums[:B * K]
        safe = counts.clamp(min=1)
        means = ((sums + (safe // 2)[:, None]) // safe[:, None]).float()
        sel = (counts > 0).reshape(B, K)
        means = means.reshape(B, K, 5)
        st.y = torch.where(sel, means[..., 0], st.y)
        st.x = torch.where(sel, means[..., 1], st.x)
        st.r = torch.where(sel, means[..., 2], st.r)
        st.g = torch.where(sel, means[..., 3], st.g)
        st.b = torch.where(sel, means[..., 4], st.b)
        st.num_members = counts.reshape(B, K)
        if p.variant == "lsc":
            w = self.weights[:, rem::stride].reshape(-1)
            f = self.feats[:, rem::stride].reshape(-1, 10)
            acc = torch.zeros((B * K + 1, 10), dtype=torch.float64,
                              device=dev)
            acc.index_add_(0, ids, (f * w[:, None]).double())
            wsum = torch.zeros(B * K + 1, dtype=torch.float64, device=dev)
            wsum.index_add_(0, ids, w.double())
            self.cent = (acc[:B * K] / wsum[:B * K, None]).float().reshape(
                B, K, 10)


def iterate(images: torch.Tensor, st: State, p: Params,
            opts: Options = Options(), tables=None):
    """fast-slic's iterate over each frame of uint8 [B, H, W, 3] (a
    tensor on the device) from the frames' states ``st`` (updated in
    place).  Returns int64 labels [B, H, W], -1 for unassigned."""
    tables = tables or lab_tables()
    fr = _Frame(images, p, opts, tables)
    H, W = p.H, p.W
    # colours re-seeded from the LAB image at the int-cast centres
    cy = st.y.long().clamp(0, H - 1)
    cx = st.x.long().clamp(0, W - 1)
    seed = fr.flat[cy * W + cx + fr.base[:, None]].float()   # [B, K, 3]
    st.r, st.g, st.b = seed[..., 0], seed[..., 1], seed[..., 2]
    if p.variant == "lsc":
        fr.cent = lsc_seed_centroids(fr.feats, st, p)
    assignment = torch.full((fr.B * H * W,), UNASSIGNED, dtype=torch.int64,
                            device=fr.dev)
    stride = p.subsample_stride
    for i in range(p.max_iter):
        fr.assign(st, assignment, stride, i % stride)
        fr.update(st, assignment, stride, i % stride)
    fr.assign(st, assignment, 1, 0)
    thres = int(math.floor(p.S * p.S * p.min_size_factor + 0.5))
    return enforce_connectivity(assignment.reshape(fr.B, H, W), p.K, thres)


# -- connectivity enforcement (cca.cpp:103-265) ----------------------------

def _components(lab: torch.Tensor) -> torch.Tensor:
    """For each pixel of [B, H, W], the smallest flat index of its
    4-connected region of equal labels (frames never join)."""
    B, H, W = lab.shape
    dev = lab.device
    idx = torch.arange(B * H * W, device=dev).reshape(B, H, W)
    eh = lab[:, :, 1:] == lab[:, :, :-1]
    ev = lab[:, 1:, :] == lab[:, :-1, :]
    ea = torch.cat([idx[:, :, :-1][eh], idx[:, :-1, :][ev]])
    eb = torch.cat([idx[:, :, 1:][eh], idx[:, 1:, :][ev]])
    L = idx.reshape(-1).clone()
    while True:
        la, lb = L[ea], L[eb]
        if torch.equal(la, lb):
            return L
        # roots hooked under the smaller root; equal pairs change nothing
        L.scatter_reduce_(0, torch.maximum(la, lb), torch.minimum(la, lb),
                          "amin")
        while True:
            nxt = L[L[L]]
            if torch.equal(nxt, L):
                break
            L = nxt


def heap_select_topk(seq, areas, K):
    """The element set std::partial_sort(first, first + K, last, areacmp)
    keeps (libstdc++'s heap_select: a heap over the first K, its top
    replaced by each later element that compares strictly better)."""

    def comp(a, b):
        return areas[a] > areas[b]

    def push_heap(h, hole, top, value):
        parent = (hole - 1) // 2
        while hole > top and comp(h[parent], value):
            h[hole] = h[parent]
            hole = parent
            parent = (hole - 1) // 2
        h[hole] = value

    def adjust_heap(h, hole, length, value):
        top = second = hole
        while second < (length - 1) // 2:
            second = 2 * (second + 1)
            if comp(h[second], h[second - 1]):
                second -= 1
            h[hole] = h[second]
            hole = second
        if (length & 1) == 0 and second == (length - 2) // 2:
            second = 2 * (second + 1)
            h[hole] = h[second - 1]
            hole = second - 1
        push_heap(h, hole, top, value)

    h = list(seq[:K])
    if K >= 2:
        parent = (K - 2) // 2
        while True:
            adjust_heap(h, parent, K, h[parent])
            if parent == 0:
                break
            parent -= 1
    for x in seq[K:]:
        if comp(x, h[0]):
            adjust_heap(h, 0, K, x)
    return h


def enforce_connectivity(assignment: torch.Tensor, K: int,
                         thres: int) -> torch.Tensor:
    """Labels of [B, H, W]: regions of at least ``thres`` pixels, at most
    the K largest, numbered in leader order; every other region takes the
    label of the pixel left of its leader (above it in column 0); region 0
    of a frame always gets a label."""
    B, H, W = assignment.shape
    n = H * W
    dev = assignment.device
    L = _components(assignment)
    is_leader = L == torch.arange(B * n, device=dev)
    cid = torch.cumsum(is_leader, 0) - 1                    # at leaders
    comp = cid[L]                                           # per pixel
    leaders = torch.nonzero(is_leader).reshape(-1)          # ascending
    nc = leaders.numel()
    frame = leaders // n
    areas = torch.bincount(comp, minlength=nc)
    kept = areas >= thres
    first = torch.searchsorted(frame, torch.arange(B, device=dev))
    counts = torch.bincount(frame[kept], minlength=B).cpu().tolist()
    for f in range(B):
        if counts[f] <= K:
            continue
        lo = int(first[f])
        hi = int(first[f + 1]) if f + 1 < B else nc
        sel = torch.nonzero(kept[lo:hi]).reshape(-1) + lo
        keep = heap_select_topk(sel.cpu().tolist(), areas.cpu().numpy(), K)
        kept[lo:hi] = False
        kept[torch.tensor(keep, dtype=torch.long, device=dev)] = True
    cum = torch.cumsum(kept, 0)
    before = cum[first] - kept[first].long()     # kept in earlier frames
    value = cum - 1 - before[frame]
    root = kept.clone()
    root[first] = True
    value = torch.where(kept, value, torch.zeros_like(value))
    local = leaders - frame * n
    donor = torch.where(local % W > 0, leaders - 1, leaders - W).clamp(min=0)
    ptr = torch.where(root, torch.arange(nc, device=dev), comp[donor])
    while True:
        nxt = ptr[ptr]
        if torch.equal(nxt, ptr):
            break
        ptr = nxt
    labels = value[ptr][comp].reshape(B, H, W)
    return torch.where(labels == UNASSIGNED, -1, labels)
