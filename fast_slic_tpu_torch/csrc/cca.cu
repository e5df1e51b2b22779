// Connected components of a label map, and a table lookup, for the
// connectivity enforcement (CCA) of ops/cca.py.
//
// fstt_cc replaces fast_slic_tpu/pallas/cca_tpu.py:_cc_pass_kernel
// (pallas_call in _cc_passes, reached through propagate_min_pallas and
// connected_components_pallas).  The TPU kernel spread a minimum over each
// 4-connected equal-label region with strip-resident segmented doubling,
// alternating half-shifted strip grids until a fixpoint.  Here the same
// result -- every pixel labelled with the MINIMUM LINEAR PIXEL INDEX of its
// region, UNASSIGNED (0xFFFF) being a label like any other -- comes from
// block-based label equivalence (see arXiv 1712.09789 in PAPERS.md) in
// three passes:
//   cc_local    a block labels one 32x32 tile on chip (cc_local below:
//               row-group scans with run labels from __ballot_sync, then
//               the recorded label pairs resolved in a few rounds) and
//               writes each pixel the global index of its piece's minimum
//               pixel in the tile.  Row-major order inside a tile is the
//               global order, so that is the piece's smallest index.
//   cc_seams    one thread a pixel on a tile's top row and left column
//               unites it with its neighbour across the seam where the
//               labels are equal and one of the two runs along the seam
//               starts there, in device memory with atomicMin linking.
//   cc_flatten  out[p] = root(out[p]).
// A region's minimum pixel only ever points at itself (a parent only
// decreases and stays inside the region), so the root is that minimum and
// the labelling is unique whatever order the atomics land in.

// fstt_region_table, fstt_seam_min and fstt_propagate_min replace the
// general use of the same TPU kernel, propagate_min_pallas (cca_tpu.py:349):
// the minimum of an int32 seed over each 4-connected equal-label region,
// which a spatially sharded CCA needs for two seeds (global pixel ids,
// leader ranks) over an image whose rows are split into slabs.  The TPU
// spread the seed itself, strip by strip, over the whole slab every round of
// the seam fixpoint.  Here a slab's regions are known first (fstt_cc above
// gives every pixel its region's minimum pixel, its ROOT, found once for
// every seed and round that share the labels), and the minimum is kept per
// region, in a TABLE indexed by the root's pixel:
//   fstt_region_table  each root's slot takes its own seed, every other
//               slot 0x7FFFFFFF (rt_init), then one thread a pixel that is
//               no root takes atomicMin(table[root], m0[p]) where m0[p] is
//               below the slot it reads (rt_scatter): each root's slot ends
//               holding its region's minimum, whatever order the atomics
//               land in;
//   fstt_seam_min  one thread a pixel of a slab's edge row: where its label
//               equals the label across the seam (the neighbour slab's
//               edge row), atomicMin(table[root], the neighbour's value),
//               and *changed = stamp where a slot went down.  A round of
//               the seam fixpoint touches only the two edge rows;
//   fstt_propagate_min  the per-pixel form: the region table, then
//               out[p] = table[root[p]] (lookup_kernel below).
// The sharded CCA builds no table for its own seeds (a root is its slab
// region's smallest pixel, and every leader is a root), so its only pass
// over a whole slab is the final gather, once a propagation.
//
// fstt_lookup replaces fast_slic_tpu/pallas/segsum_tpu.py:_lookup_kernel
// (pallas_call in banded_lookup_pallas), which emulated a gather with banded
// one-hot matmuls: out[i] = table[ids[i]] is a plain gather here.
//
// fstt_cca_select replaces no TPU kernel: the selection and orphan adoption
// that the JAX package writes as XLA ops (fast_slic_tpu/ops/cca.py:308-398,
// enforce_connectivity_xla_flagged after _cca_core; its plain version,
// kernels/cca.py:cca_select_plain, is about 213 torch launches a call on
// the card).  From one frame's
// component tables (areas, adoption targets, the component count nc, all on
// the device) it writes the substitute table -- each kept component's rank
// in leader order, each dropped one its adopter's -- and the boundary-tie
// flag, one block a frame (cca_select_kernel):
//   a. the k-th largest area among the components over the area threshold,
//      by a radix select: one pass counts them and takes their largest
//      area; then a 4096-bin histogram of a 12-bit digit in shared memory
//      (a warp's lanes with one digit add once), a block scan from the top
//      bin to the digit where the count crosses k, and again on the next
//      digit of the areas that share the chosen ones, from the top of the
//      largest area's bits (one pass below 4096 pixels, as a 720p
//      superpixel is; two up to 2^24).  The TPU found the same value T --
//      the least T with fewer than k areas above it -- by a binary search
//      of ceil(log2(n + 1)) masked sums over the whole table, since top_k
//      lowers to a serial sort there;
//   b. one pass over [0, nc) counts the areas above T and equal to it:
//      fill = k - count(> T) and the tie flag (count(>= thr) > k and fill
//      < count(== T)), the definition of ops/cca.py;
//   c. one ordered pass over [0, nc), 4096 entries a round (4 consecutive
//      a thread, block scans of warp shuffles): a running rank among the
//      components equal to T (the first fill of them are kept, in leader
//      order) and among the kept ones (a kept component's substitute);
//      component 0 gets 0 whether kept or not (cca.cpp:238);
//   d. the orphan chase, 4096 entries a round in leader order: every entry
//      of an earlier round is final, so a dropped component whose target
//      lies below its round takes that entry's label at once (real chains
//      are 1-3 hops); one whose target lies in its round follows it by
//      pointer jumping in shared memory, at most 13 steps with a barrier
//      each, which ends any chain inside the round.  The tables the CCA
//      makes -- each target below its own entry, each area at most
//      n_pixels -- are the ones the kernel equals the plain version on;
//      a target at or past its own entry, or below 0, gives 0, and the
//      jumping stops after its 13 steps whatever the table, so a
//      malformed table cannot hang the card.
// The bins from nc to n are the plain version's 0, written by the grid's
// further blocks while the frames' blocks select.  Nothing waits on the
// host: nc is read on the device, the grid is sized by n.
//
// Bound on the card: the components need 8 bytes a pixel (a label read, an
// id written; 7.4 MB at 720p, 2.2 us at 3.35 TB/s), but a union-find is
// bound by its dependent loads: a find is a chain of round trips (to L2 in
// device memory), and a union over single pixels builds chains as long as a
// region has rows.  Inside a tile this design does without finds: a warp
// carries the labels of its rows in registers and merges a run with the
// row above by shuffles, and only the few label pairs where two pieces meet
// go through shared memory, resolved by hooking and shortcutting rounds
// with no per-thread loops.  (A shared-memory union-find, one union a pair
// of touching runs, was slower at 720p: PERF.md §6, kernel designs that
// lost.)
// Across tiles a chain is as long as the number of tiles a region spans
// (1-4 for a superpixel), and only 1/16 of the pixels (the seams) take
// part.  Parents in device memory are read through volatile loads, so a
// thread never follows a stale L1 copy of a chain another SM has relinked.
//
// The region table must move 12 bytes a pixel (the roots and the seed read,
// the slot written); its init and scatter move 20 (both read the roots and
// the seed), and the per-pixel form 32 (the gather adds 12).  The scatter's
// atomics all land on a region's one slot, so it reads the slot first and
// skips the atomic where the seed cannot lower it; and the init gives each
// root its own seed, so a pixel-id seed (a root is its region's smallest
// pixel) makes no atomic at all.  A slot filled with 0x7FFFFFFF instead
// lets every pixel that reads it before its region's minimum lands make
// its atomic (3x the scatter's time at 720p on an H100), and reducing a
// warp's lanes by root first (__match_any_sync) costs more than it saves
// where few pixels lower a slot.  A seam round moves 16 bytes a pixel of
// one row and touches a slot a region that crosses the seam: it is bound
// by its launch, a few microseconds.
//
// The lookup is bound by device memory (8 bytes read and 4
// written a pixel): each thread moves four ids and four results as 16-byte
// vectors (a scalar path for unaligned views and the tail), the table is
// read through the read-only cache, and a grid of a few blocks per SM
// strides over the ids.  The table has n entries (3.7 MB at 720p), which L2
// holds, so staging it in shared memory would not help. 
//
// The selection is bound by its launch: at 720p a frame has a few thousand
// components (~30 KB of tables, a few passes from L2 in one block), and its
// serial steps are block barriers, a few dozen at that size.  The fill is
// bound by device memory (4 bytes a bin written).  One block a frame keeps
// the ordered ranks in one place; at nc = n (every pixel a component) its
// passes take one SM's bandwidth and a few thousand barriers.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// find and union on a parent array in device memory: parents only decrease,
// so a stale read still leads to the root
__device__ __forceinline__ int find_root(const volatile int32_t* parent,
                                         int x) {
    int y = parent[x];
    while (y != x) {
        x = y;
        y = parent[x];
    }
    return x;
}

__device__ __forceinline__ void unite(int32_t* parent, int a, int b) {
    const volatile int32_t* vp = parent;
    while (true) {
        a = find_root(vp, a);
        b = find_root(vp, b);
        if (a == b) return;
        if (a > b) {
            int t = a;
            a = b;
            b = t;
        }
        int old = atomicMin(parent + b, a);
        if (old == b) return;  // b was a root and now hangs under a
        b = old;               // b was relinked meanwhile: join a with its parent
    }
}

constexpr int kTile = 32;                        // tile side
constexpr int kGroupRows = 4;                    // rows a warp scans
constexpr int kScanWarps = kTile / kGroupRows;   // warps a tile
// at most one merge a column and pair of neighbouring rows
constexpr int kMaxPairs = kTile * (kTile - 1);

// one block (kScanWarps warps) a 32x32 tile; out[p] = the global index of
// the minimum pixel of p's piece in the tile.  Labels are tile-local pixel
// indices.  Warp w scans rows 4w..4w+3 top-down, a lane a column: a run
// (from a ballot over label != left label) takes the smallest label among
// the equal-label pixels above it (a segmented min over the run), or its
// start as a fresh label; where it also touches a different label above, the
// pair is recorded (once a span above).  The rows where two warps' groups
// meet add a pair where two equal-label runs first touch.  The pairs are
// then resolved in rounds: hook the larger representative under the smaller
// (atomicMin), point each pair's labels at their representatives'
// representatives, until nothing changes; every label of a piece then
// points at the piece's smallest label, which is its minimum pixel (a fresh
// label is a run start, and the piece's first pixel starts a run with
// nothing of the piece above it).
__global__ void __launch_bounds__(32 * kScanWarps)
cc_local(const int32_t* __restrict__ labels, int32_t* __restrict__ out,
         int H, int W) {
    __shared__ int32_t eq[kTile * kTile];
    __shared__ int2 pairs[kMaxPairs];
    __shared__ int npairs;
    __shared__ int32_t last_lab[kScanWarps][kTile];
    __shared__ int32_t last_lbl[kScanWarps][kTile];
    __shared__ uint32_t last_runs[kScanWarps];
    constexpr unsigned kAll = 0xFFFFFFFFu;
    constexpr int kNoLabel = 0x7FFFFFFF;
    const int c = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int gj = blockIdx.x * kTile + c;
    const int r0 = w * kGroupRows;
    const int gi0 = blockIdx.y * kTile + r0;
    if (threadIdx.x == 0) npairs = 0;
    int lab[kGroupRows], lbl[kGroupRows];
    uint32_t runs[kGroupRows];
#pragma unroll
    for (int k = 0; k < kGroupRows; ++k)
        lab[k] = gi0 + k < H && gj < W ? labels[(gi0 + k) * W + gj] : 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGroupRows; ++k) {
        // pixels past the edge are runs of their own and join nothing
        const bool valid = gi0 + k < H && gj < W;
        const int left = __shfl_up_sync(kAll, lab[k], 1);
        runs[k] = __ballot_sync(kAll, c == 0 || !valid || left != lab[k]);
        const int s = 31 - __clz(runs[k] & (kAll >> (31 - c)));
        const uint32_t after = runs[k] & ~(kAll >> (31 - c));
        const int e = after ? __ffs(after) - 2 : 31;
        const int kp = k > 0 ? k - 1 : 0;
        const bool up = k > 0 && valid && lab[k] == lab[kp];
        const int above = up ? lbl[kp] : kNoLabel;
        int m = above;  // min over the run [s, e]
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_down_sync(kAll, m, off);
            if (c + off <= e) m = min(m, o);
        }
        m = __shfl_sync(kAll, m, s);
        const int fresh = (r0 + k) * kTile + s;
        lbl[k] = m == kNoLabel ? fresh : m;
        if (valid && c == s && m == kNoLabel) eq[fresh] = fresh;
        const int left_above = __shfl_up_sync(kAll, above, 1);
        if (up && above != lbl[k] && (c == s || left_above != above))
            pairs[atomicAdd(&npairs, 1)] = make_int2(above, lbl[k]);
    }
    last_lab[w][c] = lab[kGroupRows - 1];
    last_lbl[w][c] = lbl[kGroupRows - 1];
    if (c == 0) last_runs[w] = runs[kGroupRows - 1];
    __syncthreads();
    // group w's first row below group w - 1's last row: two equal-label
    // runs first touch where one of them starts
    if (w > 0 && gi0 < H && gj < W && last_lab[w - 1][c] == lab[0] &&
        (((runs[0] | last_runs[w - 1]) >> c) & 1))
        pairs[atomicAdd(&npairs, 1)] = make_int2(last_lbl[w - 1][c], lbl[0]);
    __syncthreads();
    const int np = npairs;
    volatile int32_t* veq = eq;
    bool changed = np > 0;
    while (__syncthreads_or(changed)) {
        changed = false;
        for (int i = threadIdx.x; i < np; i += blockDim.x) {
            const int2 pr = pairs[i];
            const int ra = veq[pr.x], rb = veq[pr.y];
            if (ra != rb) {
                atomicMin(eq + max(ra, rb), min(ra, rb));
                changed = true;
            }
        }
        __syncthreads();
        for (int i = threadIdx.x; i < np; i += blockDim.x) {
            const int2 pr = pairs[i];
            const int ends[2] = {pr.x, pr.y};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int up1 = veq[ends[q]], up2 = veq[up1];
                if (up2 != up1) {
                    atomicMin(eq + ends[q], up2);
                    changed = true;
                }
            }
        }
    }
#pragma unroll
    for (int k = 0; k < kGroupRows; ++k) {
        if (gi0 + k < H && gj < W) {
            const int root = eq[lbl[k]];
            out[(gi0 + k) * W + gj] = (blockIdx.y * kTile + root / kTile) * W +
                                      blockIdx.x * kTile + root % kTile;
        }
    }
}

// one thread a seam pixel: first the top rows of tile rows 1.., then the
// left columns of tile columns 1..; each unites with its neighbour across
// the seam where the labels are equal and one of the two runs along the
// seam (tile-local, so already one piece) starts there
__global__ void cc_seams(const int32_t* __restrict__ labels, int32_t* parent,
                         int H, int W, int row_seams, int col_seams) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    const int across = row_seams * W;
    if (t < across) {
        const int k = t / W;
        const int j = t - k * W;
        const int p = (k + 1) * kTile * W + j;
        const int lab = labels[p];
        if (labels[p - W] == lab &&
            (j % kTile == 0 || labels[p - 1] != lab ||
             labels[p - W - 1] != lab))
            unite(parent, p - W, p);
        return;
    }
    t -= across;
    if (t >= col_seams * H) return;
    const int k = t / H;
    const int i = t - k * H;
    const int p = i * W + (k + 1) * kTile;
    const int lab = labels[p];
    if (labels[p - 1] == lab &&
        (i % kTile == 0 || labels[p - W] != lab || labels[p - W - 1] != lab))
        unite(parent, p - 1, p);
}

__global__ void cc_flatten(int32_t* parent, int n) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p < n) parent[p] = find_root(parent, p);
}

constexpr int32_t UNASSIGNED = 0xFFFF;

// out-of-range ids read nothing; the wrappers never pass them
__device__ __forceinline__ int32_t gather(const int32_t* __restrict__ table,
                                          int k, int table_size) {
    return (unsigned)k < (unsigned)table_size ? __ldg(table + k) : -1;
}

// vec: ids and out are 16-byte aligned, so quads go as int4
template <bool vec>
__global__ void lookup_kernel(const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ table,
                              int32_t* __restrict__ out, int n,
                              int table_size) {
    int stride = gridDim.x * blockDim.x;
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    int scalar_from = 0;
    if (vec) {
        int quads = n >> 2;
        for (int q = t; q < quads; q += stride) {
            int4 k = __ldg(reinterpret_cast<const int4*>(ids) + q);
            reinterpret_cast<int4*>(out)[q] = make_int4(
                gather(table, k.x, table_size),
                gather(table, k.y, table_size),
                gather(table, k.z, table_size),
                gather(table, k.w, table_size));
        }
        scalar_from = quads << 2;
    }
    for (int p = scalar_from + t; p < n; p += stride)
        out[p] = gather(table, __ldg(ids + p), table_size);
}

constexpr int kSelThreads = 1024;                // a frame's block
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kSelItems = 4;                     // entries a thread a round
constexpr int kRound = kSelThreads * kSelItems;  // entries a round
constexpr int kRoundLog = 12;                    // log2(kRound)
constexpr int kDigitBits = 12;                   // radix digit
constexpr int kDigits = 1 << kDigitBits;         // histogram bins
constexpr int kBinsPerThread = kDigits / kSelThreads;
static_assert(kSelWarps == 32, "the warp totals are reduced by one warp");
static_assert(1 << kRoundLog == kRound, "kRoundLog");
static_assert(kDigits <= 2 * kRound, "the histogram shares the chase's");

// inclusive sum of v over the block (in thread order); *total gets the sum
// of all.  Every thread of the block calls it; scratch: kSelWarps ints
__device__ __forceinline__ int block_scan(int v, int* scratch, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
        if (lane >= d) v += u;
    }
    if (lane == 31) scratch[warp] = v;
    __syncthreads();
    if (warp == 0) {
        int w = scratch[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int u = __shfl_up_sync(0xFFFFFFFFu, w, d);
            if (lane >= d) w += u;
        }
        scratch[lane] = w;
    }
    __syncthreads();
    const int before = warp > 0 ? scratch[warp - 1] : 0;
    *total = scratch[kSelWarps - 1];
    __syncthreads();  // scratch is free for the next call
    return v + before;
}

// the largest v over the block; the same calling rules
__device__ __forceinline__ unsigned block_max(unsigned v, int* scratch) {
    v = __reduce_max_sync(0xFFFFFFFFu, v);
    if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = (int)v;
    __syncthreads();
    v = 0;
#pragma unroll 8
    for (int w = 0; w < kSelWarps; ++w) v = max(v, (unsigned)scratch[w]);
    __syncthreads();
    return v;
}

// an area's radix key: clamped to [0, cap], cap = n_pixels + 1, which
// leaves every comparison with a T in [0, n_pixels] as it is
__device__ __forceinline__ uint32_t area_key(int a, uint32_t cap) {
    return a < 0 ? 0u : min((uint32_t)a, cap);
}

// this thread's entries of the round from r, kSelThreads apart (each load
// coalesced, all four in flight at once); in[j]: the entry is below nc
__device__ __forceinline__ void load_round(const int32_t* __restrict__ src,
                                           int r, int nc,
                                           int (&v)[kSelItems],
                                           bool (&in)[kSelItems]) {
#pragma unroll
    for (int j = 0; j < kSelItems; ++j) {
        const int i = r + j * kSelThreads + threadIdx.x;
        in[j] = i < nc;
        v[j] = in[j] ? src[i] : 0;
    }
}

// Blocks [0, B): frame blockIdx.x's selection (see the note at the top).
// Blocks from B on: the zero fill of every frame's bins [nc, n).
// areas, target: frame f at f * frame_stride; sub: int32 [B, n]; tie: one
// byte a frame; k = min(K, n_pixels).
__global__ void __launch_bounds__(kSelThreads)
cca_select_kernel(const int32_t* __restrict__ areas,
                  const int32_t* __restrict__ target, long long frame_stride,
                  const int64_t* __restrict__ num_components, int32_t* sub,
                  uint8_t* __restrict__ tie, int B, int n, int k, int thr,
                  int n_pixels) {
    if ((int)blockIdx.x >= B) {
        const int stride = (gridDim.x - B) * kSelThreads;
        const int t = (blockIdx.x - B) * kSelThreads + threadIdx.x;
        for (int f = 0; f < B; ++f) {
            const long long c = num_components[f];
            const int nc = c < 0 ? 0 : c > n ? n : (int)c;
            int32_t* out = sub + (long long)f * n;
            for (int i = nc + t; i < n; i += stride) out[i] = 0;
        }
        return;
    }
    // the histogram of a., then the chase's values and pointers of d.
    __shared__ int buf[2 * kRound];
    __shared__ int scratch[kSelWarps];
    __shared__ int s_digit, s_above;
    int* const hist = buf;
    int* const s_val = buf;
    int* const s_ptr = buf + kRound;
    const int t = threadIdx.x, lane = t & 31;
    const int f = blockIdx.x;
    areas += f * frame_stride;
    target += f * frame_stride;
    sub += (long long)f * n;
    const long long c = num_components[f];
    const int nc = c < 0 ? 0 : c > n ? n : (int)c;
    const uint32_t cap = (uint32_t)n_pixels + 1u;
    int a[kSelItems];
    bool in[kSelItems];

    // a. the areas over the threshold: their count and largest key
    int count_pre = 0;
    unsigned kmax = 0;
    {
        int cnt = 0;
        for (int r = 0; r < nc; r += kRound) {
            load_round(areas, r, nc, a, in);
#pragma unroll
            for (int j = 0; j < kSelItems; ++j) {
                if (in[j] && a[j] >= thr) {
                    ++cnt;
                    kmax = max(kmax, area_key(a[j], cap));
                }
            }
        }
        block_scan(cnt, scratch, &count_pre);
        kmax = block_max(kmax, scratch);
    }
    // the k-th largest key, a digit a pass from the top of kmax's bits
    const bool selected = k > 0 && count_pre >= k;
    uint32_t prefix = 0;  // the digits chosen so far
    if (selected) {
        int krem = k;     // rank sought among the keys under that prefix
        const int bits = 32 - __clz((int)kmax);
        const int passes = bits > 0 ? (bits + kDigitBits - 1) / kDigitBits
                                    : 1;
        for (int p = 0; p < passes; ++p) {
            const int shift = (passes - 1 - p) * kDigitBits;
            for (int d = t; d < kDigits; d += kSelThreads) hist[d] = 0;
            __syncthreads();
            for (int r = 0; r < nc; r += kRound) {
                load_round(areas, r, nc, a, in);
#pragma unroll
                for (int j = 0; j < kSelItems; ++j) {
                    // a warp's lanes with one digit add once
                    const uint32_t u = area_key(a[j], cap);
                    const bool want =
                        in[j] && a[j] >= thr &&
                        ((uint64_t)u >> (shift + kDigitBits)) == prefix;
                    const int digit = (u >> shift) & (kDigits - 1);
                    const unsigned same = __match_any_sync(
                        0xFFFFFFFFu, want ? digit : kDigits + lane);
                    if (want && lane == __ffs(same) - 1)
                        atomicAdd(hist + digit, __popc(same));
                }
            }
            __syncthreads();
            // thread t holds bins kDigits-1-4t down to kDigits-4-4t
            int own[kBinsPerThread], sum = 0;
#pragma unroll
            for (int j = 0; j < kBinsPerThread; ++j) {
                own[j] = hist[kDigits - 1 - (t * kBinsPerThread + j)];
                sum += own[j];
            }
            int total;
            const int incl = block_scan(sum, scratch, &total);
            int above = incl - sum;  // keys in the bins above this thread's
            if (above < krem && krem <= incl) {  // one thread: the crossing
#pragma unroll
                for (int j = 0; j < kBinsPerThread; ++j) {
                    if (above + own[j] >= krem) {
                        s_digit = kDigits - 1 - (t * kBinsPerThread + j);
                        s_above = above;
                        break;
                    }
                    above += own[j];
                }
            }
            __syncthreads();
            prefix = (prefix << kDigitBits) | (uint32_t)s_digit;
            krem -= s_above;
            __syncthreads();  // s_digit, s_above and hist are rewritten next
        }
    }
    // T: the least T in [0, n_pixels] with fewer than k areas above it; 0
    // where fewer than k pass the threshold, and past every area where
    // k = 0 (nothing kept)
    const int T = selected ? (int)prefix : k > 0 ? 0 : (int)cap;

    // b. areas above T and equal to it; fill and the tie flag
    int n_gt, n_eq;
    {
        int gt = 0, eq = 0;
        for (int r = 0; r < nc; r += kRound) {
            load_round(areas, r, nc, a, in);
#pragma unroll
            for (int j = 0; j < kSelItems; ++j) {
                if (in[j] && a[j] >= thr) {
                    gt += a[j] > T;
                    eq += a[j] == T;
                }
            }
        }
        block_scan(gt, scratch, &n_gt);
        block_scan(eq, scratch, &n_eq);
    }
    const int fill = k - n_gt;
    if (t == 0) tie[f] = count_pre > k && fill < n_eq;

    // c. keep and renumber in leader order: a round's entries 4 a thread,
    // consecutive, so a block scan over the threads follows leader order
    int eq_base = 0, kept_base = 0;
    for (int base = 0; base < nc; base += kRound) {
        const int i0 = base + t * kSelItems;
        bool gt_t[kSelItems], eq_t[kSelItems];
        int my_eq = 0;
#pragma unroll
        for (int j = 0; j < kSelItems; ++j) {
            const int v = i0 + j < nc ? areas[i0 + j] : 0;
            const bool pre = i0 + j < nc && v >= thr;
            gt_t[j] = pre && v > T;
            eq_t[j] = pre && v == T;
            my_eq += eq_t[j];
        }
        int tot_eq;
        int r_eq = eq_base + block_scan(my_eq, scratch, &tot_eq) - my_eq;
        bool kept[kSelItems];
        int my_kept = 0;
#pragma unroll
        for (int j = 0; j < kSelItems; ++j) {
            r_eq += eq_t[j];  // inclusive rank among the equal
            kept[j] = gt_t[j] || (eq_t[j] && r_eq <= fill);
            my_kept += kept[j];
        }
        int tot_kept;
        int r_kept =
            kept_base + block_scan(my_kept, scratch, &tot_kept) - my_kept;
#pragma unroll
        for (int j = 0; j < kSelItems; ++j) {
            const int i = i0 + j;
            if (i < nc)
                sub[i] = kept[j] ? r_kept++ : i == 0 ? 0 : UNASSIGNED;
        }
        eq_base += tot_eq;
        kept_base += tot_kept;
    }
    __syncthreads();  // the block's writes are visible to the whole block

    // d. orphan adoption, a round of kRound entries at a time in leader
    // order; every entry of an earlier round is final.  v[j]: entry
    // base + e[j]'s label, UNASSIGNED while it waits on the round's entry
    // q[j]
    for (int base = 0; base < nc; base += kRound) {
        int v[kSelItems], q[kSelItems], e[kSelItems];
        bool orphan[kSelItems];
        load_round(sub, base, nc, v, in);
#pragma unroll
        for (int j = 0; j < kSelItems; ++j) {
            e[j] = j * kSelThreads + t;
            orphan[j] = in[j] && v[j] == UNASSIGNED;
            q[j] = orphan[j] ? target[base + e[j]] : 0;
        }
#pragma unroll
        for (int j = 0; j < kSelItems; ++j) {
            const int i = base + e[j], jt = q[j];
            q[j] = -1;
            if (!orphan[j]) continue;
            if ((unsigned)jt >= (unsigned)i) {
                v[j] = 0;  // itself, a later entry or below 0: no CCA's table
            } else if (jt < base) {
                v[j] = sub[jt];
            } else {
                q[j] = jt - base;
            }
        }
#pragma unroll
        for (int j = 0; j < kSelItems; ++j) {
            s_val[e[j]] = v[j];
            s_ptr[e[j]] = q[j];
        }
        __syncthreads();
        // pointer jumping: after step r an entry's pointer is 2^r hops on,
        // so a chain inside the round (< kRound hops, each to a lower
        // entry) ends by step kRoundLog
        for (int step = 0; step <= kRoundLog; ++step) {
            bool waits = false;
#pragma unroll
            for (int j = 0; j < kSelItems; ++j) {
                if (v[j] == UNASSIGNED && q[j] >= 0) {
                    waits = true;
                    const int qv = s_val[q[j]];
                    if (qv != UNASSIGNED)
                        v[j] = qv;
                    else
                        q[j] = s_ptr[q[j]];
                }
            }
            if (!__syncthreads_or(waits)) break;
#pragma unroll
            for (int j = 0; j < kSelItems; ++j) {
                s_val[e[j]] = v[j];
                s_ptr[e[j]] = q[j];
            }
            __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < kSelItems; ++j)
            if (orphan[j]) sub[base + e[j]] = v[j];
        __syncthreads();  // the round's entries are final in sub; buf free
    }
}

constexpr int32_t kBig = 0x7FFFFFFF;

// table[p] = m0[p] at a root (roots[p] == p), 0x7FFFFFFF elsewhere.  vec:
// roots, m0 and table are 16-byte aligned, so quads go as int4; a grid of
// a few blocks per SM strides over the pixels
__device__ __forceinline__ int32_t own_seed(int r, int v, int p) {
    return r == p ? v : kBig;
}

template <bool vec>
__global__ void rt_init(const int32_t* __restrict__ roots,
                        const int32_t* __restrict__ m0,
                        int32_t* __restrict__ table, int n) {
    const int stride = gridDim.x * blockDim.x;
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    int scalar_from = 0;
    if (vec) {
        const int quads = n >> 2;
        for (int q = t; q < quads; q += stride) {
            const int4 r = __ldg(reinterpret_cast<const int4*>(roots) + q);
            const int4 v = __ldg(reinterpret_cast<const int4*>(m0) + q);
            const int p = q << 2;
            reinterpret_cast<int4*>(table)[q] = make_int4(
                own_seed(r.x, v.x, p), own_seed(r.y, v.y, p + 1),
                own_seed(r.z, v.z, p + 2), own_seed(r.w, v.w, p + 3));
        }
        scalar_from = quads << 2;
    }
    for (int p = scalar_from + t; p < n; p += stride)
        table[p] = own_seed(__ldg(roots + p), __ldg(m0 + p), p);
}

__global__ void rt_scatter(const int32_t* __restrict__ roots,
                           const int32_t* __restrict__ m0, int32_t* table,
                           int n) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    const int r = roots[p];
    if (r == p) return;  // rt_init put the root's own seed in its slot
    // the slot only decreases, so a pixel whose seed is not below what it
    // reads (a stale value is larger) has nothing to add: most pixels of a
    // region skip the atomic on one contended address
    const int v = m0[p];
    if (v < *(volatile const int32_t*)(table + r)) atomicMin(table + r, v);
}

// every thread reaches the vote: blockDim is a multiple of 32.  A root
// outside the table is skipped (the wrappers never pass one).
__global__ void seam_min_kernel(int32_t* table,
                                const int32_t* __restrict__ roots_row,
                                const int32_t* __restrict__ lab_row,
                                const int32_t* __restrict__ lab_nb,
                                const int32_t* __restrict__ val_nb,
                                int32_t* changed, int stamp, int w,
                                int table_size) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    bool lowered = false;
    if (x < w && lab_row[x] == lab_nb[x]) {
        const int r = roots_row[x];
        const int v = val_nb[x];
        if ((unsigned)r < (unsigned)table_size &&
            v < *(volatile const int32_t*)(table + r))
            lowered = atomicMin(table + r, v) > v;
    }
    if (__any_sync(0xFFFFFFFFu, lowered) && (threadIdx.x & 31) == 0)
        *changed = stamp;
}

int sm_count() {
    static int count = 0;
    if (count == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
        if (count <= 0) count = 1;
    }
    return count;
}

void region_table(const int32_t* m0, const int32_t* roots, int32_t* table,
                  int n, cudaStream_t s) {
    const int threads = 256;
    const bool vec = (((uintptr_t)m0 | (uintptr_t)roots | (uintptr_t)table) &
                      15) == 0;
    int blocks = ((vec ? (n + 3) / 4 : n) + threads - 1) / threads;
    if (blocks > 8 * sm_count()) blocks = 8 * sm_count();
    if (vec)
        rt_init<true><<<blocks, threads, 0, s>>>(roots, m0, table, n);
    else
        rt_init<false><<<blocks, threads, 0, s>>>(roots, m0, table, n);
    rt_scatter<<<(n + threads - 1) / threads, threads, 0, s>>>(roots, m0,
                                                                table, n);
}

void launch_lookup(const int32_t* ids, const int32_t* table, int32_t* out,
                   int n, int table_size, cudaStream_t s) {
    const int threads = 256;
    bool vec = (((uintptr_t)ids | (uintptr_t)out) & 15) == 0;
    int work = vec ? (n + 3) / 4 : n;
    int blocks = (work + threads - 1) / threads;
    int cap = 8 * sm_count();
    if (blocks > cap) blocks = cap;
    if (vec)
        lookup_kernel<true><<<blocks, threads, 0, s>>>(ids, table, out, n,
                                                        table_size);
    else
        lookup_kernel<false><<<blocks, threads, 0, s>>>(ids, table, out, n,
                                                         table_size);
}

}  // namespace

// out: int32 [H, W] component ids (min linear index of the region)
extern "C" int fstt_cc(const void* labels, void* out, int H, int W,
                       void* stream) {
    if (H > 0 && W > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        dim3 tiles((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
        cc_local<<<tiles, 32 * kScanWarps, 0, s>>>(
            (const int32_t*)labels, (int32_t*)out, H, W);
        int row_seams = tiles.y - 1, col_seams = tiles.x - 1;
        int seam_pixels = row_seams * W + col_seams * H;
        if (seam_pixels > 0) {  // one tile: its roots are the components
            int threads = 256;
            cc_seams<<<(seam_pixels + threads - 1) / threads, threads, 0,
                       s>>>((const int32_t*)labels, (int32_t*)out, H, W,
                            row_seams, col_seams);
            int n = H * W;
            cc_flatten<<<(n + threads - 1) / threads, threads, 0, s>>>(
                (int32_t*)out, n);
        }
    }
    return (int)cudaGetLastError();
}

// m0: int32 [n] seed; roots: int32 [n], the components of the labels
// (fstt_cc); table: int32 [n], the minimum of m0 over the region at each
// root's slot, 0x7FFFFFFF at every other slot
extern "C" int fstt_region_table(const void* m0, const void* roots,
                                 void* table, int n, void* stream) {
    if (n > 0)
        region_table((const int32_t*)m0, (const int32_t*)roots,
                     (int32_t*)table, n, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// table: int32 [table_size], lowered in place; roots_row, lab_row, lab_nb,
// val_nb: int32 [w], one edge row of a slab and the row across its seam;
// changed: int32 [1], set to stamp where a slot went down
extern "C" int fstt_seam_min(void* table, const void* roots_row,
                             const void* lab_row, const void* lab_nb,
                             const void* val_nb, void* changed, int stamp,
                             int w, int table_size, void* stream) {
    if (w > 0) {
        const int threads = 256;
        seam_min_kernel<<<(w + threads - 1) / threads, threads, 0,
                          (cudaStream_t)stream>>>(
            (int32_t*)table, (const int32_t*)roots_row,
            (const int32_t*)lab_row, (const int32_t*)lab_nb,
            (const int32_t*)val_nb, (int32_t*)changed, stamp, w, table_size);
    }
    return (int)cudaGetLastError();
}

// m0, roots as fstt_region_table; table: int32 [n] scratch; out: int32
// [n], the minimum of m0 over each pixel's region
extern "C" int fstt_propagate_min(const void* m0, const void* roots,
                                  void* table, void* out, int n,
                                  void* stream) {
    if (n > 0) {
        cudaStream_t s = (cudaStream_t)stream;
        region_table((const int32_t*)m0, (const int32_t*)roots,
                     (int32_t*)table, n, s);
        launch_lookup((const int32_t*)roots, (const int32_t*)table,
                      (int32_t*)out, n, n, s);
    }
    return (int)cudaGetLastError();
}

extern "C" int fstt_lookup(const void* ids, const void* table, void* out,
                           int n, int table_size, void* stream) {
    if (n > 0)
        launch_lookup((const int32_t*)ids, (const int32_t*)table,
                      (int32_t*)out, n, table_size, (cudaStream_t)stream);
    return (int)cudaGetLastError();
}

// areas, target: int32, frame f's n bins from f * frame_stride (unit
// stride); num_components: int64 [B] on the device; substitute: int32
// [B, n], every entry written; tie: B bytes; k = min(K, n_pixels)
extern "C" int fstt_cca_select(const void* areas, const void* target,
                               long long frame_stride,
                               const void* num_components, void* substitute,
                               void* tie, int B, int n, int k,
                               int min_threshold, int n_pixels,
                               void* stream) {
    if (B > 0) {
        const int per_block = kSelThreads * 8;
        long long fill = ((long long)n * B + per_block - 1) / per_block;
        if (fill > 2 * sm_count()) fill = 2 * sm_count();
        cca_select_kernel<<<B + (int)fill, kSelThreads, 0,
                            (cudaStream_t)stream>>>(
            (const int32_t*)areas, (const int32_t*)target, frame_stride,
            (const int64_t*)num_components, (int32_t*)substitute,
            (uint8_t*)tie, B, n, k, min_threshold, n_pixels);
    }
    return (int)cudaGetLastError();
}
