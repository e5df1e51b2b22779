// f32 segment sums with an optional in-kernel weight multiply: LSC's
// weighted feature accumulation (after_update).
//
// Replaces fast_slic_tpu/pallas/segsum_tpu.py:_fsegsum_kernel (pallas_call
// in float_segsum_pallas).  The TPU serialised scatter-adds, so that kernel
// split every value into three bf16 mantissa chunks and accumulated them
// with one-hot matmuls inside a hi-bucket band.
//
// Here every bin is summed in pixel order from 0.0f: the order of the plain
// version (index_add_ on the CPU adds index by index), so the card's sums
// equal the CPU's bit for bit and do not change from run to run.  Float
// atomics would add in another order on every run, and LSC feeds its
// centroids back into ten assign passes a frame: such differences grew to
// 0.1 % of the labels of a 720p frame (PERF.md).
//
// A pixel adds vals * m, m = (mask != 0) as 0/1, and with wrow >= 0 the rows
// v < wrow are multiplied by row wrow (the per-pixel weight) times m first.
// For finite input a masked pixel adds +-0, which leaves a sum that starts
// at +0.0f unchanged (such a sum never holds -0), so masked pixels are left
// out of every bin; an unmasked pixel adds x (x * 1 is x) or x * w: the
// plain version's arithmetic, operation for operation (-fmad=false).  Ids
// outside [0, bins) add nothing.
//
// One call, four launches, no sort:
//   rank     one block a tile of 2048 consecutive pixels: the warps load the
//            tile and rank each 32-pixel chunk's equal bins
//            (__match_any_sync); one warp walks the chunks in order with
//            per-bin counters in shared memory, giving each kept pixel its
//            rank among the tile's pixels of its bin; the block writes the
//            tile's count of each bin;
//   scan     one block a group of 32 bins: each bin's counts over the tiles,
//            scanned, plus the bin's place in its group: where each tile's
//            pixels of the bin start, relative to the group;
//   scatter  one block a tile: the groups' totals, scanned; each kept
//            pixel's index goes to its bin's run at its rank (a stable
//            counting sort, so each run is in pixel order); the bins' starts;
//   sum      one warp a bin: the run is read in windows of 128 pixels, whose
//            rows are copied to shared memory asynchronously one window
//            ahead of the adds; lane v adds row v's values in run order.
//
// Bound on the card: the call must read ids, mask and vals (52 bytes a
// pixel) and write [V, bins]: 4.8 us at 720p stride 3 (307,200 pixels,
// K = 1600).  The sum gathers every row of every kept pixel at 4-byte
// granularity (13.5 MB there), which bounds it by memory throughput; the
// ordered adds are a chain per bin and the rank walk a chain per tile, so
// those are latency-bound, and the design spreads them over one warp a bin
// and one block a tile and keeps the walk's counters in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 2048;           // pixels a rank / scatter block
constexpr int TILE_THREADS = 256;
constexpr int SUM_WARPS = 4;         // bins a sum block
constexpr int WIN = 128;             // pixels of a run a sum window holds
constexpr int MAX_ROWS = 16;         // rows of vals a call may have
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
    for (int d = 1; d < 32; d <<= 1) {
        int u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += u;
    }
    return v;
}

// lrank [N]: each kept pixel's rank among its tile's pixels of its bin, -1
// for a dropped one; counts [T, bins]: each tile's count of each bin.
__global__ void fs_rank(const int32_t* __restrict__ ids,
                        const int32_t* __restrict__ mask,
                        int32_t* __restrict__ lrank,
                        int32_t* __restrict__ counts, int N, int bins) {
    constexpr int CHUNKS = TILE / 32;
    constexpr int WARPS = TILE_THREADS / 32;
    extern __shared__ int32_t smem[];
    int32_t* key = smem;                           // [TILE]: bin or -1
    int32_t* info = smem + TILE;                   // [TILE]: rank in chunk,
                                                   // bit 8: last of its bin
    uint16_t* hist = reinterpret_cast<uint16_t*>(smem + 2 * TILE);  // [bins]
    int lane = threadIdx.x & 31;
    int warp = threadIdx.x >> 5;
    int tile0 = blockIdx.x * TILE;
    for (int i = threadIdx.x; i < (bins + 1) / 2; i += blockDim.x)
        reinterpret_cast<uint32_t*>(hist)[i] = 0;
    // this warp's chunks warp + 8 u: every load first, then the ranks
    int kid[CHUNKS / WARPS], kmask[CHUNKS / WARPS];
#pragma unroll
    for (int u = 0; u < CHUNKS / WARPS; ++u) {
        int p = tile0 + (warp + u * WARPS) * 32 + lane;
        kmask[u] = p < N ? mask[p] : 0;
        kid[u] = p < N ? ids[p] : -1;
    }
#pragma unroll
    for (int u = 0; u < CHUNKS / WARPS; ++u) {
        int i = (warp + u * WARPS) * 32 + lane;
        int b = kmask[u] != 0 && (unsigned)kid[u] < (unsigned)bins ? kid[u]
                                                                    : -1;
        unsigned grp = __match_any_sync(FULL, b);
        key[i] = b;
        info[i] = __popc(grp & ((1u << lane) - 1))
                  | ((31 - __clz(grp)) == lane ? 0x100 : 0);
    }
    __syncthreads();
    if (warp == 0) {
        // the walk: chunk after chunk, in pixel order; only the counters
        // carry from one chunk to the next
        for (int c0 = 0; c0 < CHUNKS; c0 += 4) {
            int b[4], inf[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                b[u] = key[(c0 + u) * 32 + lane];
                inf[u] = info[(c0 + u) * 32 + lane];
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                int r = b[u] >= 0 ? hist[b[u]] + (inf[u] & 0xff) : -1;
                __syncwarp();
                if (b[u] >= 0 && (inf[u] & 0x100))
                    hist[b[u]] = (uint16_t)(r + 1);
                __syncwarp();
                int p = tile0 + (c0 + u) * 32 + lane;
                if (p < N) lrank[p] = r;
            }
        }
    }
    __syncthreads();
    int32_t* row = counts + (size_t)blockIdx.x * bins;
    for (int b = threadIdx.x; b < bins; b += blockDim.x) row[b] = hist[b];
}

// One block of 32 warps a group of 32 bins.  counts [T, bins] becomes offs:
// where tile t's pixels of bin b start, relative to the group's first
// pixel; gagg [G]: each group's count.  The [T, 32] column block goes
// through shared memory in slabs of 32 tiles, so every global access is a
// coalesced row of the group's 32 bins.
__global__ void fs_scan(int32_t* __restrict__ counts,
                        int32_t* __restrict__ gagg, int T, int bins) {
    __shared__ int32_t slab[32][33];
    __shared__ int32_t carry[32];
    int lane = threadIdx.x & 31;
    int warp = threadIdx.x >> 5;
    int b = blockIdx.x * 32 + lane;                // this lane's bin in rows
    bool in = b < bins;
    // the bins' totals: warp w sums rows w, w + 32, ...
    int part = 0;
    if (in) {
#pragma unroll 4
        for (int t = warp; t < T; t += 32)
            part += counts[(size_t)t * bins + b];
    }
    slab[warp][lane] = part;
    __syncthreads();
    if (warp == 0) {
        int total = 0;
        for (int w = 0; w < 32; ++w) total += slab[w][lane];
        int incl = warp_incl_scan(total, lane);
        carry[lane] = incl - total;                // bin's place in group
        if (lane == 31) gagg[blockIdx.x] = incl;
    }
    __syncthreads();
    int next = in && warp < T ? counts[(size_t)warp * bins + b] : 0;
    for (int t0 = 0; t0 < T; t0 += 32) {
        int t = t0 + warp;
        slab[warp][lane] = next;
        if (in && t + 32 < T) next = counts[(size_t)(t + 32) * bins + b];
        __syncthreads();
        // warp w scans bin w's column: tiles t0 + lane
        int v = slab[lane][warp];
        int incl = warp_incl_scan(v, lane);
        int c = carry[warp];
        slab[lane][warp] = c + incl - v;
        __syncthreads();
        if (lane == 31) carry[warp] = c + incl;
        if (in && t < T) counts[(size_t)t * bins + b] = slab[warp][lane];
        __syncthreads();
    }
}

// One block a tile: order [kept pixels] gets each kept pixel's index at its
// place in its bin's run; starts [bins + 1] (each block writes a share).
__global__ void fs_scatter(const int32_t* __restrict__ ids,
                           const int32_t* __restrict__ lrank,
                           const int32_t* __restrict__ offs,
                           const int32_t* __restrict__ gagg,
                           int32_t* __restrict__ starts,
                           int32_t* __restrict__ order, int N, int T,
                           int bins, int G) {
    constexpr int PER = TILE / TILE_THREADS;
    extern __shared__ int32_t gp[];                // [G + 1]
    int lane = threadIdx.x & 31;
    int tile0 = blockIdx.x * TILE;
    // this thread's pixels' bins and places in their tile's runs, loaded
    // while warp 0 scans the groups' totals
    int b[PER], r[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
        int p = tile0 + u * TILE_THREADS + threadIdx.x;
        r[u] = p < N ? lrank[p] : -1;
        b[u] = p < N ? ids[p] : 0;
        if (r[u] >= 0) r[u] += offs[(size_t)blockIdx.x * bins + b[u]];
    }
    if (threadIdx.x < 32) {
        int carry = 0;
        for (int g0 = 0; g0 < G; g0 += 32) {
            int g = g0 + lane;
            int v = g < G ? gagg[g] : 0;
            int incl = warp_incl_scan(v, lane);
            if (g < G) gp[g] = carry + incl - v;
            carry += __shfl_sync(FULL, incl, 31);
        }
        if (lane == 0) gp[G] = carry;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < PER; ++u)
        if (r[u] >= 0)
            order[gp[b[u] >> 5] + r[u]] = tile0 + u * TILE_THREADS
                                          + threadIdx.x;
    int share = (bins + T) / T;                    // ceil((bins + 1) / T)
    int b1 = min(bins + 1, (blockIdx.x + 1) * share);
    for (int k = blockIdx.x * share + threadIdx.x; k < b1; k += blockDim.x)
        starts[k] = k < bins ? gp[k >> 5] + offs[k] : gp[G];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

// One warp a bin: out [V, bins], every entry written.  The lanes load a
// window's 128 run entries at once and copy their rows into shared memory
// with asynchronous 4-byte copies (no registers held), one window ahead of
// the adds; lane v then adds row v's values of the window in run order.
__global__ void fs_sum(const int32_t* __restrict__ order,
                       const int32_t* __restrict__ starts,
                       const float* __restrict__ vals,
                       float* __restrict__ out, int N, int V, int bins,
                       int wrow) {
    extern __shared__ float stage[];       // [SUM_WARPS][2][V][WIN + 1]
    constexpr int PAD = WIN + 1;           // row v starts in bank v
    int lane = threadIdx.x & 31;
    int warp = threadIdx.x >> 5;
    int b = blockIdx.x * SUM_WARPS + warp;
    if (b >= bins) return;
    float* bufs = stage + (size_t)warp * 2 * V * PAD;
    int s = starts[b];
    int n = starts[b + 1] - s;
    auto load_idx = [&](int (&ix)[WIN / 32], int w) {
#pragma unroll
        for (int j = 0; j < WIN / 32; ++j) {
            int k = w * WIN + j * 32 + lane;
            ix[j] = k < n ? order[s + k] : -1;
        }
    };
    // copy window w's rows into its buffer; an empty group past the run
    auto issue = [&](const int (&ix)[WIN / 32], int w) {
        float* buf = bufs + (w & 1) * V * PAD;
#pragma unroll
        for (int j = 0; j < WIN / 32; ++j)
            if (ix[j] >= 0)
                for (int v = 0; v < V; ++v)
                    cp_async4(buf + v * PAD + j * 32 + lane,
                              vals + (size_t)v * N + ix[j]);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    int ix[WIN / 32];
    load_idx(ix, 0);
    issue(ix, 0);
    load_idx(ix, 1);
    float acc = 0.0f;
    bool weighted = lane < wrow;
    for (int w = 0; w * WIN < n; ++w) {
        issue(ix, w + 1);
        load_idx(ix, w + 2);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // window w
        __syncwarp();
        if (lane < V) {
            const float* buf = bufs + (w & 1) * V * PAD;
            const float* row = buf + lane * PAD;
            const float* wts = buf + (weighted ? wrow : 0) * PAD;
            int cnt = min(WIN, n - w * WIN);
#pragma unroll 8
            for (int j = 0; j < cnt; ++j) {
                float y = row[j];
                if (weighted) y = y * wts[j];
                acc = acc + y;
            }
        }
        __syncwarp();
    }
    if (lane < V) out[(size_t)lane * bins + b] = acc;
}

// The int32 scratch a call needs: counts [T * bins], gagg [G], starts
// [bins + 1], lrank [N], order [N]; T = max(1, ceil(N / 2048)), G =
// ceil(bins / 32) (kernels/fsegsum.py computes the same).
long long scratch_needed(int N, int bins) {
    long long T = N > 0 ? (N + TILE - 1) / TILE : 1;
    long long G = (bins + 31) / 32;
    return T * bins + G + bins + 1 + 2LL * N;
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// ids, mask int32 [N]; vals f32 [V, N]; out f32 [V, bins], every entry
// written; scratch int32 [scratch_len].  wrow < 0: no weight multiply.
// 1 <= V <= 16, 1 <= bins <= 65536.
extern "C" int fstt_fsegsum(const void* ids, const void* mask,
                            const void* vals, void* out, void* scratch,
                            long long scratch_len, int N, int V, int bins,
                            int wrow, void* stream) {
    if (V < 1 || V > MAX_ROWS || bins < 1 || bins > 65536 || N < 0
            || scratch_len < scratch_needed(N, bins))
        return (int)cudaErrorInvalidValue;
    int T = N > 0 ? (N + TILE - 1) / TILE : 1;
    int G = (bins + 31) / 32;
    int32_t* counts = (int32_t*)scratch;
    int32_t* gagg = counts + (size_t)T * bins;
    int32_t* starts = gagg + G;
    int32_t* lrank = starts + bins + 1;
    int32_t* order = lrank + N;
    cudaStream_t s = (cudaStream_t)stream;

    size_t rank_smem = 2 * TILE * sizeof(int32_t)
                       + ((bins + 1) / 2) * sizeof(uint32_t);
    size_t sum_smem = SUM_WARPS * 2 * V * (WIN + 1) * sizeof(float);
    cudaError_t err = allow_smem((const void*)fs_rank, rank_smem);
    if (err == cudaSuccess) err = allow_smem((const void*)fs_sum, sum_smem);
    if (err != cudaSuccess) return (int)err;
    fs_rank<<<T, TILE_THREADS, rank_smem, s>>>(
        (const int32_t*)ids, (const int32_t*)mask, lrank, counts, N, bins);
    fs_scan<<<G, 1024, 0, s>>>(counts, gagg, T, bins);
    fs_scatter<<<T, TILE_THREADS, (G + 1) * sizeof(int32_t), s>>>(
        (const int32_t*)ids, lrank, counts, gagg, starts, order, N, T, bins,
        G);
    fs_sum<<<(bins + SUM_WARPS - 1) / SUM_WARPS, SUM_WARPS * 32, sum_smem,
             s>>>(order, starts, (const float*)vals, (float*)out, N, V, bins,
                  wrow);
    return (int)cudaGetLastError();
}
