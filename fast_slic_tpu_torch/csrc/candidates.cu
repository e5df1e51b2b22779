// Per-cell candidate lists of B frames: for every S-cell, the active
// clusters whose centre lies in its 3x3 cell neighbourhood, in visit order,
// the first C of them, -1 after; and a flag raised when some cell of some
// frame has more than C.
//
// Replaces fast_slic_tpu/pipeline.py:build_candidates, XLA ops in the JAX
// package (no TPU kernel), whose plain version (kernels/candidates.py:
// plain) replicates every cluster into its up to 9 cells, sorts the
// (cell, visit key) pairs of each frame as one composite key and ranks the
// runs of one cell with a cummax: about 88 aten calls a build, each a
// launch on the card.
//
// No sort is needed.  Every caller's visit key is phase * K + k with the
// phase in 0..3 (pipeline.visit_order_key: the reference's four-phase
// checkerboard, context.cpp:214-242; a row shard passes the same function
// of the image's own coordinates), so key order is four passes over the
// cluster number k, one a phase.  A cell's list is the subsequence of that
// order whose centres lie in its 3x3 neighbourhood.
//
// Bound on the card: neither bytes nor operations.  A build reads 12
// bytes a cluster (20 with keys) for each cell row, from L2 after the
// first, and writes B * GH * GW * C * 4 bytes (104 KB at 720p, C = 16:
// about 0.03 us at 3.35 TB/s).  The time is the launch and a few dependent
// rounds of loads and barriers; the design keeps those rounds few.
//
// A block a (frame, cell row r), 1024 threads.  The band list: the active
// clusters whose clamped centre row lies in r-1..r+1, in key order, as
// (k, clamped centre column).  Two sweeps over the K clusters build it:
// the first counts the band's clusters of each phase (each phase's run
// starts after the runs of the lower phases), the second places them in
// chunks of 1024 with an order-preserving compaction (a ballot a phase
// and warp, the counts of the lower warps, the run's cursor).  Then a warp
// a cell j walks the list 32 entries at a time and keeps, in order, those
// whose centre column lies in j-1..j+1 (a ballot and its prefix count):
// the first C go to the cell's slots, the rest are counted, and the walk
// stops once C + 1 have been found.  The slots past the count take -1, so
// every slot of cand is written and no fill precedes the launch.  Two
// variants read slower on the H100 at 720p: a warp scan of the warps'
// counts with 32-bit division, 8.9 to 9.1 us a launch against 8.5 to 8.6;
// with every load issued before the tests besides, 8.8 to 9.0.
//
// The list holds up to K entries (all centres in one band): 8 * K bytes
// of dynamic shared memory, up to the block's 227 KB (K <= 28,988).
// Past that the wrapper hands a device scratch of K entries for each of
// at most kScratchBlocks blocks, which then stride over the cell rows.
//
// A centre's cell is the plain version's: clamp(trunc(y) // S, 0, GH - 1)
// with floor division, since a row shard's local y can be negative.  The
// flag is written only as true, so a caller may pass the loop's running
// flag and have it OR-ed in place.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;        // a block's shared memory on sm_90
constexpr int kScratchBlocks = 132;     // blocks of the scratch path

// Python's a // b for b > 0
__device__ __forceinline__ long long floor_div(long long a, long long b) {
    const long long q = a / b;
    return (q * b != a && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clamp_cell(long long c, int n) {
    return (int)(c < 0 ? 0 : (c > n - 1 ? n - 1 : c));
}

// Cluster k's phase (0..3) if it is active and its centre's cell row lies
// in r-1..r+1, else -1; its clamped cell column in *cj.
template <bool kHasKey>
__device__ __forceinline__ int band_phase(
        const float* __restrict__ y, const float* __restrict__ x,
        const int32_t* __restrict__ active, const int64_t* __restrict__ key,
        int k, int K, int S, int T, int GH, int GW, int r, int* cj) {
    if (active[k] == 0) return -1;
    const long long iy = (long long)y[k];   // truncation, as .to(int64)
    const int ci = clamp_cell(floor_div(iy, S), GH);
    if (ci < r - 1 || ci > r + 1) return -1;
    const long long ix = (long long)x[k];
    *cj = clamp_cell(floor_div(ix, S), GW);
    if constexpr (kHasKey) return (int)(key[k] / K);
    // pipeline.visit_order_key: 2 * (y // T % 2) + (x // T % 2)
    return 2 * (int)(floor_div(iy, T) & 1) + (int)(floor_div(ix, T) & 1);
}

__device__ __forceinline__ unsigned pick(const unsigned (&v)[4], int p) {
    return p == 0 ? v[0] : p == 1 ? v[1] : p == 2 ? v[2] : v[3];
}

template <bool kHasKey>
__global__ void __launch_bounds__(kThreads) candidates_kernel(
        const float* __restrict__ ys, const float* __restrict__ xs,
        const int32_t* __restrict__ actives, const int64_t* __restrict__ keys,
        int B, int K, int S, int GH, int GW, int C,
        int2* __restrict__ scratch, int32_t* __restrict__ cand,
        bool* __restrict__ overflow) {
    extern __shared__ int2 smem_band[];
    __shared__ int phase_count[4];
    __shared__ int cursor[4];
    __shared__ int warp_count[4][kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int T = 2 * S + 32;
    int2* band = scratch ? scratch + (size_t)blockIdx.x * K : smem_band;

    for (int row = blockIdx.x; row < B * GH; row += gridDim.x) {
        const int b = row / GH, r = row - b * GH;
        const float* y = ys + (size_t)b * K;
        const float* x = xs + (size_t)b * K;
        const int32_t* active = actives + (size_t)b * K;
        const int64_t* key = kHasKey ? keys + (size_t)b * K : nullptr;

        // 1. the band's clusters of each phase
        if (threadIdx.x < 4) phase_count[threadIdx.x] = 0;
        __syncthreads();
        int n0 = 0, n1 = 0, n2 = 0, n3 = 0;
        for (int k = threadIdx.x; k < K; k += kThreads) {
            int cj;
            const int p = band_phase<kHasKey>(y, x, active, key, k, K, S, T,
                                              GH, GW, r, &cj);
            n0 += p == 0; n1 += p == 1; n2 += p == 2; n3 += p == 3;
        }
        n0 = __reduce_add_sync(kFull, n0);
        n1 = __reduce_add_sync(kFull, n1);
        n2 = __reduce_add_sync(kFull, n2);
        n3 = __reduce_add_sync(kFull, n3);
        if (lane == 0 && (n0 | n1 | n2 | n3)) {
            atomicAdd(&phase_count[0], n0);
            atomicAdd(&phase_count[1], n1);
            atomicAdd(&phase_count[2], n2);
            atomicAdd(&phase_count[3], n3);
        }
        __syncthreads();
        if (threadIdx.x < 4) {
            int start = 0;
            for (int q = 0; q < (int)threadIdx.x; ++q) start += phase_count[q];
            cursor[threadIdx.x] = start;
        }
        const int L = phase_count[0] + phase_count[1] + phase_count[2]
                      + phase_count[3];

        // 2. place them in key order: phase-major, then k
        for (int k0 = 0; k0 < K; k0 += kThreads) {
            const int k = k0 + threadIdx.x;
            int cj = 0, p = -1;
            if (k < K)
                p = band_phase<kHasKey>(y, x, active, key, k, K, S, T, GH,
                                        GW, r, &cj);
            unsigned bal[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) bal[q] = __ballot_sync(kFull, p == q);
            if (lane < 4) warp_count[lane][warp] = __popc(pick(bal, lane));
            __syncthreads();   // warp counts in; cursor set (first chunk)
            if (p >= 0) {
                int pos = cursor[p] + __popc(pick(bal, p) & below);
                for (int w = 0; w < warp; ++w) pos += warp_count[p][w];
                band[pos] = make_int2(k, cj);
            }
            __syncthreads();   // every cursor read
            if (threadIdx.x < 4) {
                int n = 0;
                for (int w = 0; w < kWarps; ++w) n += warp_count[threadIdx.x][w];
                cursor[threadIdx.x] += n;
            }
            __syncthreads();   // cursors advanced, warp counts free
        }

        // 3. a warp a cell: the list's entries of columns j-1..j+1, in order
        for (int j = warp; j < GW; j += kWarps) {
            int32_t* out = cand + ((size_t)row * GW + j) * C;
            int n = 0;
            for (int i0 = 0; i0 < L && n <= C; i0 += 32) {
                const int i = i0 + lane;
                bool hit = false;
                int k = 0;
                if (i < L) {
                    const int2 e = band[i];
                    hit = e.y >= j - 1 && e.y <= j + 1;
                    k = e.x;
                }
                const unsigned ball = __ballot_sync(kFull, hit);
                if (hit) {
                    const int slot = n + __popc(ball & below);
                    if (slot < C) out[slot] = k;
                }
                n += __popc(ball);
            }
            for (int s = n + lane; s < C; s += 32) out[s] = -1;
            if (n > C && lane == 0) *overflow = true;
        }
        __syncthreads();   // the list and the counts are reused
    }
}

template <bool kHasKey>
int launch(const void* y, const void* x, const void* active, const void* key,
           int B, int K, int S, int GH, int GW, int C, void* scratch,
           void* cand, void* overflow, int blocks, size_t smem,
           void* stream) {
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            candidates_kernel<kHasKey>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    candidates_kernel<kHasKey><<<blocks, kThreads, smem,
                                 (cudaStream_t)stream>>>(
        (const float*)y, (const float*)x, (const int32_t*)active,
        (const int64_t*)key, B, K, S, GH, GW, C, (int2*)scratch,
        (int32_t*)cand, (bool*)overflow);
    return (int)cudaGetLastError();
}

}  // namespace

// cand [B, GH, GW, C] int32 from y, x (f32), active (int32) and key (int64
// phase * K + k, or null for pipeline.visit_order_key of y, x), all
// [B, K]; *overflow (bool) set to true where a cell has more than C
// candidates and left as it is otherwise.  scratch: null to keep the band
// list in shared memory (8 * K bytes, at most what a block can take), else
// a device buffer of kScratchBlocks * K int2.
extern "C" int fstt_candidates(const void* y, const void* x,
                               const void* active, const void* key, int B,
                               int K, int S, int GH, int GW, int C,
                               void* scratch, void* cand, void* overflow,
                               void* stream) {
    if (B <= 0 || GH <= 0 || GW <= 0) return (int)cudaSuccess;
    if (K < 0 || S <= 0 || C < 0) return (int)cudaErrorInvalidValue;
    const size_t static_smem = 4 * (8 + 4 * kWarps);
    size_t smem = 0;
    int blocks = B * GH;
    if (scratch) {
        if (blocks > kScratchBlocks) blocks = kScratchBlocks;
    } else {
        smem = sizeof(int2) * (size_t)K;
        if (smem + static_smem > (size_t)kSmemMax)
            return (int)cudaErrorInvalidValue;
    }
    return key ? launch<true>(y, x, active, key, B, K, S, GH, GW, C, scratch,
                              cand, overflow, blocks, smem, stream)
               : launch<false>(y, x, active, key, B, K, S, GH, GW, C,
                               scratch, cand, overflow, blocks, smem, stream);
}
