// Exact int32 segment sums with global atomics: the SLIC centroid update
// (plain and masked by the preemptive grid), the CCA area / orphan-target
// sums, and their per-frame form for stacked frames.
//
// Replaces four TPU kernels:
//   fast_slic_tpu/pallas/segsum_tpu.py:_update_padded_kernel
//     (pallas_call in slic_update_padded_pallas)      -> slic_update
//   fast_slic_tpu/pallas/segsum_tpu.py:_update_kernel
//     (pallas_call in slic_update_pallas)             -> slic_update_masked
//   fast_slic_tpu/pallas/segsum_tpu.py:_segsum_kernel
//     (pallas_call in segment_sum_pallas)             -> segment_sum
//   fast_slic_tpu/pallas/segsum_tpu.py:_framed_segsum_kernel
//     (pallas_call in framed_segment_sum_pallas)      -> framed_segment_sum
// The TPU serialised scatter-adds, so it built one-hot tiles in VMEM and
// reduced them with byte-split bf16 matmuls, which limited values to 2^16
// and needed hi-bucket band guards (masked pixels kept the tile's minimum
// id) and a per-frame VMEM output block.  Hopper has native int32 atomics:
// every kernel here first sums a tile's pixels on chip (below), then adds
// the tile's sums into a zeroed buffer.  Integer addition is associative,
// so the result is exact and independent of the order the atomics land
// in, and none of those devices is needed.
//
// slic_update builds [count, i, j, L, a, b] in-kernel from the
// full-resolution assignment and planes, for the rows i % stride == rem; a
// pixel counts if its id != 0xFFFF (the reference's update accumulators,
// context.cpp:309-354).  slic_update_masked also drops every pixel whose
// preemptive mask is 0, from the count too (preemptive.h: inactive cells
// are not accumulated).  Both take B stacked frames ([B, H, W] assignment,
// [3, B, H, W] planes, [B, H, W] mask): the frame is blockIdx.z, rows stay
// frame-local, and frame f's cluster k lands in bin f*K + k.
//
// The update's bound on the card is its reads: 16 bytes a pixel (17 with
// the mask), 4.9 MB a call at 720p stride 3, ~1.5 us at 3.35 TB/s and
// mostly from L2 on the main path.  One global atomic a value and pixel
// (1.84 M a call into 9,600 addresses) serialised in L2 instead, because a
// superpixel is ~24 px wide and a warp's neighbouring pixels hit the same
// one to three addresses: ~47x the bound.  So a tile's sums are gathered
// on chip before they reach device memory:
//   - a block takes a tile of 128 columns x 8 subsampled rows of one frame,
//     one warp a row, four consecutive pixels a lane (16-byte loads when
//     W % 4 == 0 and the pointers are aligned, scalar loads otherwise), and
//     a lane sums its runs of equal ids in registers;
//   - each run adds to a 256-slot open-addressed table in shared memory
//     (an id key and six sums a slot, atomicCAS on the key, shared
//     atomicAdd on the sums), and after __syncthreads each used slot adds
//     its six sums to device memory: ~10-20 clusters a tile where there
//     were 1024 pixels.
// An id that finds no slot within 16 probes (random ids) adds straight to
// device memory, so every input is exact and none needs spatial locality.
// Sums are unsigned, so every regrouping wraps mod 2^32 as the plain
// version's int64 sums cast to int32 do.  Summing a warp's equal ids first
// (__match_any_sync, __reduce_add_sync) cost more than the shared atomics
// it saves: it made the kernel 3-5x slower on the H100 (PERF.md §6,
// kernel designs that lost).  The update runs within 1.5x of a kernel
// that only loads the same tiles (3.6 against 3.0 us a launch at 720p
// stride 3): what bounds it now is one wave of loads and the launch, not
// the sums.
//
// segment_sum adds vals [V, N] into out [V, bins] by ids [N] (ids outside
// [0, bins) drop); the CCA calls it with V = 2 (a plane of ones, the
// component areas, and one that is zero but at leaders, the orphan
// targets) over the 921,600 component ids of a 720p frame.
// framed_segment_sum is the same sum for B stacked frames: ids [B, Nf]
// frame-local, vals [V, B, Nf], out [B, V, bins], called by the stacked
// batch's CCA over B frames' component ids.  Both are one kernel,
// segment_sum_kernel, with the frame as blockIdx.y (segment_sum is B = 1).
// Its bound is its bytes: ids and values read once (11 MB a 720p frame,
// 3.3 us at 3.35 TB/s; the caller's zero fill of out is a launch of its
// own).  One global atomic a pixel and plane serialised in L2 instead,
// since component ids come in runs along rows and a warp's 32 pixels hit
// one to three addresses (37 us a 720p frame for segment_sum, 128 us for
// four stacked frames in framed_segment_sum).  So it takes the update's
// design: a block takes a tile of 1024 consecutive pixels of one frame,
// four a lane (16-byte loads when Nf % 4 == 0 and the pointers are
// aligned, which aligns every frame's and plane's offset too; scalar
// loads otherwise; a frame's last tile is short, so no tile crosses a
// frame); a lane sums its runs of equal ids in registers; each run adds
// to the block's 256-slot table (table_add, kSegVals planes a pass, the
// keys kept across passes), and each used slot adds its nonzero sums to
// the frame's rows of out once a block: ~50-80 components a tile where
// there were 1024 pixels.  Sums are unsigned; framed_segment_sum's out is
// int32, and both wrap mod 2^32 to the same bits.  On the H100 that took
// segment_sum from 37 to 8.0-8.6 us of device time at 720p, 2.5x its
// bytes: 900 blocks run in one wave, and each clears its table, loads its
// tile, adds its runs and flushes behind two barriers, so what bounds it
// now is that chain's latency, not the atomics (a lane's runs added
// straight to device memory: 12.2 against 10.9 us a call with the zero
// fill, PERF.md §6, kernel designs that lost).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnassigned = 0xFFFF;

constexpr int kUpdRows = 8;                  // subsampled rows a block
constexpr int kUpdCols = 128;                // columns a block: 32 lanes x 4
constexpr int kUpdThreads = 32 * kUpdRows;   // one warp a row
constexpr int kSlots = 256;                  // shared table slots a block
constexpr int kProbes = 16;                  // probes before device atomics
constexpr int kNone = -1;                    // empty slot; a dropped pixel

// The slot of id in the block's table, claimed if id has none yet, or -1
// when no slot is found within kProbes.  A slot's key only ever changes
// from kNone to an id, so a key read as set is final, and an id finds the
// same slot (or none) on every call.
__device__ __forceinline__ int table_slot(int* keys, int id) {
    int s = id & (kSlots - 1);
    for (int probe = 0; probe < kProbes; ++probe) {
        int cur = ((volatile int*)keys)[s];
        if (cur == kNone) cur = atomicCAS(keys + s, kNone, id);
        if (cur == kNone || cur == id) return s;
        s = (s + 1) & (kSlots - 1);
    }
    return -1;
}

// Add one run's first nv of NV sums (the update's [count, Σi, Σj, ΣL, Σa,
// Σb], a segment sum's planes) to the block's table, or to device memory
// when no slot is found: o is the run's entry of the first sum's row of
// out, the rows `stride` apart (a frame offset goes into o).
template <int NV>
__device__ __forceinline__ void table_add(int* keys, unsigned (*sums)[kSlots],
                                          unsigned* o, long long stride,
                                          int id, const unsigned (&v)[NV],
                                          int nv = NV) {
    const int s = table_slot(keys, id);
#pragma unroll
    for (int c = 0; c < NV; ++c) {
        if (c >= nv) break;
        if (s >= 0) atomicAdd(&sums[c][s], v[c]);
        else atomicAdd(o + c * stride, v[c]);
    }
}

// kVec: W % 4 == 0, assignment and planes 16-byte and mask 4-byte aligned,
// so a lane's four pixels load as one int4 a plane (and one word of mask)
template <bool kMasked, bool kVec>
__global__ void __launch_bounds__(kUpdThreads)
slic_update_kernel(const int32_t* __restrict__ assignment,
                   const int32_t* __restrict__ planes,
                   const uint8_t* __restrict__ mask,
                   unsigned* __restrict__ out, int H, int W, int K, int B,
                   int stride, int rem) {
    __shared__ int keys[kSlots];
    __shared__ unsigned sums[6][kSlots];
    for (int s = threadIdx.x; s < kSlots; s += kUpdThreads) {
        keys[s] = kNone;
        for (int c = 0; c < 6; ++c) sums[c][s] = 0;
    }
    __syncthreads();

    const int f = blockIdx.z;
    const int i = rem + (blockIdx.y * kUpdRows + (threadIdx.x >> 5)) * stride;
    const int j0 = blockIdx.x * kUpdCols + 4 * (threadIdx.x & 31);
    const long long bins = (long long)B * K;
    if (i < H) {
        const long long n = (long long)H * W;
        const long long cs = B * n;  // channel stride of planes [3, B, H, W]
        const long long p = f * n + (long long)i * W + j0;
        int id[4] = {kNone, kNone, kNone, kNone};
        unsigned l[4] = {0, 0, 0, 0}, a[4] = {0, 0, 0, 0},
                 b[4] = {0, 0, 0, 0};
        if (kVec) {
            if (j0 < W) {  // W % 4 == 0: the four pixels are in the row
                int4 k = __ldg(reinterpret_cast<const int4*>(assignment + p));
                int4 x = __ldg(reinterpret_cast<const int4*>(planes + p));
                int4 y = __ldg(reinterpret_cast<const int4*>(planes + cs + p));
                int4 z = __ldg(
                    reinterpret_cast<const int4*>(planes + 2 * cs + p));
                id[0] = k.x; id[1] = k.y; id[2] = k.z; id[3] = k.w;
                l[0] = x.x; l[1] = x.y; l[2] = x.z; l[3] = x.w;
                a[0] = y.x; a[1] = y.y; a[2] = y.z; a[3] = y.w;
                b[0] = z.x; b[1] = z.y; b[2] = z.z; b[3] = z.w;
                if (kMasked) {
                    unsigned m = __ldg(
                        reinterpret_cast<const unsigned*>(mask + p));
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        if (!((m >> (8 * q)) & 0xffu)) id[q] = kNone;
                }
            }
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (j0 + q < W) {
                    id[q] = assignment[p + q];
                    l[q] = planes[p + q];
                    a[q] = planes[cs + p + q];
                    b[q] = planes[2 * cs + p + q];
                    if (kMasked && !mask[p + q]) id[q] = kNone;
                }
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (id[q] == kUnassigned || id[q] < 0 || id[q] >= K) id[q] = kNone;

        // runs of equal ids in the lane: pixel q's suffix sums up to the
        // end of its run, so a run's first pixel holds the run's sums
        unsigned c[4], sj[4];
        c[3] = 1;
        sj[3] = j0 + 3;
#pragma unroll
        for (int q = 2; q >= 0; --q) {
            bool same = id[q] == id[q + 1];
            c[q] = 1 + (same ? c[q + 1] : 0);
            sj[q] = j0 + q + (same ? sj[q + 1] : 0);
            l[q] += same ? l[q + 1] : 0;
            a[q] += same ? a[q + 1] : 0;
            b[q] += same ? b[q + 1] : 0;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            bool head = id[q] != kNone;
            if (q > 0) head = head && id[q] != id[q - 1];
            if (head) {
                // every pixel of the lane is in row i
                const unsigned v[6] = {c[q], c[q] * (unsigned)i, sj[q], l[q],
                                       a[q], b[q]};
                table_add(keys, sums, out + (long long)f * K + id[q], bins,
                          id[q], v);
            }
        }
    }
    __syncthreads();

    for (int s = threadIdx.x; s < kSlots; s += kUpdThreads) {
        int id = keys[s];
        if (id != kNone) {
            unsigned* o = out + (long long)f * K + id;
            for (int c = 0; c < 6; ++c) atomicAdd(o + c * bins, sums[c][s]);
        }
    }
}

constexpr int kSegThreads = 256;           // threads a segment-sum block
constexpr int kSegTile = 4 * kSegThreads;  // pixels a block: four a lane
constexpr int kSegVals = 2;                // planes a pass (the CCA's V)

// kVec: Nf % 4 == 0, ids and vals 16-byte aligned, so a lane's four
// pixels load as one int4 a plane.  Six blocks an SM (at most 42 registers
// a thread), so a 720p frame's 900 blocks run in about one wave.
// ids [B, Nf], vals [V, B, Nf], out [B, V, bins]; frame f is blockIdx.y
template <bool kVec>
__global__ void __launch_bounds__(kSegThreads, 6)
segment_sum_kernel(const int32_t* __restrict__ ids,
                   const int32_t* __restrict__ vals,
                   unsigned* __restrict__ out, int B, int Nf, int V,
                   int bins) {
    __shared__ int keys[kSlots];
    __shared__ unsigned sums[kSegVals][kSlots];
    for (int s = threadIdx.x; s < kSlots; s += kSegThreads) keys[s] = kNone;

    const long long f = blockIdx.y;
    const long long ps = (long long)B * Nf;  // plane stride of vals
    ids += f * Nf;
    vals += f * Nf;
    out += f * V * bins;
    const long long p = (long long)blockIdx.x * kSegTile + 4 * threadIdx.x;
    int id[4] = {kNone, kNone, kNone, kNone};
    if (kVec) {
        if (p < Nf) {  // Nf % 4 == 0: the four pixels are in the frame
            const int4 k = __ldg(reinterpret_cast<const int4*>(ids + p));
            id[0] = k.x; id[1] = k.y; id[2] = k.z; id[3] = k.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (p + q < Nf) id[q] = ids[p + q];
    }
    bool head[4];  // the first pixel of each run of equal ids in the lane
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (id[q] < 0 || id[q] >= bins) id[q] = kNone;
        head[q] = id[q] != kNone && (q == 0 || id[q] != id[q - 1]);
    }

#pragma unroll 1
    for (int v0 = 0; v0 < V; v0 += kSegVals) {
        const int nv = min(kSegVals, V - v0);
        unsigned x[kSegVals][4] = {};
#pragma unroll
        for (int c = 0; c < kSegVals; ++c) {
            if (c >= nv) break;
            const int32_t* pv = vals + (v0 + c) * ps + p;
            if (kVec) {
                if (p < Nf) {
                    const int4 y = __ldg(reinterpret_cast<const int4*>(pv));
                    x[c][0] = y.x; x[c][1] = y.y; x[c][2] = y.z; x[c][3] = y.w;
                }
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (p + q < Nf) x[c][q] = pv[q];
            }
        }
        for (int s = threadIdx.x; s < kSlots; s += kSegThreads)
            for (int c = 0; c < kSegVals; ++c) sums[c][s] = 0;
        __syncthreads();  // keys set, sums zeroed

        // pixel q's suffix sums up to the end of its run, so a run's first
        // pixel holds the run's sums
#pragma unroll
        for (int q = 2; q >= 0; --q) {
            const bool same = id[q] == id[q + 1];
#pragma unroll
            for (int c = 0; c < kSegVals; ++c)
                x[c][q] += same ? x[c][q + 1] : 0;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (head[q]) {
                unsigned v[kSegVals];
#pragma unroll
                for (int c = 0; c < kSegVals; ++c) v[c] = x[c][q];
                table_add(keys, sums, out + (long long)v0 * bins + id[q],
                          bins, id[q], v, nv);
            }
        }
        __syncthreads();

        for (int s = threadIdx.x; s < kSlots; s += kSegThreads) {
            const int key = keys[s];
            if (key == kNone) continue;
            for (int c = 0; c < nv; ++c)
                if (sums[c][s])
                    atomicAdd(out + (long long)(v0 + c) * bins + key,
                              sums[c][s]);
        }
        if (v0 + kSegVals < V) __syncthreads();  // before the sums reset
    }
}

int launch_segment_sum(const void* ids, const void* vals, void* out, int B,
                       int Nf, int V, int bins, void* stream) {
    if (B > 0 && Nf > 0 && V > 0) {
        const dim3 blocks((Nf + kSegTile - 1) / kSegTile, B);
        const bool vec = Nf % 4 == 0 &&
                         (((uintptr_t)ids | (uintptr_t)vals) & 15) == 0;
        auto kernel = vec ? &segment_sum_kernel<true>
                          : &segment_sum_kernel<false>;
        kernel<<<blocks, kSegThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)ids, (const int32_t*)vals, (unsigned*)out, B, Nf,
            V, bins);
    }
    return (int)cudaGetLastError();
}

template <bool kMasked>
int launch_update(const void* assignment, const void* planes,
                  const void* mask, void* out, int H, int W, int K, int B,
                  int stride, int rem, void* stream) {
    int rows = rem < H ? (H - rem + stride - 1) / stride : 0;
    if (rows > 0 && W > 0 && B > 0) {
        dim3 blocks((W + kUpdCols - 1) / kUpdCols,
                    (rows + kUpdRows - 1) / kUpdRows, B);
        bool vec = W % 4 == 0
                   && (((uintptr_t)assignment | (uintptr_t)planes) & 15) == 0
                   && ((uintptr_t)mask & 3) == 0;
        auto kernel = vec ? &slic_update_kernel<kMasked, true>
                          : &slic_update_kernel<kMasked, false>;
        kernel<<<blocks, kUpdThreads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)assignment, (const int32_t*)planes,
            (const uint8_t*)mask, (unsigned*)out, H, W, K, B, stride, rem);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// assignment int32 [B, H, W], planes int32 [3, B, H, W];
// out int32 [6, B*K], zeroed by the caller
extern "C" int fstt_slic_update(const void* assignment, const void* planes,
                                void* out, int H, int W, int K, int B,
                                int stride, int rem, void* stream) {
    return launch_update<false>(assignment, planes, nullptr, out, H, W, K, B,
                                stride, rem, stream);
}

// as fstt_slic_update, plus mask bool (one byte, 0/1) [B, H, W]
extern "C" int fstt_slic_update_masked(const void* assignment,
                                       const void* planes, const void* mask,
                                       void* out, int H, int W, int K, int B,
                                       int stride, int rem, void* stream) {
    return launch_update<true>(assignment, planes, mask, out, H, W, K, B,
                               stride, rem, stream);
}

// out: int32 [V, bins], zeroed by the caller; ids outside [0, bins) drop
extern "C" int fstt_segment_sum(const void* ids, const void* vals, void* out,
                                int N, int V, int bins, void* stream) {
    return launch_segment_sum(ids, vals, out, 1, N, V, bins, stream);
}

// ids [B, Nf] frame-local, vals [V, B, Nf]; out: int32 [B, V, bins],
// zeroed by the caller; ids outside [0, bins) drop
extern "C" int fstt_framed_segment_sum(const void* ids, const void* vals,
                                       void* out, int B, int Nf, int V,
                                       int bins, void* stream) {
    return launch_segment_sum(ids, vals, out, B, Nf, V, bins, stream);
}
