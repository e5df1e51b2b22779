// Variants of the SLIC update kernel (csrc/segsum.cu slic_update_kernel),
// for scripts/update_variants.py: each takes the same tiles (128 columns x 8
// subsampled rows a block, four pixels a lane, 16-byte loads; W % 4 == 0
// and aligned pointers only) and sums the lane's runs of equal ids, then
//   V = 0: sums a warp's equal ids (__match_any_sync, __reduce_add_sync)
//          and adds each group to the block's shared table, flushed once;
//   V = 1: sums a warp's equal ids as in 0 and adds each group to device
//          memory directly;
//   V = 2: loads the tiles only, one device atomic a warp: a floor, not an
//          update.
// The library's kernel adds each lane's runs to the shared table.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kUnassigned = 0xFFFF;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 8, kCols = 128, kThreads = 32 * kRows;
constexpr int kSlots = 256, kProbes = 16, kNone = -1;

__device__ __forceinline__ void table_add(int* keys, unsigned (*sums)[kSlots],
                                          unsigned* o, long long bins, int id,
                                          const unsigned (&v)[6]) {
    int s = id & (kSlots - 1);
    for (int probe = 0; probe < kProbes; ++probe) {
        int cur = ((volatile int*)keys)[s];
        if (cur == kNone) cur = atomicCAS(keys + s, kNone, id);
        if (cur == kNone || cur == id) {
            for (int c = 0; c < 6; ++c) atomicAdd(&sums[c][s], v[c]);
            return;
        }
        s = (s + 1) & (kSlots - 1);
    }
    for (int c = 0; c < 6; ++c) atomicAdd(o + c * bins, v[c]);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
update_variant(const int32_t* __restrict__ assignment,
               const int32_t* __restrict__ planes, unsigned* __restrict__ out,
               int H, int W, int K, int B, int stride, int rem) {
    __shared__ int keys[kSlots];
    __shared__ unsigned sums[6][kSlots];
    for (int s = threadIdx.x; s < kSlots; s += kThreads) {
        keys[s] = kNone;
        for (int c = 0; c < 6; ++c) sums[c][s] = 0;
    }
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int f = blockIdx.z;
    const int i = rem + (blockIdx.y * kRows + (threadIdx.x >> 5)) * stride;
    const int j0 = blockIdx.x * kCols + 4 * lane;
    const long long bins = (long long)B * K;
    if (i < H) {  // the same for the whole warp: a warp is one row
        const long long n = (long long)H * W, cs = B * n;
        const long long p = f * n + (long long)i * W + j0;
        int id[4] = {kNone, kNone, kNone, kNone};
        unsigned l[4] = {0, 0, 0, 0}, a[4] = {0, 0, 0, 0},
                 b[4] = {0, 0, 0, 0};
        if (j0 < W) {
            int4 k = __ldg(reinterpret_cast<const int4*>(assignment + p));
            int4 x = __ldg(reinterpret_cast<const int4*>(planes + p));
            int4 y = __ldg(reinterpret_cast<const int4*>(planes + cs + p));
            int4 z = __ldg(reinterpret_cast<const int4*>(planes + 2 * cs + p));
            id[0] = k.x; id[1] = k.y; id[2] = k.z; id[3] = k.w;
            l[0] = x.x; l[1] = x.y; l[2] = x.z; l[3] = x.w;
            a[0] = y.x; a[1] = y.y; a[2] = y.z; a[3] = y.w;
            b[0] = z.x; b[1] = z.y; b[2] = z.z; b[3] = z.w;
        }
        if (V == 2) {
            unsigned s = id[0] + id[1] + id[2] + id[3];
            for (int q = 0; q < 4; ++q) s += l[q] + a[q] + b[q];
            s = __reduce_add_sync(kFull, s);
            if (lane == 0) atomicAdd(out + (long long)f * K, s);
            return;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
            if (id[q] == kUnassigned || id[q] < 0 || id[q] >= K) id[q] = kNone;
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
        // round q: the runs that start at pixel q; lanes offering the same
        // id sum their runs, the group's lowest lane adds the result
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            bool head = id[q] != kNone;
            if (q > 0) head = head && id[q] != id[q - 1];
            if (!__any_sync(kFull, head)) continue;
            int key = head ? id[q] : kNone;
            unsigned peers = __match_any_sync(kFull, key);
            unsigned v[6];
            v[0] = __reduce_add_sync(peers, c[q]);
            v[1] = v[0] * (unsigned)i;
            v[2] = __reduce_add_sync(peers, sj[q]);
            v[3] = __reduce_add_sync(peers, l[q]);
            v[4] = __reduce_add_sync(peers, a[q]);
            v[5] = __reduce_add_sync(peers, b[q]);
            if (head && lane == __ffs(peers) - 1) {
                unsigned* o = out + (long long)f * K + key;
                if (V == 0) {
                    table_add(keys, sums, o, bins, key, v);
                } else {
                    for (int c = 0; c < 6; ++c) atomicAdd(o + c * bins, v[c]);
                }
            }
        }
    }
    if (V != 0) return;
    __syncthreads();
    for (int s = threadIdx.x; s < kSlots; s += kThreads) {
        int id = keys[s];
        if (id != kNone) {
            unsigned* o = out + (long long)f * K + id;
            for (int c = 0; c < 6; ++c) atomicAdd(o + c * bins, sums[c][s]);
        }
    }
}

template <int V>
int launch(const void* assignment, const void* planes, void* out, int H,
           int W, int K, int B, int stride, int rem, void* stream) {
    int rows = (H - rem + stride - 1) / stride;
    dim3 blocks((W + kCols - 1) / kCols, (rows + kRows - 1) / kRows, B);
    update_variant<V><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)assignment, (const int32_t*)planes, (unsigned*)out, H,
        W, K, B, stride, rem);
    return (int)cudaGetLastError();
}

}  // namespace

// as fstt_slic_update (csrc/segsum.cu), for W % 4 == 0 and 16-byte aligned
// pointers; variant as above
extern "C" int update_variant(int variant, const void* assignment,
                              const void* planes, void* out, int H, int W,
                              int K, int B, int stride, int rem,
                              void* stream) {
    switch (variant) {
        case 0: return launch<0>(assignment, planes, out, H, W, K, B, stride,
                                 rem, stream);
        case 1: return launch<1>(assignment, planes, out, H, W, K, B, stride,
                                 rem, stream);
        case 2: return launch<2>(assignment, planes, out, H, W, K, B, stride,
                                 rem, stream);
    }
    return -1;
}
