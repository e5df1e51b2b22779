// LSC colour features: six 256-entry f32 table lookups per pixel, one
// thread per pixel.
//
// Replaces fast_slic_tpu/pallas/lut_tpu.py:_lsc_feat_kernel (pallas_call in
// lsc_color_feats_pallas).  The TPU has no vector gather, so that kernel
// looked each table up as a two-level one-hot: a HIGHEST-precision f32
// matmul over the low 5 bits and a select over the high 3.  Here the four
// tables (L_cos, L_sin, color_cos, color_sin: 4 KB) are staged in shared
// memory and gathered directly; __constant__ memory would serialise the
// divergent indices of a warp.  Out = [L_cos[L], L_sin[L], color_cos[a],
// color_sin[a], color_cos[b], color_sin[b]], planar f32 [6, H, W], equal to a
// plain gather bit for bit (a lookup does no arithmetic).  Indices are
// clamped to [0, 255], as an XLA gather clamps.
//
// Bound on the card: memory traffic, 12 bytes read and 24 written per
// pixel (33 MB at 720p); the shared-memory gathers are far from the limit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTable = 256;

__device__ __forceinline__ int clamp_index(int v) {
    return min(max(v, 0), kTable - 1);
}

__global__ void lsc_feat_kernel(const int32_t* __restrict__ planes,
                                const float* __restrict__ tables,
                                float* __restrict__ out, int n) {
    __shared__ float t[4 * kTable];
    for (int e = threadIdx.x; e < 4 * kTable; e += blockDim.x) t[e] = tables[e];
    __syncthreads();
    const float* lcos = t;
    const float* lsin = t + kTable;
    const float* ccos = t + 2 * kTable;
    const float* csin = t + 3 * kTable;
    for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
         p += gridDim.x * blockDim.x) {
        int L = clamp_index(planes[p]);
        int a = clamp_index(planes[n + p]);
        int b = clamp_index(planes[2 * n + p]);
        out[p] = lcos[L];
        out[n + p] = lsin[L];
        out[2 * n + p] = ccos[a];
        out[3 * n + p] = csin[a];
        out[4 * n + p] = ccos[b];
        out[5 * n + p] = csin[b];
    }
}

}  // namespace

// planes int32 [3, n]; tables f32 [4, 256] (L_cos, L_sin, color_cos,
// color_sin); out f32 [6, n]
extern "C" int fstt_lsc_feat(const void* planes, const void* tables,
                             void* out, int n, void* stream) {
    if (n > 0) {
        int threads = 256;
        int blocks = min((n + threads - 1) / threads, 4096);
        lsc_feat_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)planes, (const float*)tables, (float*)out, n);
    }
    return (int)cudaGetLastError();
}
