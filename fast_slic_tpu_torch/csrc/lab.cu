// Fixed-point sRGB -> CIELAB, one thread per pixel.
//
// Replaces fast_slic_tpu/pallas/lut_tpu.py:_lab_kernel (pallas_call in
// _lab_rows).  The TPU kernel had no gather, so it looked its tables up with
// one-hot matmuls and a Newton cube root; here the three integer tables of
// ops/cielab.py (_SRGB_TBL_NP [256], _CB_NP [3x3], _LAB_TBL_NP [8193]) are
// read with plain loads.  The tables are 33 KB in all and stay in L1/L2.
//
// Bound on the card: device memory.  Each pixel reads 3 bytes and writes
// 12 (int32 planar [3, H, W]); the arithmetic is a few integer ops.  The
// design keeps the pixel loop a single pass with coalesced planar stores.
//
// Output is bit-identical to ops/cielab.rgb_to_lab_quantized_np, including
// the unsigned 32-bit wrap before the shift (reference cielab.h:322-324).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSrgbShift = 13;
constexpr int kLabShift = 16;
constexpr int kOutputShift = 1;

__global__ void lab_kernel(const uint8_t* __restrict__ rgb,
                           const int32_t* __restrict__ srgb_tbl,
                           const int32_t* __restrict__ cb,
                           const int32_t* __restrict__ lab_tbl,
                           int32_t* __restrict__ out, int n) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    int sr = srgb_tbl[rgb[3 * p + 0]];
    int sg = srgb_tbl[rgb[3 * p + 1]];
    int sb = srgb_tbl[rgb[3 * p + 2]];
    // products < 2^29 and the row sums stay below 2^31 (rows sum to ~1.0 in Q16)
    int xr = (cb[0] * sr + cb[1] * sg + cb[2] * sb) >> kLabShift;
    int yr = (cb[3] * sr + cb[4] * sg + cb[5] * sb) >> kLabShift;
    int zr = (cb[6] * sr + cb[7] * sg + cb[8] * sb) >> kLabShift;
    int fx = lab_tbl[xr];
    int fy = lab_tbl[yr];
    int fz = lab_tbl[zr];
    int ciel = 116 * fy - (16 << kSrgbShift);
    int ciea = 500 * (fx - fy) + (128 << kSrgbShift);
    int cieb = 200 * (fy - fz) + (128 << kSrgbShift);
    constexpr int sh = kSrgbShift - kOutputShift;
    // unsigned shift: a slightly negative value wraps before the shift
    long long l = (long long)((uint32_t)ciel >> sh);
    long long a = (long long)((uint32_t)ciea >> sh) - (64 << kOutputShift);
    long long b = (long long)((uint32_t)cieb >> sh) - (64 << kOutputShift);
    out[p] = (int32_t)(l < 0 ? 0 : (l > 255 ? 255 : l));
    out[n + p] = (int32_t)(a < 0 ? 0 : (a > 255 ? 255 : a));
    out[2 * n + p] = (int32_t)(b < 0 ? 0 : (b > 255 ? 255 : b));
}

}  // namespace

extern "C" int fstt_lab(const void* rgb, const void* srgb_tbl, const void* cb,
                        const void* lab_tbl, void* out, int n,
                        void* stream) {
    if (n > 0) {
        int threads = 256;
        int blocks = (n + threads - 1) / threads;
        lab_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)rgb, (const int32_t*)srgb_tbl,
            (const int32_t*)cb, (const int32_t*)lab_tbl, (int32_t*)out, n);
    }
    return (int)cudaGetLastError();
}
