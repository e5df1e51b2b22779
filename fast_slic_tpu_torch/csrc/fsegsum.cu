// f32 segment sums with an optional in-kernel weight multiply: LSC's
// weighted feature accumulation (after_update).
//
// Replaces fast_slic_tpu/pallas/segsum_tpu.py:_fsegsum_kernel (pallas_call
// in float_segsum_pallas).  The TPU serialised scatter-adds, so that kernel
// split every value into three bf16 mantissa chunks and accumulated them
// with one-hot matmuls inside a hi-bucket band.
//
// Here every bin is summed in pixel order, one thread per (bin, row): the
// wrapper sorts the pixel indices by bin with a stable sort, so each bin's
// pixels keep their order, and finds each bin's run; the thread adds the
// run's values one after another, from 0.0f.  That is the order of the
// plain version (index_add_ on the CPU adds index by index), so the card's
// sums equal the CPU's bit for bit and do not change from run to run.
// Float atomics would add in another order on every run, and LSC feeds its
// centroids back into ten assign passes a frame: such differences grew to
// 0.1 % of the labels of a 720p frame (PERF.md).
//
// A pixel adds vals * m, m = (mask != 0) as 0/1, and with wrow >= 0 the rows
// v < wrow are multiplied by row wrow (the per-pixel weight) times m first:
// the plain version's arithmetic, operation for operation (-fmad=false).
//
// Bound on the card: each thread's loads follow one another along its run
// (latency); the 11 threads of a bin read the same index, and a run's
// pixels are mostly neighbours, so the loads stay in L1/L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void fsegsum_kernel(const int64_t* __restrict__ order,
                               const int32_t* __restrict__ starts,
                               const int32_t* __restrict__ mask,
                               const float* __restrict__ vals,
                               float* __restrict__ out, int N, int V,
                               int bins, int wrow) {
    int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= bins * V) return;
    int b = t / V;
    int v = t - b * V;
    const float* row = vals + (long long)v * N;
    const float* wts = vals + (long long)(wrow >= 0 ? wrow : 0) * N;
    bool weighted = v < wrow;
    float acc = 0.0f;
    for (int p = starts[b]; p < starts[b + 1]; ++p) {
        long long i = order[p];
        float m = mask[i] != 0 ? 1.0f : 0.0f;
        float x = row[i] * m;
        if (weighted) x = x * (wts[i] * m);
        acc = acc + x;
    }
    out[(long long)v * bins + b] = acc;
}

}  // namespace

// order int64 [N]: pixel indices sorted stably by bin; starts int32
// [bins + 1]: bin b's run is order[starts[b] .. starts[b+1]); mask int32
// [N], vals f32 [V, N]; out f32 [V, bins], every entry written.  wrow < 0:
// no weight multiply.
extern "C" int fstt_fsegsum(const void* order, const void* starts,
                            const void* mask, const void* vals, void* out,
                            int N, int V, int bins, int wrow, void* stream) {
    if (V > 0 && bins > 0) {
        int threads = 256;
        int blocks = (bins * V + threads - 1) / threads;
        fsegsum_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int64_t*)order, (const int32_t*)starts,
            (const int32_t*)mask, (const float*)vals, (float*)out, N, V,
            bins, wrow);
    }
    return (int)cudaGetLastError();
}
