// Connected components of a label map, and a table lookup, for the
// connectivity enforcement (CCA) of ops/cca.py.
//
// fstt_cc replaces fast_slic_tpu/pallas/cca_tpu.py:_cc_pass_kernel
// (pallas_call in _cc_passes, reached through propagate_min_pallas and
// connected_components_pallas).  The TPU kernel spread a minimum over each
// 4-connected equal-label region with strip-resident segmented doubling,
// alternating half-shifted strip grids until a fixpoint.  Here the same
// result -- every pixel labelled with the MINIMUM LINEAR PIXEL INDEX of its
// region, UNASSIGNED (0xFFFF) being a label like any other -- comes from a
// union-find with min-root linking (Playne & Hawick's label equivalence;
// see arXiv 1712.09789 in PAPERS.md) in three passes:
//   init     parent[p] = p
//   merge    unite p with its left and upper neighbour where the labels are
//            equal; atomicMin links the larger root under the smaller
//   flatten  parent[p] = root(p)
// A region's minimum pixel only ever points at itself (its parent can only
// decrease and stays inside the region), so the root is that minimum and
// the labelling is unique whatever order the atomics land in.
//
// fstt_lookup replaces fast_slic_tpu/pallas/segsum_tpu.py:_lookup_kernel
// (pallas_call in banded_lookup_pallas), which emulated a gather with banded
// one-hot matmuls: out[i] = table[ids[i]] is a plain gather here.
//
// Bound on the card: the merge pass is bound by dependent loads on the
// parent chains (latency) and atomics where trees join; at 720p the map is
// 3.7 MB and stays in L2.  The lookup is bound by device memory (8 bytes
// read and 4 written a pixel).  The design keeps each pass one thread per
// element and reads parents through volatile loads during the merge, so a
// thread never follows a stale L1 copy of a chain another SM has relinked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ int find_root(const volatile int32_t* parent, int x) {
    int y = parent[x];
    while (y != x) {
        x = y;
        y = parent[x];
    }
    return x;
}

__device__ void unite(int32_t* parent, int a, int b) {
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

__global__ void cc_init(int32_t* parent, int n) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p < n) parent[p] = p;
}

__global__ void cc_merge(const int32_t* __restrict__ labels, int32_t* parent,
                         int H, int W) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= H * W) return;
    int i = p / W;
    int j = p - i * W;
    int lab = labels[p];
    if (j > 0 && labels[p - 1] == lab) unite(parent, p - 1, p);
    if (i > 0 && labels[p - W] == lab) unite(parent, p - W, p);
}

__global__ void cc_flatten(int32_t* parent, int n) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p < n) parent[p] = find_root(parent, p);
}

__global__ void lookup_kernel(const int32_t* __restrict__ ids,
                              const int32_t* __restrict__ table,
                              int32_t* __restrict__ out, int n,
                              int table_size) {
    int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= n) return;
    int k = ids[p];
    // out-of-range ids read nothing; the wrappers never pass them
    out[p] = (k >= 0 && k < table_size) ? table[k] : -1;
}

}  // namespace

// out: int32 [H, W] component ids (min linear index of the region)
extern "C" int fstt_cc(const void* labels, void* out, int H, int W,
                       void* stream) {
    int n = H * W;
    if (n > 0) {
        int threads = 256;
        int blocks = (n + threads - 1) / threads;
        cudaStream_t s = (cudaStream_t)stream;
        cc_init<<<blocks, threads, 0, s>>>((int32_t*)out, n);
        cc_merge<<<blocks, threads, 0, s>>>((const int32_t*)labels,
                                            (int32_t*)out, H, W);
        cc_flatten<<<blocks, threads, 0, s>>>((int32_t*)out, n);
    }
    return (int)cudaGetLastError();
}

extern "C" int fstt_lookup(const void* ids, const void* table, void* out,
                           int n, int table_size, void* stream) {
    if (n > 0) {
        int threads = 256;
        int blocks = (n + threads - 1) / threads;
        lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)ids, (const int32_t*)table, (int32_t*)out, n,
            table_size);
    }
    return (int)cudaGetLastError();
}
