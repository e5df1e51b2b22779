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
// fstt_resolve_orphans replaces the orphan chase that called that kernel in
// a loop (fast_slic_tpu/ops/cca.py:_resolve_orphans; on the CPU pointer
// doubling, one pair of gathers and one host check a round).  Each entry
// walks its own chain over the READ-ONLY tables -- j = target[j] while
// substitute[j] is UNASSIGNED -- and writes the substitute it ends on, or 0
// where the chain never reaches an assigned entry: the fixpoint the doubling
// reaches, in one launch, whatever order the threads run in.  The walk stops
// after n hops or at a target outside the table, so a malformed table
// cannot hang the card.
//
// Bound on the card: the merge pass is bound by dependent loads on the
// parent chains (latency) and atomics where trees join; at 720p the map is
// 3.7 MB and stays in L2.  The lookup is bound by device memory (8 bytes
// read and 4 written a pixel): each thread moves four ids and four results
// as 16-byte vectors (a scalar path for unaligned views and the tail), the
// table is read through the read-only cache, and a grid of a few blocks per
// SM strides over the ids.  The table has n entries (3.7 MB at 720p), which
// L2 holds, so staging it in shared memory would not help.  The orphan walk
// is bound by its dependent loads (real chains are 1-3 hops); its tables
// stay in L2.  Merge: each pass is one thread per element, and parents are
// read through volatile loads, so a thread never follows a stale L1 copy of
// a chain another SM has relinked.

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

__global__ void resolve_orphans_kernel(const int32_t* __restrict__ substitute,
                                       const int32_t* __restrict__ target,
                                       int32_t* __restrict__ out, int n) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    int j = i;
    int32_t s = substitute[j];
    for (int hops = 0; s == UNASSIGNED && hops < n; ++hops) {
        j = target[j];
        if ((unsigned)j >= (unsigned)n) break;
        s = substitute[j];
    }
    out[i] = s == UNASSIGNED ? 0 : s;
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
        const int threads = 256;
        bool vec = (((uintptr_t)ids | (uintptr_t)out) & 15) == 0;
        int work = vec ? (n + 3) / 4 : n;
        int blocks = (work + threads - 1) / threads;
        int cap = 8 * sm_count();
        if (blocks > cap) blocks = cap;
        cudaStream_t s = (cudaStream_t)stream;
        if (vec)
            lookup_kernel<true><<<blocks, threads, 0, s>>>(
                (const int32_t*)ids, (const int32_t*)table, (int32_t*)out, n,
                table_size);
        else
            lookup_kernel<false><<<blocks, threads, 0, s>>>(
                (const int32_t*)ids, (const int32_t*)table, (int32_t*)out, n,
                table_size);
    }
    return (int)cudaGetLastError();
}

// substitute, target: int32 [n]; out: int32 [n], every entry written
extern "C" int fstt_resolve_orphans(const void* substitute, const void* target,
                                    void* out, int n, void* stream) {
    if (n > 0) {
        int threads = 256;
        int blocks = (n + threads - 1) / threads;
        resolve_orphans_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const int32_t*)substitute, (const int32_t*)target, (int32_t*)out,
            n);
    }
    return (int)cudaGetLastError();
}
