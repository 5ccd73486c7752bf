// Stitched chunk gather / scatter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/stitch_copy.py
// ::stitch_gather (_copy_kernel) and ::stitch_scatter (_scatter_kernel):
//   gather:  out[i]                = arena[chunk_map[i]]
//   scatter: arena[chunk_map[i]]   = values[i]          (in place)
// where every row is one arena chunk (2 MiB on the serving path).
//
// Bound on H100: pure data movement, 2 * n_logical * chunk_bytes over
// 3.35 TB/s of HBM. Design: grid (n_logical, blocks_per_chunk); each block
// reads its physical chunk id from the int32 map in device memory, then
// copies its slice of the chunk as 16-byte vectors with kUnroll loads in
// flight per thread before the matching stores. The copy is of bytes, not
// elements, so one kernel serves f32, bf16 and int32. Ids outside
// [0, n_phys) are skipped rather than dereferenced; the host validates
// maps before upload (chunk_map_from_extents), so this only keeps a bad
// map from touching memory outside the arena.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr long long kVecsPerBlock = 2LL * kThreads * kUnroll;  // 64 KiB per block

template <bool kScatter>
__global__ void __launch_bounds__(kThreads)
stitch_copy_kernel(const int4* __restrict__ src, int4* __restrict__ dst,
                   const int32_t* __restrict__ chunk_map, long long chunk_vecs,
                   int n_phys) {
    const long long logical = blockIdx.x;
    const int phys = chunk_map[logical];
    if (phys < 0 || phys >= n_phys) return;
    const long long src_row = kScatter ? logical : phys;
    const long long dst_row = kScatter ? phys : logical;
    const int4* s = src + src_row * chunk_vecs;
    int4* d = dst + dst_row * chunk_vecs;
    const long long begin = blockIdx.y * kVecsPerBlock;
    const long long end = min(begin + kVecsPerBlock, chunk_vecs);
    for (long long base = begin + threadIdx.x; base < end; base += kThreads * kUnroll) {
        int4 r[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long v = base + (long long)u * kThreads;
            if (v < end) r[u] = s[v];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long v = base + (long long)u * kThreads;
            if (v < end) d[v] = r[u];
        }
    }
}

template <bool kScatter>
int launch(const void* src, void* dst, const void* chunk_map, long long n_logical,
           long long chunk_bytes, int n_phys, void* stream) {
    if (n_logical == 0) return cudaSuccess;
    const long long chunk_vecs = chunk_bytes / 16;
    const long long blocks_per_chunk = (chunk_vecs + kVecsPerBlock - 1) / kVecsPerBlock;
    dim3 grid((unsigned)n_logical, (unsigned)blocks_per_chunk);
    stitch_copy_kernel<kScatter><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)src, (int4*)dst, (const int32_t*)chunk_map, chunk_vecs, n_phys);
    return (int)cudaGetLastError();
}

}  // namespace

// out (n_logical, chunk_bytes) <- arena (n_phys, chunk_bytes) rows chunk_map[i].
extern "C" int stitch_gather(const void* arena, const void* chunk_map, void* out,
                             long long n_logical, long long chunk_bytes, int n_phys,
                             void* stream) {
    return launch<false>(arena, out, chunk_map, n_logical, chunk_bytes, n_phys, stream);
}

// arena rows chunk_map[i] <- values (n_logical, chunk_bytes), in place.
extern "C" int stitch_scatter(void* arena, const void* chunk_map, const void* values,
                              long long n_logical, long long chunk_bytes, int n_phys,
                              void* stream) {
    return launch<true>(values, arena, chunk_map, n_logical, chunk_bytes, n_phys, stream);
}
