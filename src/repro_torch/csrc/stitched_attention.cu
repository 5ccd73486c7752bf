// Stitched decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stitched_attention.py
// ::stitched_decode_attention (_decode_attn_kernel): one-token GQA decode
// attention per sequence, reading K and V straight out of the chunk arena
// through per-sequence page tables (separate K and V tables allowed).
//
// Bound on H100: memory. Each valid token's K and V rows are read once
// (2 * KVH * D * itemsize bytes per token) and the arithmetic is ~4*G
// FLOPs per element read, far below the ~295 FLOPs/byte where bf16 tensor
// cores would become the limit. So the design reads every K/V byte once,
// keeps (m, l, acc) in registers and never materialises the gathered KV.
//
// Design. The Pallas grid walks a sequence's chunks in order and carries
// (m, l, acc) in VMEM scratch from one step to the next; CUDA blocks run in
// no order, so the sequence is split instead:
//   pass 1, grid (B, KVH * g_tiles, splits): a block owns one kv head, up
//     to kGT of its G query heads, and one contiguous share of the
//     sequence's valid positions [0, seq_len). Its 4 warps take the share's
//     tokens in turn; a warp reads one token's K row with its 32 lanes
//     (lane owns head dims lane, lane+32, ...), reduces q.k with shuffles,
//     and updates its own online-softmax state. A 2 MiB chunk holds far
//     more tokens than shared memory, so the block walks positions, not
//     chunks: each position maps to (page_table[b, p / T_c], p % T_c),
//     which handles T_c that is not a power of two and never reads past
//     seq_len. The warps then merge through shared memory and the block
//     writes its unnormalised (m, l, acc) partial.
//   pass 2, grid (B * H): merges the splits' partials with the usual
//     rescaling and divides by l, with the l = 0 guard (seq_len 0 -> 0).
// Padding entries of a page table are chunk 0, a real chunk: they are
// never read because only positions < seq_len are visited. Chunk ids
// outside [0, n_phys) are skipped. q is scaled in q's dtype before the
// f32 cast, as the TPU kernel does. G and D are small and not MMA-shaped
// (G = 3, D = 32 or 64 on the serving path), so plain FMA loops are used;
// wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kGT = 4;               // query heads per block (G tile)
constexpr int kMinSplitTokens = 128;  // least share of positions per split
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// Partials: acc (B, H, splits, D) f32 unnormalised; ml (B, H, splits, 2) f32.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
decode_attn_partial(const T* __restrict__ q, const T* __restrict__ k_arena,
                    const T* __restrict__ v_arena, const int32_t* __restrict__ pt_k,
                    const int32_t* __restrict__ pt_v, const int32_t* __restrict__ seq_lens,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int H,
                    int KVH, int D, int T_c, int C, long long chunk_stride, int n_phys,
                    int splits, float scale) {
    __shared__ float s_m[kWarps][kGT];
    __shared__ float s_l[kWarps][kGT];
    __shared__ float s_acc[kWarps][kGT][NJ * 32];

    const int G = H / KVH;
    const int g_tiles = (G + kGT - 1) / kGT;
    const int b = blockIdx.x;
    const int kvh = blockIdx.y / g_tiles;
    const int g0 = (blockIdx.y % g_tiles) * kGT;
    const int split = blockIdx.z;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    // this split's share of the valid positions
    long long seq = seq_lens[b];
    const long long cap = (long long)C * T_c;
    seq = seq < 0 ? 0 : (seq > cap ? cap : seq);
    long long per = (seq + splits - 1) / splits;
    if (per < kMinSplitTokens) per = kMinSplitTokens;
    const long long p0 = (long long)split * per;
    const long long p1 = p0 + per < seq ? p0 + per : seq;

    // q for this block's heads, scaled in q's dtype, then f32
    float qr[kGT][NJ];
#pragma unroll
    for (int g = 0; g < kGT; ++g) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = lane + 32 * j;
            float x = 0.f;
            if (g0 + g < G && d < D) {
                const T raw = q[((long long)b * H + kvh * G + g0 + g) * D + d];
                x = to_f32(from_f32<T>(to_f32(raw) * scale));
            }
            qr[g][j] = x;
        }
    }

    float m[kGT], l[kGT], acc[kGT][NJ];
#pragma unroll
    for (int g = 0; g < kGT; ++g) {
        m[g] = kNegInf;
        l[g] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[g][j] = 0.f;
    }

    for (long long p = p0 + warp; p < p1; p += kWarps) {
        const int c = (int)(p / T_c);
        const long long t = p - (long long)c * T_c;
        const int ck = pt_k[(long long)b * C + c];
        const int cv = pt_v[(long long)b * C + c];
        if (ck < 0 || ck >= n_phys || cv < 0 || cv >= n_phys) continue;
        const long long row = (t * KVH + kvh) * D;
        const T* kp = k_arena + ck * chunk_stride + row;
        const T* vp = v_arena + cv * chunk_stride + row;
        float kr[NJ], vr[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = lane + 32 * j;
            kr[j] = d < D ? to_f32(kp[d]) : 0.f;
            vr[j] = d < D ? to_f32(vp[d]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < kGT; ++g) {
            if (g0 + g >= G) break;
            float s = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j) s = fmaf(qr[g][j], kr[j], s);
            s = warp_sum(s);
            const float m_new = fmaxf(m[g], s);
            const float alpha = expf(m[g] - m_new);
            const float pe = expf(s - m_new);
            l[g] = l[g] * alpha + pe;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[g][j] = fmaf(pe, vr[j], acc[g][j] * alpha);
            m[g] = m_new;
        }
    }

    // merge the warps of this block
#pragma unroll
    for (int g = 0; g < kGT; ++g) {
        if (lane == 0) {
            s_m[warp][g] = m[g];
            s_l[warp][g] = l[g];
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) s_acc[warp][g][lane + 32 * j] = acc[g][j];
    }
    __syncthreads();
    const int n_g = G - g0 < kGT ? G - g0 : kGT;
    for (int idx = threadIdx.x; idx < n_g * D; idx += kThreads) {
        const int g = idx / D;
        const int d = idx % D;
        float mx = kNegInf;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
        float lsum = 0.f, a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const float f = expf(s_m[w][g] - mx);
            lsum += s_l[w][g] * f;
            a += s_acc[w][g][d] * f;
        }
        const long long bh = (long long)b * H + kvh * G + g0 + g;
        part_acc[(bh * splits + split) * D + d] = a;
        if (d == 0) {
            part_ml[(bh * splits + split) * 2 + 0] = mx;
            part_ml[(bh * splits + split) * 2 + 1] = lsum;
        }
    }
}

// out (B, H, D) in T <- merge of the splits' partials.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_merge(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                  T* __restrict__ out, int D, int splits) {
    const long long bh = blockIdx.x;
    const float* ml = part_ml + bh * splits * 2;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
    float lsum = 0.f;
    for (int s = 0; s < splits; ++s) lsum += ml[2 * s + 1] * expf(ml[2 * s] - mx);
    const float inv = 1.f / (lsum > 0.f ? lsum : 1.f);
    for (int d = threadIdx.x; d < D; d += kThreads) {
        float a = 0.f;
        for (int s = 0; s < splits; ++s)
            a += part_acc[(bh * splits + s) * D + d] * expf(ml[2 * s] - mx);
        out[bh * D + d] = from_f32<T>(a * inv);
    }
}

template <typename T, int NJ>
int launch_typed(const void* q, const void* k_arena, const void* v_arena, const void* pt_k,
                 const void* pt_v, const void* seq_lens, void* part_acc, void* part_ml,
                 void* out, int B, int H, int KVH, int D, int T_c, int C,
                 long long chunk_stride, int n_phys, int splits, float scale,
                 cudaStream_t stream) {
    const int G = H / KVH;
    const int g_tiles = (G + kGT - 1) / kGT;
    dim3 grid(B, KVH * g_tiles, splits);
    decode_attn_partial<T, NJ><<<grid, kThreads, 0, stream>>>(
        (const T*)q, (const T*)k_arena, (const T*)v_arena, (const int32_t*)pt_k,
        (const int32_t*)pt_v, (const int32_t*)seq_lens, (float*)part_acc, (float*)part_ml,
        H, KVH, D, T_c, C, chunk_stride, n_phys, splits, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    decode_attn_merge<T><<<B * H, kThreads, 0, stream>>>(
        (const float*)part_acc, (const float*)part_ml, (T*)out, D, splits);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_nj(int nj, const void* q, const void* k, const void* v, const void* ptk,
              const void* ptv, const void* sl, void* pa, void* pml, void* out, int B, int H,
              int KVH, int D, int T_c, int C, long long cs, int n_phys, int splits,
              float scale, cudaStream_t st) {
    switch (nj) {
#define CASE(N)                                                                          \
    case N:                                                                              \
        return launch_typed<T, N>(q, k, v, ptk, ptv, sl, pa, pml, out, B, H, KVH, D, T_c, \
                                  C, cs, n_phys, splits, scale, st);
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
#undef CASE
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Arenas are (n_phys, T_c, KVH, D) with
// the inner three dims contiguous and chunk_stride elements between chunks.
extern "C" int stitched_decode_attention(
    int dtype, const void* q, const void* k_arena, const void* v_arena, const void* pt_k,
    const void* pt_v, const void* seq_lens, void* part_acc, void* part_ml, void* out,
    int B, int H, int KVH, int D, int T_c, int C, long long chunk_stride, int n_phys,
    int splits, float scale, void* stream) {
    if (B == 0) return cudaSuccess;
    const int nj = (D + 31) / 32;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_nj<float>(nj, q, k_arena, v_arena, pt_k, pt_v, seq_lens, part_acc,
                                part_ml, out, B, H, KVH, D, T_c, C, chunk_stride, n_phys,
                                splits, scale, st);
    if (dtype == 1)
        return launch_nj<__nv_bfloat16>(nj, q, k_arena, v_arena, pt_k, pt_v, seq_lens,
                                        part_acc, part_ml, out, B, H, KVH, D, T_c, C,
                                        chunk_stride, n_phys, splits, scale, st);
    return (int)cudaErrorInvalidValue;
}
