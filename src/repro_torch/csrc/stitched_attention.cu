// Stitched decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stitched_attention.py
// ::stitched_decode_attention (_decode_attn_kernel): one-token GQA decode
// attention per sequence, reading K and V straight out of the chunk arena
// through per-sequence page tables (separate K and V tables allowed).
//
// Bound on H100: memory. Each valid token's K and V rows are read once
// (2 * KVH * D * itemsize bytes per token) and the arithmetic is ~4*G FLOPs
// per element read, far below the ~295 FLOPs/byte where tensor cores would
// become the limit; plain FMA keeps up if little else is spent per FMA. What
// decides the time is how many bytes each SM keeps in flight (about 18 KB
// cover HBM latency at 3.35 TB/s), how few instructions each token costs
// besides its FMAs, and how many launches a call costs.
//
// Design: one launch per call, grid (splits, B, KVH / KG).
//   * A block owns one sequence, KG kv heads with all their G query heads,
//     and one split: a fixed run of `tiles_per_split` tiles of the
//     sequence. A tile is TT consecutive tokens of one chunk, so its K (and
//     its V) for the block's heads is TT rows of KG * D contiguous elements;
//     with KG = KVH a tile is one contiguous run inside the chunk. A tile
//     never crosses a chunk boundary (the last tile of a chunk may be
//     short), and tiles stop at seq_len, so positions >= seq_len and padding
//     entries of the page table are never read. Chunk ids outside
//     [0, n_phys) are skipped. A block whose split starts past the last tile
//     exits at once.
//   * Tiles are staged in shared memory by a double buffer filled with
//     16-byte cp.async copies (the next tile is in flight while one is
//     computed). Rows are padded by 16 bytes, so threads that read the
//     same column of consecutive tokens hit distinct banks. Where the arena
//     is not 16-byte aligned the same ring is filled with plain loads.
//   * Per tile, three phases between barriers, f32 throughout:
//     scores: a thread takes one token of one kv head and dots its K row
//       (converted once) with up to GC of that head's query heads (q is
//       scaled in q's dtype, then held in f32 in shared memory);
//     softmax: a warp per query head makes one online-softmax update for
//       the whole tile (one max and one sum across its lanes);
//     P.V: a thread owns four dims of one kv head for up to GC query heads
//       (one V load feeds 4 * GC FMAs) and every P-th token of the tile;
//       the P phases are summed once, after the block's last tile.
//   * A sequence that fits one split writes its normalised output directly.
//     Otherwise each split writes an unnormalised (acc, m, l) partial; the
//     last block of the (sequence, head group) to finish, found by an atomic
//     ticket taken after __threadfence(), merges the live splits (their
//     count follows from seq_len: their (m, l) are read into shared memory
//     in one parallel pass, then acc with 16-byte loads) and resets the
//     ticket, so repeated calls and CUDA-graph replays need no reset launch.
//     The workspace holding tickets and partials belongs to one stream at a
//     time: calls on concurrent streams must not share it.
//   * A sliding window (`window` > 0) lets sequence b see positions
//     [max(0, seq_len - window), seq_len). The walk then starts at the tile
//     that holds the window's first position and the splits count from
//     there, so blocks whose tiles lie wholly before the window exit as
//     blocks past seq_len do; that first tile masks its positions before
//     the window. With `window` 0 the walk is the one above.
// The host-side plan (KG, TT, GC, P, tiles_per_split) is made by
// repro_torch/kernels/stitched_attention.py::attention_plan, whose
// tile_ranges() mirrors the tile walk below and whose smem_bytes() mirrors
// the shared-memory layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 320;  // with two blocks per SM: at most 102 registers a thread
constexpr int kMaxTile = 64;  // tokens per tile: at most two per lane in the softmax
// Stages of the tile ring. Two gave the best times on H100 at smollm-135m's
// shapes: 64-token tiles in 3 stages fit only one block per SM.
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;

// The host plan; layout mirrors _Plan in kernels/stitched_attention.py.
struct Plan {
    int dtype;  // 0 = float32, 1 = bfloat16
    int B, H, KVH, D, T_c, C, n_phys;
    long long chunk_stride;  // elements between chunks
    int kv_per_block;        // KG
    int tile_tokens;         // TT
    int head_chunk;          // GC: query heads a thread takes together
    int phases;              // P: token phases of P.V
    int tiles_per_split;
    int splits;   // grid.x: splits per sequence the capacity allows
    int threads;  // block size
    int aligned;  // 16-byte cp.async allowed
    int smem_bytes;
    float scale;
    int window;  // 0: none; else positions [seq_len - window, seq_len)
};

struct Args {
    const void* q;
    const void* k;
    const void* v;
    const int32_t* pt_k;
    const int32_t* pt_v;
    const int32_t* seq_lens;
    void* out;
    float* part;      // partial acc per (b, group, split): HB * D; then (m, l): HB * 2
    int32_t* ticket;  // per (b, group), zero between calls
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// Shared-memory reads as f32: 16 bytes (4 floats or 8 bf16) and 4 elements.
__device__ __forceinline__ float2 bf16x2_to_f32(unsigned x) {
    return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}
template <typename T> struct Smem;
template <> struct Smem<float> {
    static constexpr int N = 4;
    __device__ __forceinline__ static void load16(const float* p, float* f) {
        const float4 x = *reinterpret_cast<const float4*>(p);
        f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    }
    __device__ __forceinline__ static float4 load4(const float* p) {
        return *reinterpret_cast<const float4*>(p);
    }
};
template <> struct Smem<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void load16(const __nv_bfloat16* p, float* f) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 y = bf16x2_to_f32(w[i]);
            f[2 * i] = y.x;
            f[2 * i + 1] = y.y;
        }
    }
    __device__ __forceinline__ static float4 load4(const __nv_bfloat16* p) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        const float2 a = bf16x2_to_f32(x.x), b = bf16x2_to_f32(x.y);
        return make_float4(a.x, a.y, b.x, b.y);
    }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

// Where tile j of a sequence of `seq` valid positions lies: chunk, first
// token in the chunk, and token count. Mirrors tile_ranges() on the host.
struct Tile {
    int c, t0, n;
};
__device__ __forceinline__ Tile tile_at(int j, int tpc, int TT, int T_c, long long seq) {
    Tile t;
    t.c = j / tpc;
    t.t0 = (j - t.c * tpc) * TT;
    const long long left = seq - (long long)t.c * T_c - t.t0;
    const int n = T_c - t.t0 < TT ? T_c - t.t0 : TT;
    t.n = left < n ? (int)left : n;
    return t;
}

template <typename T, int GC>
__global__ void __launch_bounds__(kMaxThreads, 2)
decode_attn(const Args a, const Plan p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int split = blockIdx.x, b = blockIdx.y, grp = blockIdx.z;
    const int n_grp = gridDim.z;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int threads = blockDim.x, warps = threads / 32;
    const int D = p.D, TT = p.tile_tokens, KG = p.kv_per_block;
    const int G = p.H / p.KVH;
    const int HB = KG * G;                 // query heads of this block
    const int chunks = (G + GC - 1) / GC;  // head chunks per kv head
    const int KC = KG * chunks;            // (kv head, head chunk) pairs
    const int PR = KC * 4;                 // row of p: 4 slots per pair
    const int U = KC * (D / 4);            // P.V units: (pair, 4 dims)
    const int P = p.phases;
    const int h0 = grp * HB, kv0 = grp * KG;

    // the sequence's tiles and this split's share of them
    long long seq = a.seq_lens[b];
    const long long cap = (long long)p.C * p.T_c;
    seq = seq < 0 ? 0 : (seq > cap ? cap : seq);
    const int tpc = (p.T_c + TT - 1) / TT;
    const int full = (int)(seq / p.T_c);
    const int rem = (int)(seq - (long long)full * p.T_c);
    const int n_tiles = full * tpc + (rem + TT - 1) / TT;
    // the window's first position and the tile that holds it
    const long long lo = p.window > 0 && seq > p.window ? seq - p.window : 0;
    const int c_lo = (int)(lo / p.T_c);
    const int j_lo = c_lo * tpc + (int)(lo - (long long)c_lo * p.T_c) / TT;
    int n_live = (n_tiles - j_lo + p.tiles_per_split - 1) / p.tiles_per_split;
    if (n_live < 1) n_live = 1;  // split 0 of an empty sequence writes zeros
    if (split >= n_live) return;
    const int j0 = j_lo + split * p.tiles_per_split;
    const int j1 = j0 + p.tiles_per_split < n_tiles ? j0 + p.tiles_per_split : n_tiles;

    // shared memory: the ring of kStages (K tile, V tile) stages, which after
    // the last tile holds the P.V phases' sums and then the merge's (m, l);
    // then q, p, and per-head state
    const int row_bytes = KG * D * (int)sizeof(T);
    const int pitch = row_bytes + 16;
    const int tile_bytes = TT * pitch;
    int ring_bytes = kStages * 2 * tile_bytes;
    if (ring_bytes < 8 * p.splits * HB) ring_bytes = 8 * p.splits * HB;
    if (ring_bytes < 16 * P * U * GC) ring_bytes = 16 * P * U * GC;
    ring_bytes = (ring_bytes + 15) & ~15;
    unsigned char* ring = smem;
    float* q_s = reinterpret_cast<float*>(smem + ring_bytes);  // HB x D
    float* p_s = q_s + HB * D;                                 // TT x PR
    float* m_s = p_s + TT * PR;
    float* l_s = m_s + HB;
    float* al_s = l_s + HB;
    int* flag_s = reinterpret_cast<int*>(al_s + HB);

    const T* k_arena = static_cast<const T*>(a.k);
    const T* v_arena = static_cast<const T*>(a.v);
    const int32_t* ptk = a.pt_k + (long long)b * p.C;
    const int32_t* ptv = a.pt_v + (long long)b * p.C;
    const long long tok_elems = (long long)p.KVH * D;  // one token row of all kv heads

    // copy lanes: thread tid moves 16-byte column cp_c16 of rows cp_r0,
    // cp_r0 + cp_rstep, ... A row has no more 16-byte columns than the
    // block has threads (one thread per P.V unit of four dims at least).
    const int vecs = row_bytes / 16;
    const int cp_rstep = threads / vecs;
    const int cp_r0 = tid < cp_rstep * vecs ? tid / vecs : TT;
    const int cp_c16 = tid % vecs;

    // start the copies of tile j into stage st; false for a skipped tile
    auto load_tile = [&](int j, int st) -> bool {
        const Tile t = tile_at(j, tpc, TT, p.T_c, seq);
        const int ck = ptk[t.c], cv = ptv[t.c];
        if (ck < 0 || ck >= p.n_phys || cv < 0 || cv >= p.n_phys) return false;
        const long long off = (long long)t.t0 * tok_elems + (long long)kv0 * D;
        const T* ks = k_arena + (long long)ck * p.chunk_stride + off;
        const T* vs = v_arena + (long long)cv * p.chunk_stride + off;
        unsigned char* kd = ring + (size_t)st * 2 * tile_bytes;
        unsigned char* vd = kd + tile_bytes;
        if (p.aligned) {
            for (int r = cp_r0; r < t.n; r += cp_rstep) {
                const long long src = r * tok_elems;
                cp_async16(kd + r * pitch + cp_c16 * 16,
                           reinterpret_cast<const unsigned char*>(ks + src) + cp_c16 * 16);
                cp_async16(vd + r * pitch + cp_c16 * 16,
                           reinterpret_cast<const unsigned char*>(vs + src) + cp_c16 * 16);
            }
        } else {
            const int n_el = KG * D;
            for (int i = tid; i < t.n * n_el; i += threads) {
                const int r = i / n_el, e = i - r * n_el;
                reinterpret_cast<T*>(kd + r * pitch)[e] = ks[r * tok_elems + e];
                reinterpret_cast<T*>(vd + r * pitch)[e] = vs[r * tok_elems + e];
            }
        }
        return true;
    };

    // this thread's P.V unit: (kv head, head chunk) pair, four dims, phase
    const int phase = tid / U, unit = tid - phase * U;
    const int pv_kc = unit / (D / 4), pv_d = (unit - pv_kc * (D / 4)) * 4;
    const int pv_kvh = pv_kc / chunks, pv_g0 = (pv_kc - pv_kvh * chunks) * GC;
    const bool pv_on = phase < P;
    float acc[GC][4];
#pragma unroll
    for (int g = 0; g < GC; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;

    // bit st: the tile in stage st is read (its chunks are in range)
    unsigned live = j0 < j1 && load_tile(j0, 0) ? 1u : 0u;
    cp_async_commit();

    // q (scaled in q's dtype, then f32) and the state, while the first tiles load
    const T* q = static_cast<const T*>(a.q);
    for (int i = tid; i < HB * D; i += threads) {
        const T raw = q[((long long)b * p.H + h0) * D + i];
        q_s[i] = to_f32(from_f32<T>(to_f32(raw) * p.scale));
    }
    for (int i = tid; i < HB; i += threads) {
        m_s[i] = kNegInf;
        l_s[i] = 0.f;
    }
    for (int j = j0; j < j1; ++j) {
        const int it = j - j0;
        cp_async_wait_all();
        __syncthreads();  // tile j has landed; tile j-1's stage and p are free
        const int st = it % kStages, next = (it + 1) % kStages;
        if (j + 1 < j1)
            live = (live & ~(1u << next)) | (unsigned)load_tile(j + 1, next) << next;
        cp_async_commit();
        if (!(live >> st & 1u)) continue;
        const Tile tl = tile_at(j, tpc, TT, p.T_c, seq);
        const int n = tl.n;
        // rows before the window (the first tile only) score -inf
        const long long first = (long long)tl.c * p.T_c + tl.t0;
        const int masked = lo > first ? (int)(lo - first) : 0;
        const unsigned char* ks = ring + (size_t)st * 2 * tile_bytes;
        const unsigned char* vs = ks + tile_bytes;

        // scores: a task is one token of one (kv head, head chunk) pair
        for (int task = tid; task < KC * n; task += threads) {
            const int kc = task / n, r = task - kc * n;
            const int kvh = kc / chunks, g0 = (kc - kvh * chunks) * GC;
            const T* krow = reinterpret_cast<const T*>(ks + r * pitch) + kvh * D;
            const float* qh = q_s + (kvh * G + g0) * D;
            float s[GC];
#pragma unroll
            for (int g = 0; g < GC; ++g) s[g] = 0.f;
#pragma unroll 2
            for (int d = 0; d < D; d += Smem<T>::N) {
                float kf[Smem<T>::N];
                Smem<T>::load16(krow + d, kf);
#pragma unroll
                for (int g = 0; g < GC; ++g) {
                    if (g0 + g < G) {
#pragma unroll
                        for (int e = 0; e < Smem<T>::N; e += 4) {
                            const float4 qv =
                                *reinterpret_cast<const float4*>(qh + g * D + d + e);
                            s[g] = fmaf(qv.x, kf[e], s[g]);
                            s[g] = fmaf(qv.y, kf[e + 1], s[g]);
                            s[g] = fmaf(qv.z, kf[e + 2], s[g]);
                            s[g] = fmaf(qv.w, kf[e + 3], s[g]);
                        }
                    }
                }
            }
#pragma unroll
            for (int g = 0; g < GC; ++g) p_s[r * PR + kc * 4 + g] = r < masked ? kNegInf : s[g];
        }
        __syncthreads();

        // one online-softmax update per query head for the whole tile
        for (int hl = warp; hl < HB; hl += warps) {
            const int g = hl % G;
            const int col = ((hl / G) * chunks + g / GC) * 4 + g % GC;
            float sc[kMaxTile / 32];
            float mx = kNegInf;
#pragma unroll
            for (int k = 0; k < kMaxTile / 32; ++k) {
                const int r = lane + 32 * k;
                sc[k] = r < n ? p_s[r * PR + col] : kNegInf;
                mx = fmaxf(mx, sc[k]);
            }
            mx = warp_max(mx);
            const float m_old = m_s[hl];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
#pragma unroll
            for (int k = 0; k < kMaxTile / 32; ++k) {
                const int r = lane + 32 * k;
                if (r < n) {
                    const float pe = expf(sc[k] - m_new);
                    p_s[r * PR + col] = pe;
                    sum += pe;
                }
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                al_s[hl] = alpha;
                l_s[hl] = l_s[hl] * alpha + sum;
                m_s[hl] = m_new;
            }
        }
        __syncthreads();

        // P.V: every P-th token from this thread's phase
        if (pv_on) {
            const int hb = pv_kvh * G + pv_g0;
#pragma unroll
            for (int g = 0; g < GC; ++g) {
                const float alpha = pv_g0 + g < G ? al_s[hb + g] : 0.f;
#pragma unroll
                for (int k = 0; k < 4; ++k) acc[g][k] *= alpha;
            }
            const unsigned char* vcol = vs + (pv_kvh * D + pv_d) * (int)sizeof(T);
            const float* pcol = p_s + pv_kc * 4;
#pragma unroll 2
            for (int r = phase; r < n; r += P) {
                const float4 v4 = Smem<T>::load4(reinterpret_cast<const T*>(vcol + r * pitch));
                const float4 p4 = *reinterpret_cast<const float4*>(pcol + r * PR);
                const float pg[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
                for (int g = 0; g < GC; ++g) {
                    acc[g][0] = fmaf(pg[g], v4.x, acc[g][0]);
                    acc[g][1] = fmaf(pg[g], v4.y, acc[g][1]);
                    acc[g][2] = fmaf(pg[g], v4.z, acc[g][2]);
                    acc[g][3] = fmaf(pg[g], v4.w, acc[g][3]);
                }
            }
        }
    }
    cp_async_wait_all();
    __syncthreads();  // the ring is free; final (m, l) visible to every thread

    // sum the P.V phases: red[phase][unit][g][4]
    float* red = reinterpret_cast<float*>(ring);
    if (pv_on) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
            *reinterpret_cast<float4*>(red + ((phase * U + unit) * GC + g) * 4) =
                make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
    __syncthreads();

    T* out = static_cast<T*>(a.out) + ((long long)b * p.H + h0) * D;
    const long long grp_idx = (long long)b * n_grp + grp;
    const long long n_parts = (long long)gridDim.y * n_grp * p.splits;
    float* part_acc = a.part + (grp_idx * p.splits + split) * HB * D;
    float* part_ml = a.part + n_parts * HB * D + grp_idx * p.splits * HB * 2;
    for (int i = tid; i < U * GC * 4; i += threads) {
        const int u = i / (GC * 4), g = (i / 4) % GC, k = i % 4;
        const int kc = u / (D / 4), d = (u - kc * (D / 4)) * 4 + k;
        const int kvh = kc / chunks, gg = (kc - kvh * chunks) * GC + g;
        if (gg >= G) continue;
        float sum = 0.f;
        for (int ph = 0; ph < P; ++ph) sum += red[ph * U * GC * 4 + i];
        const int hl = kvh * G + gg;
        if (n_live == 1) {
            const float l = l_s[hl];
            out[hl * D + d] = from_f32<T>(sum / (l > 0.f ? l : 1.f));
        } else {
            part_acc[hl * D + d] = sum;
        }
    }
    if (n_live == 1) return;

    // this split's unnormalised acc is written; (m, l), then the ticket
    for (int hl = tid; hl < HB; hl += threads)
        *reinterpret_cast<float2*>(part_ml + ((long long)split * HB + hl) * 2) =
            make_float2(m_s[hl], l_s[hl]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
        const int ticket = atomicAdd(a.ticket + grp_idx, 1);
        const int last = ticket == n_live - 1;
        if (last) atomicExch(a.ticket + grp_idx, 0);
        *flag_s = last;
    }
    __syncthreads();
    if (!*flag_s) return;
    __threadfence();

    // last block: merge the live splits, read through L2 (other SMs wrote them).
    // (m, l) of every split into shared memory at once; then per head the
    // weights exp(m - max) and 1 / sum(l * w); then acc, 16 bytes a load.
    const float* accs = a.part + grp_idx * p.splits * HB * D;
    float* mw_s = reinterpret_cast<float*>(ring);  // n_live x HB: m, then the weight
    float* lw_s = mw_s + n_live * HB;              // n_live x HB: l
    for (int i = tid; i < n_live * HB; i += threads) {
        const float2 ml = __ldcg(reinterpret_cast<const float2*>(part_ml) + i);
        mw_s[i] = ml.x;
        lw_s[i] = ml.y;
    }
    __syncthreads();
    for (int hl = warp; hl < HB; hl += warps) {
        float mx = kNegInf;
        for (int s = lane; s < n_live; s += 32) mx = fmaxf(mx, mw_s[s * HB + hl]);
        mx = warp_max(mx);
        float lsum = 0.f;
        for (int s = lane; s < n_live; s += 32) {
            const float w = expf(mw_s[s * HB + hl] - mx);
            mw_s[s * HB + hl] = w;
            lsum = fmaf(lw_s[s * HB + hl], w, lsum);
        }
        lsum = warp_sum(lsum);
        if (lane == 0) al_s[hl] = 1.f / (lsum > 0.f ? lsum : 1.f);
    }
    __syncthreads();
    for (int i = tid; i < HB * D / 4; i += threads) {
        const int hl = 4 * i / D;
        float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
        for (int s = 0; s < n_live; ++s) {
            const float w = mw_s[s * HB + hl];
            const float4 x =
                __ldcg(reinterpret_cast<const float4*>(accs + (long long)s * HB * D) + i);
            r.x = fmaf(w, x.x, r.x);
            r.y = fmaf(w, x.y, r.y);
            r.z = fmaf(w, x.z, r.z);
            r.w = fmaf(w, x.w, r.w);
        }
        const float inv = al_s[hl];
        out[4 * i] = from_f32<T>(r.x * inv);
        out[4 * i + 1] = from_f32<T>(r.y * inv);
        out[4 * i + 2] = from_f32<T>(r.z * inv);
        out[4 * i + 3] = from_f32<T>(r.w * inv);
    }
}

template <typename T, int GC>
int launch(const Plan& p, const Args& a, cudaStream_t st) {
    auto kern = decode_attn<T, GC>;
    if (p.smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(p.splits, p.B, p.KVH / p.kv_per_block);
    kern<<<grid, p.threads, p.smem_bytes, st>>>(a, p);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_chunk(const Plan& p, const Args& a, cudaStream_t st) {
    switch (p.head_chunk) {
        case 1: return launch<T, 1>(p, a, st);
        case 2: return launch<T, 2>(p, a, st);
        case 3: return launch<T, 3>(p, a, st);
        case 4: return launch<T, 4>(p, a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

__global__ void empty_kernel() {}

}  // namespace

// One launch. `plan` points at a Plan made once per geometry by the host;
// `tickets` (zero between calls) and `partials` are the workspace that
// kernels/stitched_attention.py keeps per device.
extern "C" int stitched_decode_attention(const void* plan, const void* q, const void* k_arena,
                                         const void* v_arena, const void* pt_k,
                                         const void* pt_v, const void* seq_lens, void* out,
                                         void* tickets, void* partials, void* stream) {
    const Plan& p = *static_cast<const Plan*>(plan);
    if (p.B == 0) return cudaSuccess;
    const int G = p.H / p.KVH;
    const int units = p.kv_per_block * ((G + p.head_chunk - 1) / p.head_chunk) * (p.D / 4);
    if (p.H % p.KVH || p.KVH % p.kv_per_block || p.D % 8 || p.tile_tokens > kMaxTile ||
        p.window < 0 ||
        p.threads % 32 || p.threads > kMaxThreads ||
        units * p.phases > p.threads || p.kv_per_block * p.D * (p.dtype ? 2 : 4) > 16 * p.threads)
        return (int)cudaErrorInvalidValue;
    Args a{q,
           k_arena,
           v_arena,
           static_cast<const int32_t*>(pt_k),
           static_cast<const int32_t*>(pt_v),
           static_cast<const int32_t*>(seq_lens),
           out,
           static_cast<float*>(partials),
           static_cast<int32_t*>(tickets)};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (p.dtype == 0) return launch_chunk<float>(p, a, st);
    if (p.dtype == 1) return launch_chunk<__nv_bfloat16>(p, a, st);
    return (int)cudaErrorInvalidValue;
}

// An empty kernel: chip_smoke.py times it as the floor of one launch.
extern "C" int empty_kernel_launch(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return (int)cudaGetLastError();
}
