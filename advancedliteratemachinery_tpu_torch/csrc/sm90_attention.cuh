// The Hopper attention core behind K1 (fused_qkv_attention.cu) and K5
// (mha_short_seq.cu): per (batch, head), softmax(q k^T * scale) v on
// 64-wide heads, q, k and v each read in place from [B, S, H, 64] bf16
// through its own (batch, row, head) strides, output [B, S, H, 64] bf16
// contiguous. Scores, softmax statistics and products accumulate in f32.
//
// Two softmax forms, one per kernel:
// - ONLINE (K1): one walk over the keys; `safe` keeps a running row max
//   and rescales, unsafe fixes the max at 0 (Policy.unsafe_softmax); p goes
//   into P V as bf16 and into the row sum unrounded; the output is
//   normalised at the end.
// - TWO_WALK (K5, the JAX `_mha_kernel`'s rounding): a first walk over K
//   gives each row's max and sum, a second forms p = bf16(exp(s - m) / l),
//   normalised before it is rounded, and accumulates P V.
//
// A block is one producer warp and two consumer warpgroups (288 threads,
// 96 registers a thread, two blocks an SM). One producer thread issues
// every copy by TMA over a 4-D map of each operand (dims 64, head, row,
// batch with the view's own strides; the encoder takes every stride a view
// can have, 0 and out of order included). A tile is 64 rows x 128 bytes in
// the 128-byte swizzle and completes on its own mbarrier; rows past S
// arrive as zeros. A consumer warpgroup owns one 64-row query tile at a
// time, kept in shared memory: S = Q K^T by wgmma SS (m64n64k16, or
// m64n16k16 for a last chunk of at most 16 keys), the softmax on the
// accumulators in registers (a row lives on the four lanes of a quad),
// P repacked in registers as bf16 A fragments, and O += P V by wgmma RS
// with V read MN-major where TMA put it.
//
// Two ways to hold K and V, chosen at launch:
// - resident: the block is a (batch, head); every 64-key chunk of K and V
//   has its own slot, loaded once, and the consumers take the head's query
//   tiles in turn (w, w + 2, ...), each refilled by the producer as soon
//   as its consumer's last Q K^T on the previous one is done;
// - streamed (TWO_WALK only, where a resident head would not leave two
//   blocks an SM): the block is a (batch, head, pair of query tiles), and
//   both walks stream K (and V in the second) through a ring of STAGES
//   stages that the two consumers share.
// No atomics: the same inputs give the same bits.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

// internal linkage: each kernel library keeps its own instantiations (and
// the once-per-device flags in them) even when several are loaded at once
namespace {
namespace attn {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;                       // head dim
constexpr int TILE = 64;                     // query rows a tile, keys a chunk
constexpr int TILE_BYTES = TILE * HD * 2;    // 8 KB
constexpr int NCONS = 2;                     // consumer warpgroups a block
constexpr int NTHREADS = NCONS * 128 + 32;   // + the producer warp
constexpr int STAGES = 4;                    // K/V ring of the streamed form
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ONLINE = 0;
constexpr int TWO_WALK = 1;

struct Params {
    bf16* out;              // [B, S, H, 64]
    int S, H;
    int n_qt, n_kc;         // 64-row query tiles, 64-key chunks
    float sl2;              // scale * log2(e): scores in log2 units
    int safe;               // ONLINE only
};

// dynamic shared memory of a launch: alignment slack, two Q tiles, the K/V
// tiles, the mbarriers
inline size_t smem_bytes(bool stream, int n_kc) {
    const int kv_tiles = stream ? 2 * STAGES : 2 * n_kc;
    const int bars = 2 * NCONS + (stream ? 2 * STAGES : kv_tiles);
    return 1024 + (size_t)(NCONS + kv_tiles) * TILE_BYTES + 8 * bars;
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// rows row0..row0+63 of head h, batch b through `map` into the tile at
// `dst`, as one phase of `bar`
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          unsigned char* dst, uint64_t* bar,
                                          int b, int h, int row0) {
    sm90::mbar_arrive_expect_tx(bar, TILE_BYTES);
    sm90::tma_load_4d(dst, map, bar, 0, h, row0, b);
}

// ---- consumer steps ----------------------------------------------------

// s = Q K^T for one chunk (NK keys), waited for
template <int NK>
__device__ __forceinline__ void qk(float (&s)[NK / 2], uint64_t dq,
                                   uint64_t dk) {
    sm90::fence_operands(s);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_bf16<NK>(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(s);
}

// scores to log2 units; keys at or past `left` (the chunk's valid keys) to
// -inf. s[4j + 2r + e] is row g + 8r, key 8j + 2t + e.
template <int NK>
__device__ __forceinline__ void scale_mask(float (&s)[NK / 2], int left,
                                           float sl2, int t) {
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) s[i] *= sl2;
    if (left < NK) {
#pragma unroll
        for (int i = 0; i < NK / 2; ++i)
            if ((i / 4) * 8 + 2 * t + (i & 1) >= left) s[i] = -INFINITY;
    }
}

// the row max of this chunk, across the quad that holds each row
template <int NK>
__device__ __forceinline__ void row_max(const float (&s)[NK / 2],
                                        float (&bm)[2]) {
    bm[0] = bm[1] = -INFINITY;
#pragma unroll
    for (int i = 0; i < NK / 2; ++i)
        bm[(i >> 1) & 1] = fmaxf(bm[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
        bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
    }
}

// first walk of TWO_WALK: fold one chunk into the running max m and the
// running (per-lane) sum l of exp2(x - m)
template <int NK>
__device__ __forceinline__ void stats_step(uint64_t dq, uint64_t dk,
                                           int left, float sl2, int t,
                                           float (&m)[2], float (&l)[2]) {
    float s[NK / 2];
    qk<NK>(s, dq, dk);
    scale_mask<NK>(s, left, sl2, t);
    float bm[2];
    row_max<NK>(s, bm);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], bm[r]);
        l[r] *= ex2(m[r] - m_new);                 // 0 on the first chunk
        m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < NK / 2; ++i)
        l[(i >> 1) & 1] += ex2(s[i] - m[(i >> 1) & 1]);
}

// One chunk into the output: s = Q K^T, `release` (if any) arrived on by
// lane 0 once that product is done, p from s, O += P V, waited for.
// ONLINE: p = exp2(x - m), with the running max when `safe` (O and l
// rescaled), and l += p. TWO_WALK: p = exp2(x - m) * inv, m and inv final.
// A warpgroup waits for its own products, so none of their operands stays
// live across the softmax and a thread fits in 96 registers (two blocks an
// SM); the SM's other three consumer warpgroups keep the tensor cores busy
// meanwhile.
template <int NK, int MODE>
__device__ __forceinline__ void out_step(uint64_t dq, uint64_t dk,
                                         uint64_t dv, int left, float sl2,
                                         int t, int lane, int safe,
                                         uint64_t* release, float (&m)[2],
                                         float (&l)[2],
                                         const float (&inv)[2],
                                         float (&o)[32]) {
    float s[NK / 2];
    qk<NK>(s, dq, dk);
    if (release != nullptr && lane == 0) sm90::mbar_arrive(release);
    scale_mask<NK>(s, left, sl2, t);
    if (MODE == ONLINE && safe) {
        float bm[2];
        row_max<NK>(s, bm);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const float m_new = fmaxf(m[r], bm[r]);
            const float alpha = ex2(m[r] - m_new);  // 0 on the first chunk
            m[r] = m_new;
            l[r] *= alpha;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                o[4 * j + 2 * r] *= alpha;
                o[4 * j + 2 * r + 1] *= alpha;
            }
        }
    }
    // the C layout of score columns 16k..16k+15 is the A layout of P V's
    // k-th step
    uint32_t pa[NK / 16][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            p[e] = ex2(s[4 * j + e] - m[e >> 1]);
            if (MODE == TWO_WALK) p[e] *= inv[e >> 1];
        }
        if (MODE == ONLINE) {
            l[0] += p[0] + p[1];
            l[1] += p[2] + p[3];
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // nothing that writes o or P may sink past the fence into the products
    sm90::fence_operands(o);
    sm90::fence_operands(pa);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
        sm90::wgmma_m64n64k16_rs(o, pa[kk], dv + 128 * kk, 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_operands(o);
}

// a[i] for a lane-dependent i, by selects (no local-memory indexing)
__device__ __forceinline__ uint32_t pick4(const uint32_t* a, int i) {
    return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// Store this thread's two rows of the tile (rows `row` and row + 8), each
// times inv[r], as bf16. A quad holds a row as words (8j + 2t, +1); four
// xor-shuffle rounds give lane t columns 8t..8t+7 and 8t+32..8t+39, stored
// as two 16-byte vectors.
__device__ __forceinline__ void store_rows(const float (&o)[32],
                                           const float (&inv)[2], bf16* out,
                                           int row, int S,
                                           long long row_pitch, int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        uint32_t w[8], lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
            w[j] = pack_bf16(o[4 * j + 2 * r] * inv[r],
                             o[4 * j + 2 * r + 1] * inv[r]);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
            const int partner = t ^ x;
            const uint32_t a =
                __shfl_xor_sync(0xffffffffu, pick4(w, partner), x);
            const uint32_t c =
                __shfl_xor_sync(0xffffffffu, pick4(w + 4, partner), x);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (q == partner) {
                    lo[q] = a;
                    hi[q] = c;
                }
            }
        }
        if (row + 8 * r < S) {
            bf16* dst = out + (row + 8 * r) * row_pitch + 8 * t;
            *reinterpret_cast<uint4*>(dst) =
                make_uint4(lo[0], lo[1], lo[2], lo[3]);
            *reinterpret_cast<uint4*>(dst + 32) =
                make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
    }
}

// ---- the kernel -------------------------------------------------------

template <int MODE, bool STREAM>
__global__ void __launch_bounds__(NTHREADS, 2)
attention_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const Params p) {
    static_assert(!STREAM || MODE == TWO_WALK, "K1 is always resident");
    extern __shared__ unsigned char smem_raw[];
    // 1024-byte aligned for the swizzle; kept an offset from the shared
    // array so that every access stays a shared-memory one
    unsigned char* qbuf = smem_raw + sm90::align1024_pad(smem_raw);
    unsigned char* kvbuf = qbuf + NCONS * TILE_BYTES;
    const int kv_tiles = STREAM ? 2 * STAGES : 2 * p.n_kc;
    uint64_t* q_full =
        reinterpret_cast<uint64_t*>(kvbuf + kv_tiles * TILE_BYTES);
    uint64_t* q_empty = q_full + NCONS;
    // resident: K chunk j at [j], V chunk j at [n_kc + j]; streamed: stage
    // s (K and V) at [s]
    uint64_t* kv_full = q_empty + NCONS;
    uint64_t* kv_empty = kv_full + STAGES;           // streamed only

    const int n_pairs = (p.n_qt + NCONS - 1) / NCONS;
    const int bh = STREAM ? blockIdx.x / n_pairs : blockIdx.x;
    const int pair = STREAM ? blockIdx.x % n_pairs : 0;
    const int h = bh % p.H, b = bh / p.H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int w = 0; w < NCONS; ++w) {
            sm90::mbar_init(&q_full[w], 1);
            sm90::mbar_init(&q_empty[w], 4);       // one arrival a warp
        }
        for (int i = 0; i < (STREAM ? STAGES : kv_tiles); ++i)
            sm90::mbar_init(&kv_full[i], 1);
        if (STREAM)
            for (int s = 0; s < STAGES; ++s)
                sm90::mbar_init(&kv_empty[s], 4 * NCONS);
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (warp == NCONS * 4) {
        // ---- producer: one thread issues every load of the block
        if (lane != 0) return;
        for (int w = 0; w < NCONS; ++w) {
            const int tile = STREAM ? pair * NCONS + w : w;
            if (STREAM || tile < p.n_qt)
                load_tile(&map_q, qbuf + w * TILE_BYTES, &q_full[w], b, h,
                          tile * TILE);
        }
        if (STREAM) {
            // walk 1: K chunks; walk 2: K and V chunks
            for (int it = 0; it < 2 * p.n_kc; ++it) {
                const int slot = it % STAGES, row0 = (it % p.n_kc) * TILE;
                unsigned char* st = kvbuf + slot * 2 * TILE_BYTES;
                sm90::mbar_wait(&kv_empty[slot], ((it / STAGES) & 1) ^ 1);
                if (it < p.n_kc) {
                    load_tile(&map_k, st, &kv_full[slot], b, h, row0);
                } else {
                    sm90::mbar_arrive_expect_tx(&kv_full[slot],
                                                2 * TILE_BYTES);
                    sm90::tma_load_4d(st, &map_k, &kv_full[slot], 0, h, row0,
                                      b);
                    sm90::tma_load_4d(st + TILE_BYTES, &map_v,
                                      &kv_full[slot], 0, h, row0, b);
                }
            }
        } else {
            for (int j = 0; j < p.n_kc; ++j) {
                load_tile(&map_k, kvbuf + j * TILE_BYTES, &kv_full[j], b, h,
                          j * TILE);
                load_tile(&map_v, kvbuf + (p.n_kc + j) * TILE_BYTES,
                          &kv_full[p.n_kc + j], b, h, j * TILE);
            }
            // later query tiles, each into its consumer's buffer once that
            // consumer's last Q K^T on the previous one is done
            for (int i = NCONS; i < p.n_qt; ++i) {
                const int w = i % NCONS, c = i / NCONS;
                sm90::mbar_wait(&q_empty[w], (c - 1) & 1);
                load_tile(&map_q, qbuf + w * TILE_BYTES, &q_full[w], b, h,
                          i * TILE);
            }
        }
        return;
    }

    // ---- consumer warpgroups
    const int wg = warp / 4;
    const int t = lane % 4;
    const int row_in_tile = (warp % 4) * 16 + lane / 4;
    const uint64_t dq = sm90::desc_sw128(qbuf + wg * TILE_BYTES);
    const int last = p.n_kc - 1;
    const int tail = p.S - last * TILE;          // keys in the last chunk
    const bool short_tail = tail <= 16;
    const long long row_pitch = (long long)p.H * HD;
    bf16* out = p.out + ((long long)b * p.S * p.H + h) * HD;

    // the K and V tiles of walk step `it`, over chunk j: a resident slot
    // is waited for once loaded, a streamed stage each time it is refilled
    auto k_tile = [&](int it, int j) -> unsigned char* {
        if (STREAM) {
            const int slot = it % STAGES;
            sm90::mbar_wait(&kv_full[slot], (it / STAGES) & 1);
            return kvbuf + slot * 2 * TILE_BYTES;
        }
        sm90::mbar_wait(&kv_full[j], 0);
        return kvbuf + j * TILE_BYTES;
    };
    auto v_tile = [&](int it, int j) -> unsigned char* {
        if (STREAM)
            return kvbuf + (it % STAGES) * 2 * TILE_BYTES + TILE_BYTES;
        sm90::mbar_wait(&kv_full[p.n_kc + j], 0);
        return kvbuf + (p.n_kc + j) * TILE_BYTES;
    };
    // a streamed stage goes back to the producer once its products are done
    auto hand_back = [&](int it) {
        if (STREAM && lane == 0) sm90::mbar_arrive(&kv_empty[it % STAGES]);
    };

    // resident: tiles wg, wg + 2, ...; streamed: tile 2 pair + wg, which
    // lies past S when the head has an odd number of tiles (computed on
    // zeros, stored nowhere)
    const int first = STREAM ? pair * NCONS + wg : wg;
    const int n_mine = STREAM ? 1 : (p.n_qt - wg + NCONS - 1) / NCONS;
    for (int c = 0; c < n_mine; ++c) {
        const int i = first + c * NCONS;
        sm90::mbar_wait(&q_full[wg], c & 1);
        float m[2], l[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f}, o[32];
        int it = 0;
        if (MODE == TWO_WALK) {
            m[0] = m[1] = -INFINITY;
            for (int j = 0; j < p.n_kc; ++j, ++it) {
                const uint64_t dk = sm90::desc_sw128(k_tile(it, j));
                if (j == last && short_tail)
                    stats_step<16>(dq, dk, tail, p.sl2, t, m, l);
                else
                    stats_step<64>(dq, dk, p.S - j * TILE, p.sl2, t, m, l);
                hand_back(it);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
                inv[r] = 1.f / l[r];
            }
        } else {
            m[0] = m[1] = p.safe ? -INFINITY : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 32; ++k) o[k] = 0.f;
        for (int j = 0; j < p.n_kc; ++j, ++it) {
            const uint64_t dk = sm90::desc_sw128(k_tile(it, j));
            const uint64_t dv = sm90::desc_sw128_mn(v_tile(it, j));
            // resident: the tile's last Q K^T frees its Q buffer
            uint64_t* release = !STREAM && j == last ? &q_empty[wg] : nullptr;
            if (j == last && short_tail)
                out_step<16, MODE>(dq, dk, dv, tail, p.sl2, t, lane, p.safe,
                                   release, m, l, inv, o);
            else
                out_step<64, MODE>(dq, dk, dv, p.S - j * TILE, p.sl2, t,
                                   lane, p.safe, release, m, l, inv, o);
            hand_back(it);
        }
        if (MODE == ONLINE) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
                l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
                inv[r] = 1.f / l[r];
            }
        } else {
            inv[0] = inv[1] = 1.f;                 // p was normalised
        }
        store_rows(o, inv, out, i * TILE + row_in_tile, p.S, row_pitch, t);
    }
}

// ---- host -------------------------------------------------------------

// the 4-D map of operand [B, S, H, 64] at `ptr` with element strides sb,
// ss, sh: dims 64, H, S, B, boxes of 64 rows of one head
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, long long sb,
                            long long ss, long long sh, int B, int S,
                            int H) {
    const cuuint64_t dims[4] = {HD, (cuuint64_t)H, (cuuint64_t)S,
                                (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {HD, 1, TILE, 1};
    return sm90::encode_tile_map(map, 4, ptr, dims, strides, box);
}

// Encode the maps of q, k, v (element strides per operand: batch, row,
// head) and launch the kernel, resident or streamed, on `stream`.
template <int MODE, bool STREAM>
inline cudaError_t run(const void* q, const void* k, const void* v,
                       void* out, const long long (&strides)[9], int B,
                       int S, int H, float scale, int safe,
                       cudaStream_t stream) {
    CUtensorMap maps[3];
    const void* ptrs[3] = {q, k, v};
    for (int i = 0; i < 3; ++i) {
        const cudaError_t err =
            make_map(&maps[i], ptrs[i], strides[3 * i], strides[3 * i + 1],
                     strides[3 * i + 2], B, S, H);
        if (err != cudaSuccess) return err;
    }
    static unsigned configured = 0;
    cudaError_t err = sm90::once_per_device(configured, [] {
        cudaError_t e = cudaFuncSetAttribute(
            attention_kernel<MODE, STREAM>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                attention_kernel<MODE, STREAM>,
                cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
        return e;
    });
    if (err != cudaSuccess) return err;
    Params p{};
    p.out = static_cast<bf16*>(out);
    p.S = S;
    p.H = H;
    p.n_qt = p.n_kc = (S + TILE - 1) / TILE;
    p.sl2 = scale * LOG2E;
    p.safe = safe;
    const long long blocks = (long long)B * H
                             * (STREAM ? (p.n_qt + NCONS - 1) / NCONS : 1);
    attention_kernel<MODE, STREAM>
        <<<static_cast<unsigned>(blocks), NTHREADS,
           smem_bytes(STREAM, p.n_kc), stream>>>(maps[0], maps[1], maps[2],
                                                  p);
    return cudaGetLastError();
}

}  // namespace attn
}  // namespace
