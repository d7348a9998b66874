// Per-(batch, head) softmax attention on separate q, k, v.
//
// Replaces the Pallas kernel `_mha_kernel` in
// advancedliteratemachinery_tpu/ops/attention.py (launched by
// `mha_short_seq`). q, k, v [B, S, H, 64] bf16, each read in place through
// its own (batch, row, head) strides, so a view of a qkv projection needs
// no transposed copy (the JAX wrapper transposes to BHSD around its
// kernel); output [B, S, H, 64] bf16, contiguous. With the JAX kernel's
// arithmetic: s = (q k^T) * scale in f32, safe softmax, the probabilities
// normalised and only then rounded to bf16 before the product with v.
//
// What bounds it on an H100: at B=128, S=257, H=12 it must read q, k, v and
// write o (202 MB: 0.060 ms at 3.35 TB/s) and do 4 B H S^2 64 = 26 GFLOP
// of products (0.026 ms at 989 TFLOP/s bf16): memory-bound; at S=1024 it
// is bound by the products. At S=1024 one head's K and V no longer fit in
// shared memory beside each other (1024 x 72 x 2 B x 2 = 295 KB > 227 KB),
// so the kernel streams them
// through shared memory 64 keys at a time. Because the probabilities are
// rounded after they are normalised, the row sum must be known before any
// of them: a first walk over K gives each row's max and sum (online), a
// second walk over K and V forms bf16(p) and accumulates p V in registers.
// A block holds eight 16-row query tiles, one per warp, and its eight warps
// load each 64-key tile together; q stays in registers as mma.sync
// m16n8k16 A fragments (bf16 in, f32 accumulate). K fragments come by
// ldmatrix and V fragments by ldmatrix.trans from 72-element rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;           // head dim the kernel is written for
constexpr int ROWS = 16;         // query rows per warp (one mma tile)
constexpr int NWARPS = 8;        // query tiles per block
constexpr int KB = 64;           // keys per shared-memory tile
constexpr int LDS = HD + 8;      // smem row pitch (bf16)
constexpr int MAX_SEQ = 1024;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16 row-major) * b (16x8 column-major); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    const uint32_t addr =
        static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
    const uint32_t addr =
        static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

struct Strides {          // elements, per (batch, row, head)
    long long b, s, h;
};

// rows k0..k0+KB-1 of one head of `src` into `dst` [KB][LDS]; rows >= S zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          Strides st, int k0, int S) {
    for (int i = threadIdx.x; i < KB * (HD / 8); i += blockDim.x) {
        const int r = i / (HD / 8), c = i % (HD / 8);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k0 + r < S)
            v = reinterpret_cast<const uint4*>(src + (k0 + r) * st.s)[c];
        *reinterpret_cast<uint4*>(dst + r * LDS + c * 8) = v;
    }
}

// scores of this warp's 16 queries against the KB keys in Ks, in log2
// units; keys at or past `left` are -inf
__device__ __forceinline__ void tile_scores(float (*s)[4],
                                            uint32_t (*qa)[4],
                                            const __nv_bfloat16* Ks,
                                            int left, int lane, float sl2) {
    const int t = lane % 4;
#pragma unroll
    for (int nt = 0; nt < KB / 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        if (nt * 8 < left) {
            const __nv_bfloat16* kp =
                Ks + (nt * 8 + lane % 8) * LDS + (lane / 8) * 8;
            uint32_t kb[4];
            ldsm_x4(kb, kp);
            mma_bf16(s[nt], qa[0], kb[0], kb[1]);
            mma_bf16(s[nt], qa[1], kb[2], kb[3]);
            ldsm_x4(kb, kp + 32);
            mma_bf16(s[nt], qa[2], kb[0], kb[1]);
            mma_bf16(s[nt], qa[3], kb[2], kb[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int key = nt * 8 + 2 * t + (e & 1);
            s[nt][e] = key < left ? s[nt][e] * sl2 : -INFINITY;
        }
    }
}

__global__ void __launch_bounds__(NWARPS * 32, 1)
mha_short_seq_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, Strides qs, Strides ks,
                     Strides vs, int S, int H, float scale) {
    __shared__ __align__(128) __nv_bfloat16 Ks[KB * LDS];
    __shared__ __align__(128) __nv_bfloat16 Vs[KB * LDS];

    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
    const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
    const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;

    const int q0 = (blockIdx.x * NWARPS + warp) * ROWS;
    const bool active = q0 < S;      // idle warps still load tiles
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = q0 + g + (i & 1) * 8;
            const int c = kk * 16 + 2 * t + (i >> 1) * 8;
            qa[kk][i] = r < S ? *reinterpret_cast<const uint32_t*>(
                                    qb + r * qs.s + c)
                              : 0u;
        }
    }

    const float sl2 = scale * LOG2E;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float s[KB / 8][4];
    // walk 1: row max and sum of exp2(x - max), online
    for (int k0 = 0; k0 < S; k0 += KB) {
        __syncthreads();
        load_tile(Ks, kb, ks, k0, S);
        __syncthreads();
        if (!active) continue;
        tile_scores(s, qa, Ks, S - k0, lane, sl2);
        float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
            bm[0] = fmaxf(bm[0], fmaxf(s[nt][0], s[nt][1]));
            bm[1] = fmaxf(bm[1], fmaxf(s[nt][2], s[nt][3]));
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
            bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
            const float m_new = fmaxf(m[r], bm[r]);
            l[r] *= ex2(m[r] - m_new);               // 0 on the first tile
            m[r] = m_new;
        }
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) l[e >> 1] += ex2(s[nt][e] - m[e >> 1]);
        }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
    }

    // walk 2: o += bf16(exp2(x - max) / sum) V
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    for (int k0 = 0; k0 < S; k0 += KB) {
        __syncthreads();
        load_tile(Ks, kb, ks, k0, S);
        load_tile(Vs, vb, vs, k0, S);
        __syncthreads();
        if (!active) continue;
        const int left = S - k0;
        tile_scores(s, qa, Ks, left, lane, sl2);
        uint32_t pa[KB / 16][4];
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
            pa[nt / 2][(nt % 2) * 2] =
                pack_bf16(ex2(s[nt][0] - m[0]) * inv[0],
                          ex2(s[nt][1] - m[0]) * inv[0]);
            pa[nt / 2][(nt % 2) * 2 + 1] =
                pack_bf16(ex2(s[nt][2] - m[1]) * inv[1],
                          ex2(s[nt][3] - m[1]) * inv[1]);
        }
#pragma unroll
        for (int kk = 0; kk < KB / 16; ++kk) {
            if (kk * 16 < left) {
                const __nv_bfloat16* vrow =
                    Vs + (kk * 16 + lane % 8 + ((lane / 8) & 1) * 8) * LDS
                    + (lane / 16) * 8;
#pragma unroll
                for (int j = 0; j < HD / 16; ++j) {
                    uint32_t vb4[4];
                    ldsm_x4_trans(vb4, vrow + j * 16);
                    mma_bf16(o[2 * j], pa[kk], vb4[0], vb4[1]);
                    mma_bf16(o[2 * j + 1], pa[kk], vb4[2], vb4[3]);
                }
            }
        }
    }
    if (!active) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int row = q0 + g + 8 * r;
        if (row < S) {
            __nv_bfloat16* orow =
                out + (((size_t)b * S + row) * H + h) * HD;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n)
                *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
                    __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
        }
    }
}

}  // namespace

extern "C" const char* alm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v [B, S, H, 64] bf16 (strides in elements: batch, row, head; the
// head dim contiguous) -> out [B, S, H, 64] bf16 contiguous, on `stream`.
extern "C" int alm_mha_short_seq(const void* q, const void* k, const void* v,
                                 void* out, long long qsb, long long qss,
                                 long long qsh, long long ksb, long long kss,
                                 long long ksh, long long vsb, long long vss,
                                 long long vsh, int B, int S, int H,
                                 float scale, void* stream) {
    if (S < 1 || S > MAX_SEQ || B < 1 || H < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int q_tiles = (S + ROWS - 1) / ROWS;
    const dim3 grid((q_tiles + NWARPS - 1) / NWARPS, H, B);
    mha_short_seq_kernel<<<grid, NWARPS * 32, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v),
        static_cast<__nv_bfloat16*>(out), Strides{qsb, qss, qsh},
        Strides{ksb, kss, ksh}, Strides{vsb, vss, vsh}, S, H, scale);
    return static_cast<int>(cudaGetLastError());
}
