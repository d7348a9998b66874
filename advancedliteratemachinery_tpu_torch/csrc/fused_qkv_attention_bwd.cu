// Backward of the fused multi-head self-attention straight off the qkv
// projection.
//
// Replaces the Pallas kernel `_fused_qkv_bwd_kernel` in
// advancedliteratemachinery_tpu/ops/attention.py (launched by
// `_fused_qkv_bwd`, the VJP of `fused_qkv_attention`). Inputs qkv
// [B, S, 3D] bf16 in the timm q|k|v layout and dO [B, S, D] bf16; output
// dqkv [B, S, 3D] bf16 in the same layout. Per head h, with the JAX
// kernel's rounding points:
//   qs = bf16(q * scale);  s = qs k^T (f32);  p = softmax(s) (f32, safe);
//   dV = bf16(p)^T dO;  dP = dO v^T (f32);  r = rowsum(dP * p) (f32);
//   dS = bf16(p * (dP - r));  dQ = (dS k) * scale;  dK = dS^T qs.
//
// What bounds it on an H100: at the MGP-STR-base train shape (B=128,
// S=257, D=768, H=12) it must read qkv and dO (354 MB with dqkv written:
// 0.106 ms at 3.35 TB/s) and do 10 B H S^2 64 = 65 GFLOP of products
// (0.066 ms at 989 TFLOP/s bf16): memory-bound, as long as no [S, S] tensor
// reaches memory. This first version recomputes instead of storing and
// never adds floats atomically, so it is deterministic:
//   row pass    a warp owns 16 query rows of one (batch, head), with the
//               head's K and V staged in shared memory (72-element rows, as
//               in the forward kernel). A first walk over the keys gives the
//               row's max, sum and rowsum(dP * p) by an online rescaling; a
//               second walk rebuilds p and dP, rounds dS and accumulates
//               dQ = dS K in registers. It writes dQ and, per row, the
//               log2-sum-exp and r for the column pass.
//   column pass a warp owns 16 keys, with the head's qs and dO and the row
//               statistics staged in shared memory. It walks the queries 32
//               at a time, rebuilds p^T and dP^T, and accumulates
//               dV = bf16(p)^T dO and dK = dS^T qs in registers.
// All products are mma.sync m16n8k16 (bf16 in, f32 accumulate); S is padded
// to 16-row tiles with the ragged rows zeroed. Scores are computed three
// times and dP three times (9 products of [S, S, 64] where the JAX kernel
// does 5): the cost of keeping the passes independent.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;           // head dim the kernel is written for
constexpr int ROWS = 16;         // query (row pass) or key (column pass) rows
                                 // per warp: one mma tile
constexpr int NWARPS = 9;        // tiles per block
constexpr int KB = 32;           // keys per step of the row pass
constexpr int QB = 32;           // queries per step of the column pass
constexpr int LDS = HD + 8;      // smem row pitch (bf16)
constexpr int MAX_SEQ = 768;     // two [768, 72] bf16 tiles fill 221 KB
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

// bf16(x * scale) for the eight values of a 16-byte chunk
__device__ __forceinline__ uint4 scale_chunk(uint4 v, float scale) {
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        h[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    return v;
}

// A fragments of the 16 x 64 tile at rows r0.. of a [S, ld] bf16 matrix
// (rows >= S zero), each value times `scale` and rounded when scale != 1
__device__ __forceinline__ void load_a_tile(uint32_t (*a)[4],
                                            const __nv_bfloat16* base,
                                            size_t ld, int r0, int S,
                                            int g, int t, float scale) {
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = r0 + g + (i & 1) * 8;
            const int c = ks * 16 + 2 * t + (i >> 1) * 8;
            uint32_t v = 0u;
            if (r < S) {
                v = *reinterpret_cast<const uint32_t*>(base + r * ld + c);
                if (scale != 1.f) {
                    const float2 f = __bfloat1622float2(
                        *reinterpret_cast<__nv_bfloat162*>(&v));
                    v = pack_bf16(f.x * scale, f.y * scale);
                }
            }
            a[ks][i] = v;
        }
    }
}

// acc[nt] = A (16 x 64, fragments a) times rows k0 + nt*8.. of a [.., LDS]
// smem matrix, transposed (scores against 8 keys or queries per tile);
// tiles at or past `left` stay zero
template <int NT>
__device__ __forceinline__ void scores(float (*acc)[4], uint32_t (*a)[4],
                                       const __nv_bfloat16* sm, int k0,
                                       int left, int lane) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
        if (nt * 8 < left) {
            const __nv_bfloat16* p =
                sm + (k0 + nt * 8 + lane % 8) * LDS + (lane / 8) * 8;
            uint32_t b[4];
            ldsm_x4(b, p);
            mma_bf16(acc[nt], a[0], b[0], b[1]);
            mma_bf16(acc[nt], a[1], b[2], b[3]);
            ldsm_x4(b, p + 32);
            mma_bf16(acc[nt], a[2], b[0], b[1]);
            mma_bf16(acc[nt], a[3], b[2], b[3]);
        }
    }
}

// out[0..7] += A (16 x 16*KS, fragments a) * rows r0.. of a [.., LDS] smem
// matrix (K, dO or qs as the B operand, 16 rows per k-step)
template <int KS>
__device__ __forceinline__ void accumulate(float (*out)[4],
                                           uint32_t (*a)[4],
                                           const __nv_bfloat16* sm, int r0,
                                           int left, int lane) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
        if (ks * 16 < left) {
            const __nv_bfloat16* row =
                sm + (r0 + ks * 16 + lane % 8 + ((lane / 8) & 1) * 8) * LDS
                + (lane / 16) * 8;
#pragma unroll
            for (int j = 0; j < HD / 16; ++j) {
                uint32_t b[4];
                ldsm_x4_trans(b, row + j * 16);
                mma_bf16(out[2 * j], a[ks], b[0], b[1]);
                mma_bf16(out[2 * j + 1], a[ks], b[2], b[3]);
            }
        }
    }
}

__global__ void __launch_bounds__(NWARPS * 32, 1)
bwd_rows_kernel(const __nv_bfloat16* __restrict__ qkv,
                const __nv_bfloat16* __restrict__ dout,
                __nv_bfloat16* __restrict__ dqkv,
                float* __restrict__ stats, int S, int H, int s_pad,
                float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Vs = Ks + s_pad * LDS;

    const int D = H * HD;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const size_t ld = 3 * (size_t)D;
    const __nv_bfloat16* base = qkv + (size_t)b * S * ld + h * HD;
    const __nv_bfloat16* dbase = dout + (size_t)b * S * D + h * HD;

    for (int i = threadIdx.x; i < s_pad * (HD / 8); i += blockDim.x) {
        const int r = i / (HD / 8), c = i % (HD / 8);
        uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
        if (r < S) {
            const __nv_bfloat16* rowp = base + r * ld;
            kv = reinterpret_cast<const uint4*>(rowp + D)[c];
            vv = reinterpret_cast<const uint4*>(rowp + 2 * D)[c];
        }
        *reinterpret_cast<uint4*>(Ks + r * LDS + c * 8) = kv;
        *reinterpret_cast<uint4*>(Vs + r * LDS + c * 8) = vv;
    }

    const int q0 = (blockIdx.x * NWARPS + warp) * ROWS;
    uint32_t qa[HD / 16][4], da[HD / 16][4];
    load_a_tile(qa, base, ld, q0, S, g, t, scale);     // qs = bf16(q*scale)
    load_a_tile(da, dbase, D, q0, S, g, t, 1.f);
    __syncthreads();
    if (q0 >= S) return;

    // walk 1: row max m (log2 units), per-thread partial sums l of
    // exp2(x - m) and rr of exp2(x - m) * dP, rescaled as m grows
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
          rr[2] = {0.f, 0.f};
    float s[KB / 8][4], dp[KB / 8][4];
    for (int k0 = 0; k0 < S; k0 += KB) {
        const int left = S - k0;
        scores<KB / 8>(s, qa, Ks, k0, left, lane);
        scores<KB / 8>(dp, da, Vs, k0, left, lane);
        float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = nt * 8 + 2 * t + (e & 1);
                const float x = key < left ? s[nt][e] * LOG2E : -INFINITY;
                s[nt][e] = x;
                bm[e >> 1] = fmaxf(bm[e >> 1], x);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
            bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
            const float m_new = fmaxf(m[r], bm[r]);
            const float alpha = ex2(m[r] - m_new);   // 0 on the first step
            m[r] = m_new;
            l[r] *= alpha;
            rr[r] *= alpha;
        }
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = ex2(s[nt][e] - m[e >> 1]);
                l[e >> 1] += p;
                rr[e >> 1] += p * dp[nt][e];
            }
        }
    }
    float lse[2], rs[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        rr[r] += __shfl_xor_sync(0xffffffffu, rr[r], 1);
        rr[r] += __shfl_xor_sync(0xffffffffu, rr[r], 2);
        lse[r] = m[r] + log2f(l[r]);
        rs[r] = rr[r] / l[r];
        const int q = q0 + g + 8 * r;
        if (t == 0 && q < S) {
            float* st = stats + (((size_t)b * H + h) * S + q) * 2;
            st[0] = lse[r];
            st[1] = rs[r];
        }
    }

    // walk 2: p = exp2(x - lse), dS = bf16(p (dP - r)), dQ += dS K
    float dq[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
        dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    for (int k0 = 0; k0 < S; k0 += KB) {
        const int left = S - k0;
        scores<KB / 8>(s, qa, Ks, k0, left, lane);
        scores<KB / 8>(dp, da, Vs, k0, left, lane);
        uint32_t dsa[KB / 16][4];
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = nt * 8 + 2 * t + (e & 1);
                const float p =
                    key < left ? ex2(s[nt][e] * LOG2E - lse[e >> 1]) : 0.f;
                ds[e] = p * (dp[nt][e] - rs[e >> 1]);
            }
            dsa[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
            dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        accumulate<KB / 16>(dq, dsa, Ks, k0, left, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int q = q0 + g + 8 * r;
        if (q < S) {
            __nv_bfloat16* row = dqkv + ((size_t)b * S + q) * ld + h * HD;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n)
                *reinterpret_cast<__nv_bfloat162*>(row + n * 8 + 2 * t) =
                    __floats2bfloat162_rn(dq[n][2 * r] * scale,
                                          dq[n][2 * r + 1] * scale);
        }
    }
}

__global__ void __launch_bounds__(NWARPS * 32, 1)
bwd_cols_kernel(const __nv_bfloat16* __restrict__ qkv,
                const __nv_bfloat16* __restrict__ dout,
                __nv_bfloat16* __restrict__ dqkv,
                const float* __restrict__ stats, int S, int H, int s_pad,
                float scale) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Os = Qs + s_pad * LDS;
    float* lse_s = reinterpret_cast<float*>(Os + s_pad * LDS);
    float* r_s = lse_s + s_pad;

    const int D = H * HD;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const size_t ld = 3 * (size_t)D;
    const __nv_bfloat16* base = qkv + (size_t)b * S * ld + h * HD;
    const __nv_bfloat16* dbase = dout + (size_t)b * S * D + h * HD;
    const float* st = stats + ((size_t)b * H + h) * S * 2;

    // qs = bf16(q * scale) and dO of this head; rows in [S, s_pad) are zero
    for (int i = threadIdx.x; i < s_pad * (HD / 8); i += blockDim.x) {
        const int r = i / (HD / 8), c = i % (HD / 8);
        uint4 qv = make_uint4(0, 0, 0, 0), ov = qv;
        if (r < S) {
            qv = scale_chunk(reinterpret_cast<const uint4*>(base + r * ld)[c],
                             scale);
            ov = reinterpret_cast<const uint4*>(dbase + (size_t)r * D)[c];
        }
        *reinterpret_cast<uint4*>(Qs + r * LDS + c * 8) = qv;
        *reinterpret_cast<uint4*>(Os + r * LDS + c * 8) = ov;
    }
    for (int r = threadIdx.x; r < S; r += blockDim.x) {
        lse_s[r] = st[2 * r];
        r_s[r] = st[2 * r + 1];
    }

    const int j0 = (blockIdx.x * NWARPS + warp) * ROWS;
    uint32_t ka[HD / 16][4], va[HD / 16][4];
    load_a_tile(ka, base + D, ld, j0, S, g, t, 1.f);
    load_a_tile(va, base + 2 * D, ld, j0, S, g, t, 1.f);
    __syncthreads();
    if (j0 >= S) return;

    float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
        dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
        dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
    }
    float s[QB / 8][4], dp[QB / 8][4];
    for (int i0 = 0; i0 < S; i0 += QB) {
        const int left = S - i0;
        scores<QB / 8>(s, ka, Qs, i0, left, lane);       // s^T: keys x queries
        scores<QB / 8>(dp, va, Os, i0, left, lane);      // dP^T
        uint32_t pa[QB / 16][4], dsa[QB / 16][4];
#pragma unroll
        for (int nt = 0; nt < QB / 8; ++nt) {
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int q = i0 + nt * 8 + 2 * t + (e & 1);
                p[e] = q < S ? ex2(s[nt][e] * LOG2E - lse_s[q]) : 0.f;
                ds[e] = q < S ? p[e] * (dp[nt][e] - r_s[q]) : 0.f;
            }
            pa[nt / 2][(nt % 2) * 2] = pack_bf16(p[0], p[1]);
            pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
            dsa[nt / 2][(nt % 2) * 2] = pack_bf16(ds[0], ds[1]);
            dsa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        accumulate<QB / 16>(dv, pa, Os, i0, left, lane);
        accumulate<QB / 16>(dk, dsa, Qs, i0, left, lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int j = j0 + g + 8 * r;
        if (j < S) {
            __nv_bfloat16* row = dqkv + ((size_t)b * S + j) * ld + h * HD;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n) {
                *reinterpret_cast<__nv_bfloat162*>(row + D + n * 8 + 2 * t) =
                    __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
                *reinterpret_cast<__nv_bfloat162*>(row + 2 * D + n * 8
                                                   + 2 * t) =
                    __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
            }
        }
    }
}

}  // namespace

extern "C" const char* alm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// qkv [B, S, 3*H*64], dout [B, S, H*64] bf16 -> dqkv [B, S, 3*H*64] bf16,
// on `stream`; stats is f32 scratch of B*H*S*2 values.
extern "C" int alm_fused_qkv_attention_bwd(const void* qkv, const void* dout,
                                           void* dqkv, void* stats, int B,
                                           int S, int H, float scale,
                                           void* stream) {
    if (S < 1 || S > MAX_SEQ || B < 1 || H < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int s_pad = (S + 15) / 16 * 16;
    const size_t tiles = 2 * (size_t)s_pad * LDS * sizeof(__nv_bfloat16);
    const size_t smem_cols = tiles + 2 * (size_t)s_pad * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(tiles));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(
        bwd_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_cols));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int n_tiles = (S + ROWS - 1) / ROWS;
    const dim3 grid((n_tiles + NWARPS - 1) / NWARPS, H, B);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* x = static_cast<const __nv_bfloat16*>(qkv);
    const auto* d = static_cast<const __nv_bfloat16*>(dout);
    auto* dx = static_cast<__nv_bfloat16*>(dqkv);
    auto* stat = static_cast<float*>(stats);
    bwd_rows_kernel<<<grid, NWARPS * 32, tiles, st>>>(x, d, dx, stat, S, H,
                                                       s_pad, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_cols_kernel<<<grid, NWARPS * 32, smem_cols, st>>>(x, d, dx, stat, S,
                                                          H, s_pad, scale);
    return static_cast<int>(cudaGetLastError());
}
