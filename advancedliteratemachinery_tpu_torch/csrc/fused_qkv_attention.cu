// Fused multi-head self-attention forward straight off the qkv projection.
//
// Replaces the Pallas kernel `_fused_qkv_kernel` in
// advancedliteratemachinery_tpu/ops/attention.py (launched by
// `fused_qkv_attention`). Input qkv [B, S, 3D] bf16 in the timm q|k|v
// layout, output [B, S, D] bf16: per head h, softmax(q_h k_h^T * scale) v_h
// with f32 scores, f32 softmax statistics and f32 accumulation; `safe`
// subtracts the row max before exp, unsafe skips it (Policy.unsafe_softmax).
// No transposed copy of q, k or v ever touches device memory.
//
// What bounds it on an H100: at MGP-STR-base shapes (B=256, S=257, D=768,
// H=12, hd=64) the kernel must read 303 MB and write 101 MB (0.12 ms at
// 3.35 TB/s) and do 52 GFLOP of products (0.05 ms at 989 TFLOP/s bf16), so
// it is memory-bound: it has to read qkv once and keep the [S, S] scores
// out of memory. The design: a block takes one (batch, head) and up to nine
// 16-row query tiles, one per warp (S=257: 17 tiles, two blocks per head).
// It stages the head's K and V in shared memory once; each warp keeps its
// Q tile in registers and walks the keys 64 at a time, flash-style: scores
// from mma.sync m16n8k16 (bf16 in, f32 accumulate) stay in registers, an
// online softmax rescales the running output, and the bf16 probabilities
// feed the P·V product straight from the score fragments. K fragments come
// by ldmatrix and V fragments by ldmatrix.trans, from rows padded to 72
// elements so that the eight rows of a load hit distinct banks. At S=257 a
// block needs 78 KB of shared memory, so two share an SM and one block's
// K/V load overlaps the other's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;           // head dim the kernel is written for
constexpr int ROWS = 16;         // query rows per warp (one mma tile)
constexpr int NWARPS = 9;        // query tiles per block
constexpr int KB = 64;           // keys per online-softmax step
constexpr int LDS = HD + 8;      // smem row pitch (bf16)
constexpr int MAX_SEQ = 768;     // K and V of 768 keys fill 221 KB
constexpr float LOG2E = 1.4426950408889634f;

size_t smem_bytes(int s_pad) {
    return 2 * (size_t)s_pad * LDS * sizeof(__nv_bfloat16);
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

__global__ void __launch_bounds__(NWARPS * 32, 2)
fused_qkv_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                           __nv_bfloat16* __restrict__ out,
                           int S, int H, int s_pad, float scale, int safe) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* Vs = Ks + s_pad * LDS;

    const int D = H * HD;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;       // fragment rows g and g + 8
    const int t = lane % 4;       // fragment columns 2t and 2t + 1
    const size_t row_stride = 3 * (size_t)D;
    const __nv_bfloat16* base = qkv + (size_t)b * S * row_stride + h * HD;

    // K and V of this head, 16 bytes a thread; rows in [S, s_pad) are zero
    for (int i = threadIdx.x; i < s_pad * (HD / 8); i += blockDim.x) {
        const int r = i / (HD / 8), c = i % (HD / 8);
        uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
        if (r < S) {
            const __nv_bfloat16* rowp = base + r * row_stride;
            kv = reinterpret_cast<const uint4*>(rowp + D)[c];
            vv = reinterpret_cast<const uint4*>(rowp + 2 * D)[c];
        }
        *reinterpret_cast<uint4*>(Ks + r * LDS + c * 8) = kv;
        *reinterpret_cast<uint4*>(Vs + r * LDS + c * 8) = vv;
    }

    // this warp's Q tile as A fragments; rows >= S are zero
    const int q0 = (blockIdx.x * NWARPS + warp) * ROWS;
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = q0 + g + (i & 1) * 8;
            const int c = ks * 16 + 2 * t + (i >> 1) * 8;
            qa[ks][i] = r < S ? *reinterpret_cast<const uint32_t*>(
                                    base + r * row_stride + c)
                              : 0u;
        }
    }
    __syncthreads();
    if (q0 >= S) return;

    const float sl2 = scale * LOG2E;     // scores in log2 units
    // running max (fixed at 0 when unsafe) and per-thread partial row sums
    // for rows g and g + 8
    float m[2] = {safe ? -INFINITY : 0.f, safe ? -INFINITY : 0.f};
    float l[2] = {0.f, 0.f};
    float o[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
        o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

    for (int k0 = 0; k0 < S; k0 += KB) {
        const int left = S - k0;         // valid keys from k0 on
        float s[KB / 8][4];
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
            s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
            if (nt * 8 < left) {
                // keys k0+nt*8..+7: matrices = d 0-7, 8-15, 16-23, 24-31
                const __nv_bfloat16* kp =
                    Ks + (k0 + nt * 8 + lane % 8) * LDS + (lane / 8) * 8;
                uint32_t kb[4];
                ldsm_x4(kb, kp);
                mma_bf16(s[nt], qa[0], kb[0], kb[1]);
                mma_bf16(s[nt], qa[1], kb[2], kb[3]);
                ldsm_x4(kb, kp + 32);
                mma_bf16(s[nt], qa[2], kb[0], kb[1]);
                mma_bf16(s[nt], qa[3], kb[2], kb[3]);
            }
        }
        // scale to log2 units, mask keys >= S, row max of this block
        float bm[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = nt * 8 + 2 * t + (e & 1);
                const float x = key < left ? s[nt][e] * sl2 : -INFINITY;
                s[nt][e] = x;
                bm[e >> 1] = fmaxf(bm[e >> 1], x);
            }
        }
        if (safe) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 1));
                bm[r] = fmaxf(bm[r], __shfl_xor_sync(0xffffffffu, bm[r], 2));
                const float m_new = fmaxf(m[r], bm[r]);
                const float alpha = ex2(m[r] - m_new);   // 0 on the first block
                m[r] = m_new;
                l[r] *= alpha;
#pragma unroll
                for (int n = 0; n < HD / 8; ++n) {
                    o[n][2 * r] *= alpha;
                    o[n][2 * r + 1] *= alpha;
                }
            }
        }
        // probabilities: f32 into the sums, bf16 A fragments for P·V (the
        // C layout of score tiles 2k, 2k+1 is the A layout of key step k)
        uint32_t pa[KB / 16][4];
#pragma unroll
        for (int nt = 0; nt < KB / 8; ++nt) {
            const float p0 = ex2(s[nt][0] - m[0]);
            const float p1 = ex2(s[nt][1] - m[0]);
            const float p2 = ex2(s[nt][2] - m[1]);
            const float p3 = ex2(s[nt][3] - m[1]);
            l[0] += p0 + p1;
            l[1] += p2 + p3;
            pa[nt / 2][(nt % 2) * 2] = pack_bf16(p0, p1);
            pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
        }
        // O += P V, 16 keys a step; x4.trans gives the B fragments of
        // d tiles 2j and 2j+1 (matrices: keys +0-7 / +8-15 x d +0-7 / +8-15)
#pragma unroll
        for (int ks = 0; ks < KB / 16; ++ks) {
            if (ks * 16 < left) {
                const __nv_bfloat16* vrow =
                    Vs + (k0 + ks * 16 + lane % 8 + ((lane / 8) & 1) * 8) * LDS
                    + (lane / 16) * 8;
#pragma unroll
                for (int j = 0; j < HD / 16; ++j) {
                    uint32_t vb[4];
                    ldsm_x4_trans(vb, vrow + j * 16);
                    mma_bf16(o[2 * j], pa[ks], vb[0], vb[1]);
                    mma_bf16(o[2 * j + 1], pa[ks], vb[2], vb[3]);
                }
            }
        }
    }

    // full row sums across the four threads of each row, then write out
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int q = q0 + g + 8 * r;
        if (q < S) {
            const float inv = 1.f / l[r];
            __nv_bfloat16* orow = out + ((size_t)b * S + q) * D + h * HD;
#pragma unroll
            for (int n = 0; n < HD / 8; ++n)
                *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
                    __floats2bfloat162_rn(o[n][2 * r] * inv,
                                          o[n][2 * r + 1] * inv);
        }
    }
}

}  // namespace

extern "C" const char* alm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// qkv [B, S, 3*H*64] bf16 -> out [B, S, H*64] bf16, on `stream`.
extern "C" int alm_fused_qkv_attention(const void* qkv, void* out, int B,
                                       int S, int H, float scale, int safe,
                                       void* stream) {
    if (S < 1 || S > MAX_SEQ || B < 1 || H < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int s_pad = (S + 15) / 16 * 16;
    const size_t smem = smem_bytes(s_pad);
    cudaError_t err = cudaFuncSetAttribute(
        fused_qkv_attention_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int q_tiles = (S + ROWS - 1) / ROWS;
    const dim3 grid((q_tiles + NWARPS - 1) / NWARPS, H, B);
    fused_qkv_attention_kernel<<<grid, NWARPS * 32, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(qkv),
        static_cast<__nv_bfloat16*>(out), S, H, s_pad, scale, safe);
    return static_cast<int>(cudaGetLastError());
}
