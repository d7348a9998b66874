// Vocab-head matmul fused with greedy decode: the logits never reach memory.
//
// Replaces the Pallas kernel `_kernel` in
// advancedliteratemachinery_tpu/ops/vocab_decode.py (launched by
// `matmul_greedy_decode`). For tokens [M, D] bf16, the head weight [V, D]
// bf16 (nn.Linear layout, read as it is stored) and bias [V] f32 it returns,
// per row, the greedy id (argmax over columns < true_vocab, ties to the
// lowest column, as jnp.argmax) and the max softmax probability
// pmax = 1 / sum_j exp(l_j - max).
//
// On the TPU a sequential grid carried the running (max, argmax, sum-exp)
// across vocab tiles. Blocks on Hopper run in no order, so the work is two
// passes: pass 1 gives each block one 128-row token tile and a chunk of
// 8 x 128 vocab columns and writes one partial (max, argmax, sum-exp) per
// row and chunk; pass 2 merges the partials per row in chunk order. Every
// merge replaces the running max only when the new one is strictly greater,
// and the reductions inside a tile prefer the lower column on equal values,
// so ties go to the first index.
//
// What bounds it on an H100: at M=6656 (256 crops x 26 positions), D=768,
// V=50304 it needs 514 GFLOP of products (0.52 ms at 989 TFLOP/s bf16)
// against 91 MB of input (0.03 ms at 3.35 TB/s): compute-bound. Pass 1 is
// therefore a tensor-core GEMM main loop: eight warps (4 along M x 2 along
// N, 32 x 64 each) run mma.sync m16n8k16 (bf16 in, f32 accumulate) on
// fragments loaded by ldmatrix from a double-buffered cp.async ring of
// 128 x 64 token and weight tiles, and the ring runs on across the chunk's
// column tiles, so the next tile's loads are in flight during a tile's epilogue.
// The epilogue reduces the logits in registers (bias, mask, max/argmax and
// sum-exp per row across a quad of lanes, then across the two warps of a
// row through shared memory) and never stores them. wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;           // token rows per block
constexpr int BN = 128;           // vocab columns per tile
constexpr int BK = 64;            // contraction step
constexpr int LDS = BK + 8;       // smem row pitch: conflict-free ldmatrix
constexpr int STAGES = 2;         // double buffer (timed best with BK=64)
constexpr int TILES_PER_CHUNK = 8;
constexpr int NTHREADS = 256;     // 8 warps: 4 along M x 2 along N
constexpr float NEG = -1e30f;     // masked column, as the TPU kernel's NEG

constexpr size_t STAGE_ELEMS = (size_t)(BM + BN) * LDS;
constexpr size_t SMEM_BYTES =
    STAGES * STAGE_ELEMS * sizeof(__nv_bfloat16)   // A and B ring
    + 2 * BM * 3 * sizeof(float)                   // per-warp-column partials
    + BM * 3 * sizeof(float);                      // running max/arg/sum

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const int n = valid ? 16 : 0;   // 0 bytes read: the 16 bytes are zeroed
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
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

// (m, a, s) then (m2, a2, s2) from later columns: a strictly greater max wins
__device__ __forceinline__ void merge(float& m, int& a, float& s, float m2,
                                      int a2, float s2) {
    if (m2 > m) {
        s = s * __expf(m - m2) + s2;
        m = m2;
        a = a2;
    } else {
        s += s2 * __expf(m2 - m);
    }
}

__global__ void __launch_bounds__(NTHREADS, 2)
vocab_partial_kernel(const __nv_bfloat16* __restrict__ tok,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     float* __restrict__ part_m, int* __restrict__ part_a,
                     float* __restrict__ part_s,
                     int M, int D, int V, int true_vocab, int n_chunks) {
    extern __shared__ __align__(128) unsigned char smem[];
    __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
    float* red_m = reinterpret_cast<float*>(ring + STAGES * STAGE_ELEMS);
    float* red_s = red_m + 2 * BM;
    int* red_a = reinterpret_cast<int*>(red_s + 2 * BM);
    float* m_run = reinterpret_cast<float*>(red_a + 2 * BM);
    float* s_run = m_run + BM;
    int* a_run = reinterpret_cast<int*>(s_run + BM);

    const int m0 = blockIdx.y * BM;
    const int chunk = blockIdx.x;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int wm = warp / 2;      // rows wm*32 .. +31
    const int wn = warp % 2;      // columns wn*64 .. +63 of the tile
    const int g = lane / 4;
    const int t = lane % 4;

    const int n_first = chunk * TILES_PER_CHUNK * BN;
    const int n_tiles = min(TILES_PER_CHUNK, (V - n_first + BN - 1) / BN);
    const int KT = D / BK;
    const int steps = n_tiles * KT;

    for (int r = threadIdx.x; r < BM; r += NTHREADS) {
        m_run[r] = NEG;
        a_run[r] = 0;
        s_run[r] = 0.f;
    }

    // one ring slot: A = tokens [m0, m0+128) x [k0, k0+64), B = weight rows
    // [n0, n0+128) x [k0, k0+64); 16 bytes a copy
    auto load = [&](int step) {
        __nv_bfloat16* As = ring + (step % STAGES) * STAGE_ELEMS;
        __nv_bfloat16* Bs = As + BM * LDS;
        const int n0 = n_first + (step / KT) * BN;
        const int k0 = (step % KT) * BK;
#pragma unroll
        for (int i = 0; i < BM * BK / 8 / NTHREADS; ++i) {
            const int idx = threadIdx.x + i * NTHREADS;
            const int r = idx / (BK / 8), c = idx % (BK / 8);
            const bool va = m0 + r < M, vb = n0 + r < V;
            cp_async16(As + r * LDS + c * 8,
                       tok + (va ? (size_t)(m0 + r) * D + k0 + c * 8 : 0), va);
            cp_async16(Bs + r * LDS + c * 8,
                       w + (vb ? (size_t)(n0 + r) * D + k0 + c * 8 : 0), vb);
        }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < steps) load(s);
        cp_async_commit();
    }

    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
            acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] =
                acc[mi][ni][3] = 0.f;

    for (int step = 0; step < steps; ++step) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // slot `step` landed; slot `step - 1` is free
        if (step + STAGES - 1 < steps) load(step + STAGES - 1);
        cp_async_commit();

        const __nv_bfloat16* As = ring + (step % STAGES) * STAGE_ELEMS;
        const __nv_bfloat16* Bs = As + BM * LDS;
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
                ldsm_x4(a[mi], As + (wm * 32 + mi * 16 + lane % 8
                                     + ((lane / 8) & 1) * 8) * LDS
                                   + kk + (lane / 16) * 8);
#pragma unroll
            for (int nj = 0; nj < 4; ++nj) {
                // matrices: columns +0-7 / +8-15 x k +0-7 / +8-15
                uint32_t b[4];
                ldsm_x4(b, Bs + (wn * 64 + nj * 16 + lane % 8
                                 + (lane / 16) * 8) * LDS
                               + kk + ((lane / 8) & 1) * 8);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
                    mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
                }
            }
        }

        if (step % KT == KT - 1) {
            // epilogue of one 128 x 128 logits tile, in registers
            const int n0 = n_first + (step / KT) * BN + wn * 64;
            float bv[8][2];
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = n0 + ni * 8 + 2 * t + e;
                    bv[ni][e] = col < true_vocab ? bias[col] : 0.f;
                }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    float best = NEG;
                    int arg = n0 + 2 * t;
#pragma unroll
                    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                        for (int e = 0; e < 2; ++e) {
                            const int col = n0 + ni * 8 + 2 * t + e;
                            const float x = col < true_vocab
                                ? acc[mi][ni][2 * r + e] + bv[ni][e] : NEG;
                            acc[mi][ni][2 * r + e] = x;
                            if (x > best) { best = x; arg = col; }
                        }
#pragma unroll
                    for (int off = 1; off < 4; off <<= 1) {
                        const float ob =
                            __shfl_xor_sync(0xffffffffu, best, off);
                        const int oa =
                            __shfl_xor_sync(0xffffffffu, arg, off);
                        if (ob > best || (ob == best && oa < arg)) {
                            best = ob;
                            arg = oa;
                        }
                    }
                    float s = 0.f;
#pragma unroll
                    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                        for (int e = 0; e < 2; ++e)
                            if (n0 + ni * 8 + 2 * t + e < true_vocab)
                                s += __expf(acc[mi][ni][2 * r + e] - best);
                    s += __shfl_xor_sync(0xffffffffu, s, 1);
                    s += __shfl_xor_sync(0xffffffffu, s, 2);
                    if (t == 0) {
                        const int row = wm * 32 + mi * 16 + g + 8 * r;
                        red_m[wn * BM + row] = best;
                        red_a[wn * BM + row] = arg;
                        red_s[wn * BM + row] = s;
                    }
                }
            }
            __syncthreads();
            for (int row = threadIdx.x; row < BM; row += NTHREADS) {
                float m = m_run[row], s = s_run[row];
                int a = a_run[row];
                merge(m, a, s, red_m[row], red_a[row], red_s[row]);
                merge(m, a, s, red_m[BM + row], red_a[BM + row],
                      red_s[BM + row]);
                m_run[row] = m;
                a_run[row] = a;
                s_run[row] = s;
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 8; ++ni)
                    acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] =
                        acc[mi][ni][3] = 0.f;
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    for (int r = threadIdx.x; r < BM; r += NTHREADS) {
        if (m0 + r < M) {
            const size_t o = (size_t)(m0 + r) * n_chunks + chunk;
            part_m[o] = m_run[r];
            part_a[o] = a_run[r];
            part_s[o] = s_run[r];
        }
    }
}

__global__ void vocab_merge_kernel(const float* __restrict__ part_m,
                                   const int* __restrict__ part_a,
                                   const float* __restrict__ part_s,
                                   int* __restrict__ ids,
                                   float* __restrict__ pmax,
                                   int M, int n_chunks) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= M) return;
    float m = NEG, s = 0.f;
    int a = 0;
    for (int c = 0; c < n_chunks; ++c) {
        const size_t o = (size_t)r * n_chunks + c;
        merge(m, a, s, part_m[o], part_a[o], part_s[o]);
    }
    ids[r] = a;
    pmax[r] = 1.f / s;
}

}  // namespace

extern "C" const char* alm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Number of vocab chunks (partials per row) for a head of V columns.
extern "C" int alm_vocab_num_chunks(int V) {
    const int tiles = (V + BN - 1) / BN;
    return (tiles + TILES_PER_CHUNK - 1) / TILES_PER_CHUNK;
}

// tok [M, D] bf16, w [V, D] bf16, bias [V] f32 -> ids [M] i32, pmax [M] f32;
// part_* are [M, alm_vocab_num_chunks(V)] scratch. D must be a multiple of
// 64 and true_vocab <= V.
extern "C" int alm_vocab_greedy_decode(const void* tok, const void* w,
                                       const void* bias, void* part_m,
                                       void* part_a, void* part_s, void* ids,
                                       void* pmax, int M, int D, int V,
                                       int true_vocab, void* stream) {
    if (M < 1 || D < BK || D % BK || true_vocab < 1 || true_vocab > V)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_chunks = alm_vocab_num_chunks(V);
    cudaError_t err = cudaFuncSetAttribute(
        vocab_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const dim3 grid(n_chunks, (M + BM - 1) / BM);
    vocab_partial_kernel<<<grid, NTHREADS, SMEM_BYTES, st>>>(
        static_cast<const __nv_bfloat16*>(tok),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(bias), static_cast<float*>(part_m),
        static_cast<int*>(part_a), static_cast<float*>(part_s), M, D, V,
        true_vocab, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    vocab_merge_kernel<<<(M + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(part_m), static_cast<const int*>(part_a),
        static_cast<const float*>(part_s), static_cast<int*>(ids),
        static_cast<float*>(pmax), M, n_chunks);
    return static_cast<int>(cudaGetLastError());
}
