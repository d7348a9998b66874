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
// 8 x 256 vocab columns and writes one partial (max, argmax, sum-exp) per
// row and chunk; pass 2 merges the partials per row in chunk order. Every
// merge replaces the running max only when the new one is strictly greater,
// and the reductions inside a tile prefer the lower column on equal values,
// so ties go to the first index.
//
// What bounds it on an H100: at M=6656 (256 crops x 26 positions), D=768,
// V=50304 it needs 514 GFLOP of products (0.52 ms at 989 TFLOP/s bf16)
// against 91 MB of input (0.03 ms at 3.35 TB/s): compute-bound, and only
// wgmma reaches the tensor cores' full rate. Pass 1 is a warp-specialised
// wgmma GEMM. One producer thread keeps a 4-stage ring of shared-memory
// tiles full by TMA: per stage the token tile [128, 64] and the weight tile
// [256, 64], both K-major as stored, in the 128-byte swizzle wgmma reads,
// each stage tracked by a full and an empty mbarrier; rows past M or V
// arrive as zeros. Two consumer warpgroups (64 token rows each, 232
// registers a thread after setmaxnreg; the producer warpgroup keeps 40)
// run wgmma m64n256k16 over D in steps of 64 with 128 f32 accumulators a
// thread, so both share every weight tile (87 FLOP per byte staged).
//
// The epilogue runs on the accumulators in registers: add the f32 bias,
// mask columns >= true_vocab, and reduce each row's max, argmax and
// sum-exp across the quad of lanes that holds the row. Its 128 exp a
// thread per tile (335 M at M=6656 BPE) are hidden behind loads, not
// behind products: the producer runs on across the chunk's column tiles,
// so while the consumers reduce one tile the next tile's first four
// stages are already landing. Ping-pong between the consumer warpgroups
// (each on its own tile, the other one's epilogue under its products)
// would need separate stages per warpgroup, halve the tile that one stage
// feeds and raise the L2-to-shared traffic by a third; at this tile the
// epilogue costs about a sixth of the products' time at peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int BM = 128;           // token rows per block
constexpr int BN = 256;           // vocab columns per tile
constexpr int BK = 64;            // contraction step (one 128-byte row)
constexpr int STAGES = 4;
constexpr int TILES_PER_CHUNK = 8;
constexpr int NTHREADS = 384;     // producer warpgroup + 2 consumers
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int NACC = BN / 2;      // f32 accumulators a consumer thread
constexpr float NEG = -1e30f;     // masked column, as the TPU kernel's NEG

constexpr size_t SMEM_BYTES = 1024                 // alignment slack
                              + (size_t)STAGES * STAGE_BYTES
                              + TILES_PER_CHUNK * BN * sizeof(float)  // bias
                              + 2 * STAGES * sizeof(uint64_t);

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

// One 64 x 256 logits tile of a consumer warpgroup, in its accumulators:
// bias (the tile's 256 values in shared memory), mask (MASKED: some column
// >= true_vocab), then per row r (g, g + 8) the tile's max, first argmax
// and sum-exp, merged into the running state.
template <bool MASKED>
__device__ __forceinline__ void reduce_tile(float (&acc)[NACC],
                                            const float* tile_bias,
                                            int n0, int t, int true_vocab,
                                            float (&rm)[2], int (&ra)[2],
                                            float (&rs)[2]) {
#pragma unroll
    for (int j = 0; j < NACC / 4; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        const float2 bb =
            *reinterpret_cast<const float2*>(tile_bias + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            acc[4 * j + 2 * r] += bb.x;
            acc[4 * j + 2 * r + 1] += bb.y;
            if (MASKED) {
                if (col >= true_vocab) acc[4 * j + 2 * r] = NEG;
                if (col + 1 >= true_vocab) acc[4 * j + 2 * r + 1] = NEG;
            }
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float best = NEG;
        int arg = n0 + 2 * t;
#pragma unroll
        for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float x = acc[4 * j + 2 * r + e];
                if (x > best) {
                    best = x;
                    arg = n0 + 8 * j + 2 * t + e;
                }
            }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best, off);
            const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
            if (ob > best || (ob == best && oa < arg)) {
                best = ob;
                arg = oa;
            }
        }
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < NACC / 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                if (!MASKED || n0 + 8 * j + 2 * t + e < true_vocab)
                    s += __expf(acc[4 * j + 2 * r + e] - best);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        merge(rm[r], ra[r], rs[r], best, arg, s);
    }
}

__global__ void __launch_bounds__(NTHREADS, 1)
vocab_partial_kernel(__grid_constant__ const CUtensorMap tm_tok,
                     __grid_constant__ const CUtensorMap tm_w,
                     const float* __restrict__ bias,
                     float* __restrict__ part_m, int* __restrict__ part_a,
                     float* __restrict__ part_s,
                     int M, int D, int V, int true_vocab, int n_chunks) {
    extern __shared__ unsigned char smem_raw[];
    // 1024-byte aligned for the swizzled tiles; an offset from the shared
    // array keeps every access below a shared-memory (not generic) one
    unsigned char* ring = smem_raw + sm90::align1024_pad(smem_raw);
    float* sbias = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
    uint64_t* full = reinterpret_cast<uint64_t*>(sbias + TILES_PER_CHUNK * BN);
    uint64_t* empty = full + STAGES;

    const int m0 = blockIdx.x * BM;
    const int chunk = blockIdx.y;
    const int n_first = chunk * TILES_PER_CHUNK * BN;
    const int n_tiles = min(TILES_PER_CHUNK, (V - n_first + BN - 1) / BN);
    const int KT = D / BK;
    const int wg = threadIdx.x / 128;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            sm90::mbar_init(&full[s], 1);    // the producer's expect_tx
            sm90::mbar_init(&empty[s], 8);   // one arrival a consumer warp
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (wg == 0) {
        // producer: one thread issues every TMA load of the block
        sm90::setmaxnreg_dec<40>();
        if (threadIdx.x == 0) {
            const int steps = n_tiles * KT;
            for (int step = 0; step < steps; ++step) {
                const int slot = step % STAGES;
                sm90::mbar_wait(&empty[slot], ((step / STAGES) & 1) ^ 1);
                unsigned char* st = ring + slot * STAGE_BYTES;
                sm90::mbar_arrive_expect_tx(&full[slot], STAGE_BYTES);
                const int k0 = (step % KT) * BK;
                sm90::tma_load_2d(st, &tm_tok, &full[slot], k0, m0);
                sm90::tma_load_2d(st + A_BYTES, &tm_w, &full[slot], k0,
                                  n_first + (step / KT) * BN);
            }
        }
        return;
    }

    // consumers: warpgroup cw owns token rows cw*64 .. +63 of the tile
    sm90::setmaxnreg_inc<232>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int t = lane % 4;
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
    float rm[2] = {NEG, NEG}, rs[2] = {0.f, 0.f};
    int ra[2] = {0, 0};
    // the chunk's bias, zero past true_vocab, once for both warpgroups
    for (int i = threadIdx.x - 128; i < n_tiles * BN; i += 256) {
        const int col = n_first + i;
        sbias[i] = col < true_vocab ? bias[col] : 0.f;
    }
    sm90::named_bar_sync(1, 256);

    int step = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
        for (int k = 0; k < KT; ++k, ++step) {
            const int slot = step % STAGES;
            sm90::mbar_wait(&full[slot], (step / STAGES) & 1);
            const unsigned char* st = ring + slot * STAGE_BYTES;
            const uint64_t da = sm90::desc_sw128(st + cw * 64 * 128);
            const uint64_t db = sm90::desc_sw128(st + A_BYTES);
            sm90::fence_operands(acc);
            sm90::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
                sm90::wgmma_bf16<BN>(acc, da + 2 * kk, db + 2 * kk,
                                     (k | kk) != 0);
            sm90::wgmma_commit();
            sm90::fence_operands(acc);
            // the previous stage's products are done: hand its slot back
            sm90::wgmma_wait<1>();
            if (k > 0 && lane == 0)
                sm90::mbar_arrive(&empty[(step - 1) % STAGES]);
        }
        sm90::wgmma_wait<0>();
        sm90::fence_operands(acc);
        if (lane == 0) sm90::mbar_arrive(&empty[(step - 1) % STAGES]);

        const int n0 = n_first + tile * BN;
        const float* tile_bias = sbias + tile * BN;
        if (n0 + BN <= true_vocab)
            reduce_tile<false>(acc, tile_bias, n0, t, true_vocab, rm, ra, rs);
        else
            reduce_tile<true>(acc, tile_bias, n0, t, true_vocab, rm, ra, rs);
    }

    if (t == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = m0 + cw * 64 + warp * 16 + lane / 4 + 8 * r;
            if (row < M) {
                const size_t o = (size_t)row * n_chunks + chunk;
                part_m[o] = rm[r];
                part_a[o] = ra[r];
                part_s[o] = rs[r];
            }
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
// 64, true_vocab <= V, and tok and w 16-byte aligned (TMA).
extern "C" int alm_vocab_greedy_decode(const void* tok, const void* w,
                                       const void* bias, void* part_m,
                                       void* part_a, void* part_s, void* ids,
                                       void* pmax, int M, int D, int V,
                                       int true_vocab, void* stream) {
    if (M < 1 || D < BK || D % BK || true_vocab < 1 || true_vocab > V ||
        reinterpret_cast<uintptr_t>(tok) % 16 ||
        reinterpret_cast<uintptr_t>(w) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    const int n_chunks = alm_vocab_num_chunks(V);
    CUtensorMap tm_tok, tm_w;
    const cuuint64_t tok_dims[2] = {(cuuint64_t)D, (cuuint64_t)M};
    const cuuint64_t w_dims[2] = {(cuuint64_t)D, (cuuint64_t)V};
    const cuuint64_t pitch[1] = {(cuuint64_t)D * 2};
    const cuuint32_t tok_box[2] = {BK, BM};
    const cuuint32_t w_box[2] = {BK, BN};
    cudaError_t err = sm90::encode_tile_map(&tm_tok, 2, tok, tok_dims, pitch,
                                            tok_box);
    if (err == cudaSuccess)
        err = sm90::encode_tile_map(&tm_w, 2, w, w_dims, pitch, w_box);
    static unsigned configured = 0;
    if (err == cudaSuccess)
        err = sm90::once_per_device(configured, [] {
            return cudaFuncSetAttribute(
                vocab_partial_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(SMEM_BYTES));
        });
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    // token tiles vary fastest: the blocks in flight share a few chunks of
    // the weight in L2 and read it from memory about once
    const dim3 grid((M + BM - 1) / BM, n_chunks);
    vocab_partial_kernel<<<grid, NTHREADS, SMEM_BYTES, st>>>(
        tm_tok, tm_w, static_cast<const float*>(bias),
        static_cast<float*>(part_m), static_cast<int*>(part_a),
        static_cast<float*>(part_s), M, D, V, true_vocab, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    vocab_merge_kernel<<<(M + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(part_m), static_cast<const int*>(part_a),
        static_cast<const float*>(part_s), static_cast<int*>(ids),
        static_cast<float*>(pmax), M, n_chunks);
    return static_cast<int>(cudaGetLastError());
}
