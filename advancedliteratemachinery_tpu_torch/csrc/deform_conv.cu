// Modulated deformable convolution (DCNv2) forward, stride 1, same-size
// output.
//
// Replaces the Pallas kernel `_kernel` in
// advancedliteratemachinery_tpu/ops/deform_conv_pallas.py (launched by
// `dcn_windowed_pallas`). Inputs x [B, H, W, Cin] bf16 (NHWC), offsets
// [B, H, W, K, 2] bf16 as (dy, dx), mask [B, H, W, K] bf16, weights
// [K, Cout, Cin8] bf16 (tap-major, each tap's matrix in nn.Conv2d's
// [out, in] order, Cin padded with zeros to Cin8, the next multiple of 8),
// optional bias [Cout] bf16; output [B, H, W, Cout] bf16:
//
//   out(p) = sum_k W_k . mask_k(p) . bilinear(x, base_k(p) + offset_k(p))
//
// Sample coordinates and bilinear weights are f32 (from the bf16 offsets);
// each corner outside the image contributes zero, as the reference
// dcn_v2_im2col_cuda.cu `dmcn_im2col_bilinear` does. The mask is folded
// into the corner weights, each tap's sample is rounded to bf16 before the
// product, the products sum in f32, the sum is rounded to bf16 and the bias
// is added in bf16. The kernel is exact for every offset: the TPU kernel's
// +-radius window, the sparse correction and the gather fallback around it
// are not needed here.
//
// What bounds it on an H100: the gather. Every output pixel reads 4
// corners x 9 taps of Cin-vectors from wherever its offsets point: over
// the 16 DCN layers of a LORE forward about 12 GB of corner reads, mostly
// from L2 and L1, against 255 GFLOP of products (0.26 ms at 989 TFLOP/s)
// and 0.285 ms of compulsory memory traffic. The design is a warp-
// specialised implicit GEMM with a gathered A operand:
//
// - A block owns an 8 x 16 tile of output pixels of one image (128 rows
//   of the product; a 2-D tile, so that neighbouring pixels' corners meet
//   in L1) and N = 64, 128 or 256 output channels, the smallest that
//   covers Cout (more column blocks only past 256), so each sample is
//   gathered once.
// - Two producer warpgroups (at N = 256 they hand registers to the
//   consumers' accumulators by setmaxnreg) first compute the corner byte
//   offsets and mask-folded weights of all nine taps for the 128 pixels
//   into a shared table, every offset and mask load in flight together.
//   Then, 64 input channels at a time and the nine taps inside (the taps
//   of one channel chunk read overlapping corners, which stay in L1), they
//   gather the [128, 64] bf16 sample tile with 16-byte NHWC loads, the
//   corners of two or four pixels a thread in flight together, and write
//   it in wgmma's 128-byte-swizzled K-major layout into a 2-stage ring.
//   They fence the async proxy and arrive on the stage's full barrier
//   (one arrival a warp).
// - The tap's weight tile [N, 64] arrives on the same barrier by TMA from
//   the [K, Cout, Cin8] array; rows past Cout and columns past Cin arrive
//   as zeros.
// - Two consumer warpgroups (64 pixels each) run wgmma m64nNk16 on each
//   stage and hand it back through its empty barrier. At N = 256 that is
//   two m64n128k16 on the halves of the weight tile: a 512-thread block
//   caps a thread at 128 registers, below the 154 that one m64n256k16
//   instruction needs, even where setmaxnreg grants more.
// - The epilogue rounds, adds the bias and stages each warp's rows through
//   the drained ring so that the stores are 16 bytes wide and coalesced.
// - Shared memory stays small (87 KB a block at N = 64, 103 KB at 128,
//   136 KB at 256) and the carveout asks for no more, leaving the rest of
//   the SM to L1. At N = 64 two blocks share an SM (64 registers a
//   thread), so that one block's table, ring fill and epilogue overlap the
//   other's gather.
//
// Cin that is not a multiple of 8 takes scalar loads in the gather; pixels
// of a tile past the image's edge are masked in the epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int BM = 128;          // output pixels per block: a tile of
constexpr int TH = 8;            // TH rows x TW columns of one image,
constexpr int TW = 16;           // so that neighbouring samples share L1
constexpr int BK = 64;           // input channels per stage
constexpr int A_BYTES = BM * BK * 2;
constexpr int TAPS = 9;          // taps whose corner tables are held at once
constexpr int STG_PITCH = 144;   // epilogue staging row (bytes): 72 bf16,
                                 // conflict-free bf16x2 writes

constexpr int NTHREADS = 512;    // 2 producer + 2 consumer warpgroups
constexpr int NPRODUCER = 256;
constexpr int ITEMS = BM * (BK / 8) / NPRODUCER;   // 16-byte vectors a thread
constexpr int STAGES = 2;        // the gather is the slow side: deeper rings
                                 // (3-6 stages) timed no faster

template <int N>
struct Cfg {
    // N = 64 (the layers with the least product work per gathered byte):
    // two blocks an SM, so one block's start and epilogue overlap the
    // other's gather, at 64 registers a thread
    static constexpr int BLOCKS_PER_SM = N == 64 ? 2 : 1;
    // pixels whose corner loads a producer thread keeps in flight together:
    // 4 x G 16-byte registers of the 64 (N = 64), 128 (N = 128) or 88
    // (N = 256, after setmaxnreg) it has
    static constexpr int G = N == 128 ? 4 : 2;
    static constexpr int B_BYTES = N * BK * 2;
    static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
    static constexpr size_t SMEM_BYTES =
        1024 + (size_t)STAGES * STAGE_BYTES
        + TAPS * BM * (sizeof(int4) + sizeof(float4))   // corner tables
        + 2 * STAGES * sizeof(uint64_t);
    static_assert(8 * 16 * STG_PITCH <= STAGE_BYTES, "staging fits a stage");
};

// two f32 rounded to bf16, packed low then high, in one register
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// acc (+)= w * the eight bf16 of v, in f32 (FIRST: acc = w * v)
template <bool FIRST>
__device__ __forceinline__ void fma_bf16x8(float* acc, uint4 v, float w) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        acc[2 * i] = FIRST ? f.x * w : acc[2 * i] + f.x * w;
        acc[2 * i + 1] = FIRST ? f.y * w : acc[2 * i + 1] + f.y * w;
    }
}

// Eight channels [c, c + 8) of the pixel `off` bytes past xc = x + c (off
// < 0: a corner off the image), zero past C; one 16-byte load when VEC
// (C % 8 == 0, 16-byte aligned x), where the caller checked c < C.
template <bool VEC>
__device__ __forceinline__ uint4 load8(const unsigned char* xc, int off,
                                       int c, int C) {
    if (off < 0) return make_uint4(0, 0, 0, 0);
    if (VEC) return __ldg(reinterpret_cast<const uint4*>(xc + off));
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(xc + off);
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint32_t lo =
            c + 2 * i < C ? __bfloat16_as_ushort(p[2 * i]) : 0u;
        const uint32_t hi =
            c + 2 * i + 1 < C ? __bfloat16_as_ushort(p[2 * i + 1]) : 0u;
        u[i] = lo | (hi << 16);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
}

template <int N, bool VEC>
__global__ void __launch_bounds__(NTHREADS, Cfg<N>::BLOCKS_PER_SM)
deform_conv_kernel(__grid_constant__ const CUtensorMap tm_w,
                   const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ offsets,
                   const __nv_bfloat16* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out,
                   int H, int W, int Cin, int Cout, int kw, int K, int pad,
                   int dil, int tiles_x, int tiles_y) {
    using C = Cfg<N>;
    extern __shared__ unsigned char smem_raw[];
    // 1024-byte aligned for the swizzled tiles; an offset from the shared
    // array keeps every access below a shared-memory (not generic) one
    unsigned char* ring = smem_raw + sm90::align1024_pad(smem_raw);
    // corner byte offsets and weights, [TAPS][BM]
    int4* tap_idx = reinterpret_cast<int4*>(ring + STAGES * C::STAGE_BYTES);
    float4* tap_w = reinterpret_cast<float4*>(tap_idx + TAPS * BM);
    uint64_t* full = reinterpret_cast<uint64_t*>(tap_w + TAPS * BM);
    uint64_t* empty = full + STAGES;

    // this block's tile: image b, rows y0t .. +TH, columns x0t .. +TW; its
    // pixel r is (y0t + r / TW, x0t + r % TW)
    const int tx = blockIdx.x % tiles_x;
    const int ty = (blockIdx.x / tiles_x) % tiles_y;
    const int b = blockIdx.x / (tiles_x * tiles_y);
    const int y0t = ty * TH, x0t = tx * TW;
    const int n0 = blockIdx.y * N;
    const int NC = (Cin + BK - 1) / BK;
    const int steps = K * NC;
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            // one arrival a producer warp + the weight load's expect_tx
            sm90::mbar_init(&full[s], NPRODUCER / 32 + 1);
            sm90::mbar_init(&empty[s], 8);   // one a consumer warp
        }
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (wg < 2) {
        // ---- producers: corner tables, the gather, the weight loads ----
        // at N = 256 the producers give registers to the consumers' 128
        // accumulators a thread (512 x 128 = 256 x 88 + 256 x 168)
        if constexpr (N == 256) sm90::setmaxnreg_dec<88>();
        const int ptid = threadIdx.x;
        const int HW = H * W;
        int step = 0;
        const int v = ptid % 8;              // 16-byte chunk of a tile row
        const int rbase = ptid / 8;
        const int NP = NPRODUCER;
        for (int k0 = 0; k0 < K; k0 += TAPS) {
            const int nk = min(TAPS, K - k0);
            // everyone is done with the previous group's tables
            if (k0 > 0) sm90::named_bar_sync(1, NP);
            // the four bilinear corners of taps k0 .. k0 + nk - 1 for the
            // block's pixels: byte offsets into x (-1 off the image) and
            // f32 weights with the mask folded in. Each thread's offset and
            // mask loads are all issued before the first is used
            // (neighbouring threads take neighbouring taps of one pixel).
            constexpr int TE = (TAPS * BM + NPRODUCER - 1) / NPRODUCER;
            __nv_bfloat162 dyx[TE];
            __nv_bfloat16 mk[TE];
#pragma unroll
            for (int i = 0; i < TE; ++i) {
                const int e = ptid + i * NP;
                const int row = e / nk, k = k0 + e % nk;
                const int oy = y0t + row / TW, ox = x0t + row % TW;
                dyx[i] = __floats2bfloat162_rn(0.f, 0.f);
                mk[i] = __float2bfloat16(0.f);
                if (e < nk * BM && oy < H && ox < W) {
                    const size_t pk = ((size_t)b * HW + oy * W + ox) * K + k;
                    dyx[i] = reinterpret_cast<const __nv_bfloat162*>(
                        offsets)[pk];
                    mk[i] = mask[pk];
                }
            }
#pragma unroll
            for (int i = 0; i < TE; ++i) {
                const int e = ptid + i * NP;
                if (e >= nk * BM) break;
                const int row = e / nk, kk = e % nk, k = k0 + kk;
                const int oy = y0t + row / TW, ox = x0t + row % TW;
                int idx[4] = {-1, -1, -1, -1};
                float cw[4] = {0.f, 0.f, 0.f, 0.f};
                if (oy < H && ox < W) {
                    const float dy = __low2float(dyx[i]);
                    const float dx = __high2float(dyx[i]);
                    const float m = __bfloat162float(mk[i]);
                    const float ys = (float)(oy + (k / kw) * dil - pad) + dy;
                    const float xs = (float)(ox + (k % kw) * dil - pad) + dx;
                    // clamping keeps far-off samples off-image and in int
                    // range
                    const float y0f = fminf(fmaxf(floorf(ys), -2.f),
                                            (float)H);
                    const float x0f = fminf(fmaxf(floorf(xs), -2.f),
                                            (float)W);
                    const float fy = ys - floorf(ys), fx = xs - floorf(xs);
                    const int y0 = (int)y0f, x0 = (int)x0f;
                    const float wy[2] = {1.f - fy, fy};
                    const float wx[2] = {1.f - fx, fx};
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const int yy = y0 + c / 2, xx = x0 + c % 2;
                        if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
                            idx[c] = (b * HW + yy * W + xx) * Cin * 2;
                            cw[c] = wy[c / 2] * wx[c % 2] * m;
                        }
                    }
                }
                tap_idx[kk * BM + row] =
                    make_int4(idx[0], idx[1], idx[2], idx[3]);
                tap_w[kk * BM + row] = make_float4(cw[0], cw[1], cw[2], cw[3]);
            }
            sm90::named_bar_sync(1, NP);

            // channel chunks outside, taps inside: the nine taps of one
            // chunk read overlapping corners, which stay in L1
            for (int c0 = 0; c0 < Cin; c0 += BK) {
                for (int kk = 0; kk < nk; ++kk, ++step) {
                    const int slot = step % STAGES;
                    sm90::mbar_wait(&empty[slot], ((step / STAGES) & 1) ^ 1);
                    unsigned char* st = ring + slot * C::STAGE_BYTES;
                    if (ptid == 0) {
                        sm90::mbar_arrive_expect_tx(&full[slot], C::B_BYTES);
                        sm90::tma_load_3d(st + A_BYTES, &tm_w, &full[slot],
                                          c0, n0, k0 + kk);
                    }
                    const int ch = c0 + v * 8;
                    const unsigned char* xc =
                        reinterpret_cast<const unsigned char*>(x + ch);
                    // a 16-byte vector is wholly in or past Cin
                    const bool live = !VEC || ch < Cin;
                    // G pixels at a time: their 4G corner loads are all in
                    // flight before the first sum
#pragma unroll
                    for (int i0 = 0; i0 < ITEMS; i0 += C::G) {
                        int4 id[C::G];
                        float4 cw[C::G];
                        uint4 q[C::G][4];
#pragma unroll
                        for (int i = 0; i < C::G; ++i) {
                            const int r = rbase + (i0 + i) * (NPRODUCER / 8);
                            id[i] = tap_idx[kk * BM + r];
                            cw[i] = tap_w[kk * BM + r];
                        }
#pragma unroll
                        for (int i = 0; i < C::G; ++i) {
                            if (!live) id[i] = make_int4(-1, -1, -1, -1);
                            q[i][0] = load8<VEC>(xc, id[i].x, ch, Cin);
                            q[i][1] = load8<VEC>(xc, id[i].y, ch, Cin);
                            q[i][2] = load8<VEC>(xc, id[i].z, ch, Cin);
                            q[i][3] = load8<VEC>(xc, id[i].w, ch, Cin);
                        }
#pragma unroll
                        for (int i = 0; i < C::G; ++i) {
                            const int r = rbase + (i0 + i) * (NPRODUCER / 8);
                            // f32 corner sum, rounded once to bf16
                            float s[8];
                            fma_bf16x8<true>(s, q[i][0], cw[i].x);
                            fma_bf16x8<false>(s, q[i][1], cw[i].y);
                            fma_bf16x8<false>(s, q[i][2], cw[i].z);
                            fma_bf16x8<false>(s, q[i][3], cw[i].w);
                            *reinterpret_cast<uint4*>(
                                st + sm90::sw128_offset(r, v)) = make_uint4(
                                pack_bf16x2(s[0], s[1]),
                                pack_bf16x2(s[2], s[3]),
                                pack_bf16x2(s[4], s[5]),
                                pack_bf16x2(s[6], s[7]));
                        }
                    }
                    sm90::fence_proxy_async();
                    __syncwarp();
                    if (lane == 0) sm90::mbar_arrive(&full[slot]);
                }
            }
        }
        return;
    }

    // ---- consumers: warpgroup cw owns pixels cw*64 .. +63 of the block --
    if constexpr (N == 256) sm90::setmaxnreg_inc<168>();
    const int cw = wg - 2;
    const int warp = (threadIdx.x % 128) / 32;
    const int g = lane / 4, t = lane % 4;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    for (int step = 0; step < steps; ++step) {
        const int slot = step % STAGES;
        sm90::mbar_wait(&full[slot], (step / STAGES) & 1);
        const unsigned char* st = ring + slot * C::STAGE_BYTES;
        const uint64_t da = sm90::desc_sw128(st + cw * 64 * 128);
        const uint64_t db = sm90::desc_sw128(st + A_BYTES);
        sm90::fence_operands(acc);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
            if constexpr (N == 256)     // 512 threads: at most 128 a thread
                sm90::wgmma_m64n256k16_2x128(acc, da + 2 * kk, db + 2 * kk,
                                             (step | kk) != 0);
            else
                sm90::wgmma_bf16<N>(acc, da + 2 * kk, db + 2 * kk,
                                    (step | kk) != 0);
        sm90::wgmma_commit();
        sm90::fence_operands(acc);
        sm90::wgmma_wait<1>();
        if (step > 0 && lane == 0)
            sm90::mbar_arrive(&empty[(step - 1) % STAGES]);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_operands(acc);
    // both consumer warpgroups are past their last product: every stage has
    // been written and read, and the epilogue may stage in the ring
    sm90::named_bar_sync(2, 256);

    // epilogue: round the sum to bf16, then add the bias in bf16, as the
    // JAX function does (`out + bias.astype(out.dtype)`); each warp stages
    // its 16 rows x 64 columns at a time and stores 16-byte row pieces
    unsigned char* stg = ring + (cw * 4 + warp) * 16 * STG_PITCH;
    const int row0 = cw * 64 + warp * 16;
    const bool vec_out = (Cout & 7) == 0;
#pragma unroll
    for (int cb = 0; cb < N / 64; ++cb) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int jj = cb * 8 + j;
            const int n = n0 + jj * 8 + 2 * t;
            float b0 = 0.f, b1 = 0.f;
            if (bias != nullptr) {
                if (n < Cout) b0 = __bfloat162float(bias[n]);
                if (n + 1 < Cout) b1 = __bfloat162float(bias[n + 1]);
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                float v0 = __bfloat162float(
                    __float2bfloat16(acc[4 * jj + 2 * r]));
                float v1 = __bfloat162float(
                    __float2bfloat16(acc[4 * jj + 2 * r + 1]));
                if (bias != nullptr) {
                    v0 += b0;
                    v1 += b1;
                }
                *reinterpret_cast<__nv_bfloat162*>(
                    stg + (g + 8 * r) * STG_PITCH + (j * 8 + 2 * t) * 2) =
                    __floats2bfloat162_rn(v0, v1);
            }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int item = lane + 32 * i;
            const int row = item / 8, vv = item % 8;
            const int oy = y0t + (row0 + row) / TW;
            const int ox = x0t + (row0 + row) % TW;
            const int n = n0 + cb * 64 + vv * 8;
            if (oy >= H || ox >= W || n >= Cout) continue;
            const size_t p = ((size_t)b * H + oy) * W + ox;
            const uint4 val = *reinterpret_cast<const uint4*>(
                stg + row * STG_PITCH + vv * 16);
            __nv_bfloat16* dst = out + p * Cout + n;
            if (vec_out) {
                *reinterpret_cast<uint4*>(dst) = val;
            } else {
                const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(
                    stg + row * STG_PITCH + vv * 16);
                for (int q = 0; q < 8 && n + q < Cout; ++q) dst[q] = e[q];
            }
        }
        __syncwarp();
    }
}

template <int N, bool VEC>
cudaError_t launch(const CUtensorMap& tm_w, const __nv_bfloat16* x,
                   const __nv_bfloat16* offsets, const __nv_bfloat16* mask,
                   const __nv_bfloat16* bias, __nv_bfloat16* out, int B,
                   int H, int W, int Cin, int Cout, int kw, int K, int pad,
                   int dil, cudaStream_t s) {
    using C = Cfg<N>;
    static unsigned configured = 0;
    const cudaError_t err = sm90::once_per_device(configured, [] {
        cudaError_t e = cudaFuncSetAttribute(
            deform_conv_kernel<N, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(C::SMEM_BYTES));
        // ask for no more shared memory than the blocks of an SM use: the
        // rest of the SM's 256 KB stays L1, which caches the gather's
        // corners
        const int pct = static_cast<int>(
            (C::BLOCKS_PER_SM * (C::SMEM_BYTES + 1024) * 100 + 228 * 1024 - 1)
            / (228 * 1024));
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                deform_conv_kernel<N, VEC>,
                cudaFuncAttributePreferredSharedMemoryCarveout, pct);
        return e;
    });
    if (err != cudaSuccess) return err;
    const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
    const dim3 grid(B * tiles_y * tiles_x, (Cout + N - 1) / N);
    deform_conv_kernel<N, VEC><<<grid, NTHREADS, C::SMEM_BYTES, s>>>(
        tm_w, x, offsets, mask, bias, out, H, W, Cin, Cout, kw, K, pad, dil,
        tiles_x, tiles_y);
    return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(bool vec, const CUtensorMap& tm_w,
                     const __nv_bfloat16* x, const __nv_bfloat16* offsets,
                     const __nv_bfloat16* mask, const __nv_bfloat16* bias,
                     __nv_bfloat16* out, int B, int H, int W, int Cin,
                     int Cout, int kw, int K, int pad, int dil,
                     cudaStream_t s) {
    if (vec)
        return launch<N, true>(tm_w, x, offsets, mask, bias, out, B, H, W,
                               Cin, Cout, kw, K, pad, dil, s);
    return launch<N, false>(tm_w, x, offsets, mask, bias, out, B, H, W, Cin,
                            Cout, kw, K, pad, dil, s);
}

}  // namespace

extern "C" const char* alm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Stride-1, same-size DCN on `stream`; `bias` may be null; `w` is
// [kh * kw, Cout, Cin8] with Cin8 = Cin rounded up to a multiple of 8 and
// 16-byte aligned (TMA); `offsets` is 4-byte aligned (read as (dy, dx)
// pairs) and `out` 16-byte aligned. The caller guarantees
// 2 * pad == dil * (kh - 1) == dil * (kw - 1).
extern "C" int alm_deform_conv(const void* x, const void* offsets,
                               const void* mask, const void* w,
                               const void* bias, void* out, int B, int H,
                               int W, int Cin, int Cout, int kh, int kw,
                               int pad, int dil, void* stream) {
    if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || kh < 1 || kw < 1 ||
        reinterpret_cast<uintptr_t>(w) % 16 ||
        reinterpret_cast<uintptr_t>(out) % 16 ||
        reinterpret_cast<uintptr_t>(offsets) % 4)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long m = (long long)B * H * W;
    if (m * Cout >= (1LL << 31) || m * kh * kw * 2 >= (1LL << 31) ||
        m * Cin * 2 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const int K = kh * kw;
    const int cin8 = (Cin + 7) / 8 * 8;
    const int N = Cout <= 64 ? 64 : (Cout <= 128 ? 128 : 256);
    CUtensorMap tm_w;
    const cuuint64_t dims[3] = {(cuuint64_t)cin8, (cuuint64_t)Cout,
                                (cuuint64_t)K};
    const cuuint64_t strides[2] = {(cuuint64_t)cin8 * 2,
                                   (cuuint64_t)cin8 * Cout * 2};
    const cuuint32_t box[3] = {BK, (cuuint32_t)N, 1};
    cudaError_t err = sm90::encode_tile_map(&tm_w, 3, w, dims, strides, box);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool vec = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* ob = static_cast<const __nv_bfloat16*>(offsets);
    const auto* mb = static_cast<const __nv_bfloat16*>(mask);
    const auto* bb = static_cast<const __nv_bfloat16*>(bias);
    auto* yb = static_cast<__nv_bfloat16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (N == 64)
        err = launch_n<64>(vec, tm_w, xb, ob, mb, bb, yb, B, H, W, Cin, Cout,
                           kw, K, pad, dil, s);
    else if (N == 128)
        err = launch_n<128>(vec, tm_w, xb, ob, mb, bb, yb, B, H, W, Cin, Cout,
                            kw, K, pad, dil, s);
    else
        err = launch_n<256>(vec, tm_w, xb, ob, mb, bb, yb, B, H, W, Cin, Cout,
                            kw, K, pad, dil, s);
    return static_cast<int>(err);
}
