// Modulated deformable convolution (DCNv2) forward, stride 1, same-size
// output.
//
// Replaces the Pallas kernel `_kernel` in
// advancedliteratemachinery_tpu/ops/deform_conv_pallas.py (launched by
// `dcn_windowed_pallas`). Inputs x [B, H, W, Cin] bf16 (NHWC), offsets
// [B, H, W, K, 2] bf16 as (dy, dx), mask [B, H, W, K] bf16, weights
// [K, Cout, Cin] bf16 (tap-major, each tap's matrix in nn.Conv2d's
// [out, in] order), optional bias [Cout] bf16; output [B, H, W, Cout] bf16:
//
//   out(p) = sum_k W_k . mask_k(p) . bilinear(x, base_k(p) + offset_k(p))
//
// Sample coordinates and bilinear weights are f32 (from the bf16 offsets);
// each corner outside the image contributes zero, as the reference
// dcn_v2_im2col_cuda.cu `dmcn_im2col_bilinear` does. The kernel is exact
// for every offset: the TPU kernel's +-radius window, the sparse
// correction and the gather fallback around it are not needed here.
//
// What bounds it on an H100: at LORE's largest DCN shape (B=8, 192^2,
// 64 -> 64) the function must move 91 MB (0.027 ms at 3.35 TB/s) and do
// 21.7 GFLOP (0.022 ms at 989 TFLOP/s bf16); over the 16 DCN layers of a
// LORE forward the operations dominate (255 GFLOP). The irregular part is
// the gather: every output pixel reads 4 corners x 9 taps of Cin-vectors
// from wherever its offsets point. The design is a direct gather plus an
// implicit GEMM. A block takes 64 output pixels (flattened over B, H, W)
// and 64 output channels. For each tap it computes the 64 pixels' corner
// indices and weights once (mask folded in), then walks Cin 32 channels at
// a time: 128 threads gather the [64, 32] sample tile with 16-byte NHWC
// reads of each corner's channel vector, sum the corners in f32 and round
// the sample to bf16 into shared memory, stage the tap's [64, 32] weight
// tile beside it, and four warps contract them on tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate), each warp 16 pixels x 64 channels.
// The bias add and the bf16 store end the kernel. Ragged H, W (any pixel
// count), Cin and Cout are masked; Cin that is not a multiple of 8 takes
// scalar loads. Overlapping the gather with the products (cp.async, TMA,
// wgmma) is left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output pixels per block
constexpr int BN = 64;          // output channels per block
constexpr int BK = 32;          // input channels per step
constexpr int LDS = BK + 8;     // smem row pitch (bf16): conflict-free frags
constexpr int NTHREADS = 128;   // four warps, 16 pixel rows each
constexpr int VECS = BK / 8;    // 16-byte vectors per tile row

// d += a (16x16 row-major) * b (16x8 column-major); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void add_bf16x8(float* acc, uint4 v, float w) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        acc[2 * i] += f.x * w;
        acc[2 * i + 1] += f.y * w;
    }
}

// Eight channels [c, c + 8) of pixel `row` (a row of an [.., C] matrix),
// zero past C; 16-byte loads when VEC (C % 8 == 0, 16-byte aligned base).
template <bool VEC>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* __restrict__ p,
                                       size_t row, int c, int C) {
    if (VEC) {
        if (c < C)
            return *reinterpret_cast<const uint4*>(p + row * C + c);
        return make_uint4(0, 0, 0, 0);
    }
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
        v[i] = (c + i < C) ? p[row * C + c + i] : __float2bfloat16(0.f);
    return *reinterpret_cast<uint4*>(v);
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
deform_conv_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ offsets,
                   const __nv_bfloat16* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ w,
                   const __nv_bfloat16* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out,
                   int M, int H, int W, int Cin, int Cout, int kw, int K,
                   int pad, int dil) {
    __shared__ __align__(16) __nv_bfloat16 As[BM * LDS];
    __shared__ __align__(16) __nv_bfloat16 Bs[BN * LDS];
    __shared__ int tap_idx[BM][4];     // corner pixel index, -1 off-image
    __shared__ float tap_w[BM][4];     // corner weight x mask

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int g = lane / 4;       // fragment rows g and g + 8
    const int t = lane % 4;       // fragment columns 2t and 2t + 1
    const int m0 = blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int HW = H * W;

    float acc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

    for (int k = 0; k < K; ++k) {
        // this tap's bilinear corners for the block's pixels, in f32
        if (tid < BM) {
            const int p = m0 + tid;
            int idx[4] = {-1, -1, -1, -1};
            float cw[4] = {0.f, 0.f, 0.f, 0.f};
            if (p < M) {
                const int b = p / HW, rem = p % HW;
                const int oy = rem / W, ox = rem % W;
                const size_t pk = (size_t)p * K + k;
                const float dy = __bfloat162float(offsets[2 * pk]);
                const float dx = __bfloat162float(offsets[2 * pk + 1]);
                const float m = __bfloat162float(mask[pk]);
                const float ys = (float)(oy + (k / kw) * dil - pad) + dy;
                const float xs = (float)(ox + (k % kw) * dil - pad) + dx;
                // clamping keeps far-off samples off-image and in int range
                const float y0f = fminf(fmaxf(floorf(ys), -2.f), (float)H);
                const float x0f = fminf(fmaxf(floorf(xs), -2.f), (float)W);
                const float fy = ys - floorf(ys), fx = xs - floorf(xs);
                const int y0 = (int)y0f, x0 = (int)x0f;
                const float wy[2] = {1.f - fy, fy}, wx[2] = {1.f - fx, fx};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int yy = y0 + c / 2, xx = x0 + c % 2;
                    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
                        idx[c] = b * HW + yy * W + xx;
                        cw[c] = wy[c / 2] * wx[c % 2] * m;
                    }
                }
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                tap_idx[tid][c] = idx[c];
                tap_w[tid][c] = cw[c];
            }
        }
        __syncthreads();

        const __nv_bfloat16* wk = w + (size_t)k * Cout * Cin;
        for (int c0 = 0; c0 < Cin; c0 += BK) {
            // sample tile [BM, BK]: f32 corner sum, rounded once to bf16
            for (int v = tid; v < BM * VECS; v += NTHREADS) {
                const int r = v / VECS, c = c0 + (v % VECS) * 8;
                float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int pi = tap_idx[r][q];
                    if (pi >= 0) add_bf16x8(s, load8<VEC>(x, pi, c, Cin),
                                            tap_w[r][q]);
                }
                __align__(16) __nv_bfloat162 h[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    h[i] = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
                *reinterpret_cast<uint4*>(As + r * LDS + (v % VECS) * 8) =
                    *reinterpret_cast<uint4*>(h);
            }
            // weight tile [BN, BK] of tap k, zero past Cout and Cin
            for (int v = tid; v < BN * VECS; v += NTHREADS) {
                const int n = v / VECS, c = c0 + (v % VECS) * 8;
                uint4 val = make_uint4(0, 0, 0, 0);
                if (n0 + n < Cout) val = load8<VEC>(wk, n0 + n, c, Cin);
                *reinterpret_cast<uint4*>(Bs + n * LDS + (v % VECS) * 8) =
                    val;
            }
            __syncthreads();

            const __nv_bfloat16* arow = As + (warp * 16 + g) * LDS;
#pragma unroll
            for (int kk = 0; kk < BK; kk += 16) {
                uint32_t a[4];
                a[0] = *reinterpret_cast<const uint32_t*>(arow + kk + 2 * t);
                a[1] = *reinterpret_cast<const uint32_t*>(
                    arow + 8 * LDS + kk + 2 * t);
                a[2] = *reinterpret_cast<const uint32_t*>(
                    arow + kk + 2 * t + 8);
                a[3] = *reinterpret_cast<const uint32_t*>(
                    arow + 8 * LDS + kk + 2 * t + 8);
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                    const __nv_bfloat16* brow = Bs + (j * 8 + g) * LDS + kk;
                    mma_bf16(acc[j], a,
                             *reinterpret_cast<const uint32_t*>(brow + 2 * t),
                             *reinterpret_cast<const uint32_t*>(
                                 brow + 2 * t + 8));
                }
            }
            __syncthreads();
        }
    }

    // epilogue: round the sum to bf16, then add the bias in bf16, as the
    // JAX function does (`out + bias.astype(out.dtype)`)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const int p = m0 + warp * 16 + g + 8 * r;
        if (p >= M) continue;
        __nv_bfloat16* orow = out + (size_t)p * Cout;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int n = n0 + j * 8 + 2 * t + e;
                if (n >= Cout) continue;
                __nv_bfloat16 v = __float2bfloat16(acc[j][2 * r + e]);
                if (bias != nullptr)
                    v = __float2bfloat16(__bfloat162float(v) +
                                         __bfloat162float(bias[n]));
                orow[n] = v;
            }
        }
    }
}

}  // namespace

extern "C" const char* alm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Stride-1, same-size DCN on `stream`; `bias` may be null. The caller
// guarantees 2 * pad == dil * (kh - 1) == dil * (kw - 1).
extern "C" int alm_deform_conv(const void* x, const void* offsets,
                               const void* mask, const void* w,
                               const void* bias, void* out, int B, int H,
                               int W, int Cin, int Cout, int kh, int kw,
                               int pad, int dil, void* stream) {
    if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || kh < 1 || kw < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long m = (long long)B * H * W;
    if (m * Cout >= (1LL << 31) || m * kh * kw * 2 >= (1LL << 31))
        return static_cast<int>(cudaErrorInvalidValue);
    const int M = static_cast<int>(m);
    const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
    const bool vec = Cin % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* ob = static_cast<const __nv_bfloat16*>(offsets);
    const auto* mb = static_cast<const __nv_bfloat16*>(mask);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    const auto* bb = static_cast<const __nv_bfloat16*>(bias);
    auto* yb = static_cast<__nv_bfloat16*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (vec)
        deform_conv_kernel<true><<<grid, NTHREADS, 0, s>>>(
            xb, ob, mb, wb, bb, yb, M, H, W, Cin, Cout, kw, kh * kw, pad,
            dil);
    else
        deform_conv_kernel<false><<<grid, NTHREADS, 0, s>>>(
            xb, ob, mb, wb, bb, yb, M, H, W, Cin, Cout, kw, kh * kw, pad,
            dil);
    return static_cast<int>(cudaGetLastError());
}
