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
// S=257, D=768, H=12) it must read qkv and dO and write dqkv (354 MB:
// 0.106 ms at 3.35 TB/s) and do 10 B H S^2 64 = 65 GFLOP of products
// (0.066 ms at 989 TFLOP/s bf16): memory-bound, as long as no [S, S]
// tensor reaches memory. dQ sums over keys and dK, dV over queries, and
// no float is ever added atomically (the same inputs give the same bits),
// so the kernel makes two passes over each (batch, head), both on the
// operand forms of the attention core (sm90_attention.cuh):
//   row pass    (dQ) a consumer warpgroup owns a 64-row tile of Q and dO;
//               the head's K and V are resident. Walk 1: S = Q K^T and
//               dP = dO V^T give the row max, the sum of exp and
//               r = rowsum(p dP) by an online rescaling. Walk 2 rebuilds p
//               and dP, rounds dS in registers and adds dQ += dS K with K
//               read MN-major. It writes dQ and, per row, the log2-sum-exp
//               and r.
//   column pass (dK, dV) a consumer warpgroup owns a 64-key tile of K and
//               V; the head's Q and dO are resident. S^T = K Q^T and
//               dP^T = V dO^T; p^T = exp2(S^T - lse) and dS^T in registers
//               from the row statistics, read from global memory (L2)
//               beside the products; dV += bf16(p^T) dO and dK += dS^T Q
//               with dO and Q read MN-major.
// Every product is a wgmma with A in registers (RS): the consumer's own
// tiles are read once into A fragments by ldmatrix, so the score products
// read only their B chunk from shared memory (an SS m64n64k16 reads 4 KB
// in its 32 clocks, the whole 128 bytes a clock of shared memory), and p
// and dS feed the other products straight from the score accumulators.
// Nine [S, S, 64] products where the JAX kernel does five: S and dP three
// times each. At the train shape that is ~154 GFLOP on 64-row tiles
// (0.156 ms at the bf16 peak), above the byte bound.
//
// A block is one (batch, head) of one pass: a producer warpgroup and two
// consumer warpgroups (384 threads). One producer thread loads every tile
// by TMA through 4-D maps over the operands' own strides (dims 64, head,
// row, batch; rows past S arrive as zeros): the resident operand pair one
// 64-row chunk at a time, each chunk on its own mbarrier, so the first
// products start while the rest land; and each consumer's own tile pair,
// refilled as soon as the consumer has read the previous one into
// registers. Consumers take the head's tiles in turn (w, w + 2, ...). A
// last chunk of at most 16 rows takes the m64n16 form of the score
// products and one k-step of the others, as in K1. Within a chunk the
// exponentials run while dP is still in the tensor cores, and the last
// product of a chunk runs under the next chunk's score products.
//
// Budget. A row-pass consumer holds the A fragments of Q and dO (32
// registers), S, dP and dQ (3 x 32 f32) and the dS fragments; a
// column-pass consumer those of K and V, S^T, dP^T, dK, dV (4 x 32), the
// p and dS fragments and its 16 queries' statistics: more than the core's
// 96 registers. So a block runs alone on its SM, and setmaxnreg gives the
// consumers 232 registers a thread and leaves the producer 40 (`-Xptxas
// -v` reports the launch cap, 168, and no spills). Shared memory: 1 KB of
// alignment slack, the consumers' own tile pairs (32 KB), the resident
// pairs (16 KB a 64-row chunk) and the barriers: 115,784 bytes at S=257,
// 230,528 at S=768 (a block may take 232,448). Both passes are resident at
// every S up to 768: there is no streamed form and no residency threshold.
//
// The scale. TMA brings q unscaled; the products that take q are scaled
// in f32 afterwards by `q_mul`. For a power-of-two scale (64^-1/2 = 2^-3,
// the default) that is bit-identical to scaling q in bf16 first: a
// power-of-two factor commutes with every rounding (barring overflow and
// underflow), so (q k^T) 2^-3 = qs k^T and (dS^T q) 2^-3 = dS^T qs exactly.
// For any other scale the wrapper passes qs = bf16(q * scale), made as the
// plain version makes it, as the Q operand and q_mul = 1.

#include "sm90_attention.cuh"

namespace {

using attn::bf16;
using attn::HD;
using attn::TILE;
using attn::TILE_BYTES;

constexpr int MAX_SEQ = 768;     // both passes resident: 230,528 bytes
constexpr int NCONS = 2;         // consumer warpgroups a block
constexpr int NTHREADS = (NCONS + 1) * 128;   // + the producer warpgroup
constexpr int ROWS = 0;          // dQ and the row statistics
constexpr int COLS = 1;          // dK and dV

struct Params {
    bf16* dqkv;        // [B, S, 3, H, 64]
    float* stats;      // [B, H, n_t * 64, 2]: log2-sum-exp and r of a row
    int S, H;
    int n_t;           // 64-row tiles (= chunks) of a head
    float sl2;         // q_mul * log2(e): scores in log2 units
    float out_scale;   // ROWS: scale (dQ); COLS: q_mul (dK)
};

// dynamic shared memory of a launch: alignment slack, the consumers' own
// tile pairs, the resident pairs, the mbarriers
inline size_t smem_bytes(int n_t) {
    return 1024 + (size_t)(2 * NCONS + 2 * n_t) * TILE_BYTES
           + 8 * (2 * NCONS + n_t);
}

// d (+)= a[64 x 16] . b[N x 16]^T for N in {16, 64}: a in registers (the
// A fragments of `load_frags`), b K-major bf16 in shared memory (128-byte
// swizzle descriptor), f32 accumulate; scale_d = 0 overwrites d
template <int N>
__device__ __forceinline__ void wgmma_rs_kmajor(float (&d)[N / 2],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
    if constexpr (N == 16) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7"
            "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(scale_d));
    } else {
        asm volatile(
            "{\n.reg .pred p;\n"
            "setp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
              "r"(scale_d));
    }
}

// The A fragments of this warp's 16 rows (of 64) of the swizzled tile at
// `tile`, k-step kk in a[kk], by ldmatrix: lane l addresses row l % 8 of
// 8 x 8 matrix l / 8 (rows + 8 for odd matrices, columns + 8 for the last
// two), which leaves register i in the mma.sync A layout of matrix i.
__device__ __forceinline__ void load_frags(uint32_t (&a)[HD / 16][4],
                                           const unsigned char* tile,
                                           int warp_in_wg, int lane) {
    const int row = 16 * warp_in_wg + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t addr = sm90::smem_u32(
            tile + sm90::sw128_offset(row, 2 * kk + (lane >> 4)));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(a[kk][0]), "=r"(a[kk][1]), "=r"(a[kk][2]), "=r"(a[kk][3])
            : "r"(addr) : "memory");
    }
}

// A fragments in registers. The PTX ISA leaves undefined any write to a
// register that holds an A fragment of a wgmma.mma_async before a
// wgmma.wait_group covers that wgmma's group. A fragment array that is dead
// in the C++ code after the asm that issues the product is free for the
// register allocator to hand to the next instruction (a load, a temporary),
// while the tensor cores may still read it. So every A fragment of a product
// left in flight is owned by a scope that outlives the product and is
// fenced (`sm90::fence_operands`, which the compiler must treat as a read
// and a write of every register) after the wait that covers it: the
// consumer's own fragments at tile level, fenced after the tile's last wait;
// the dS fragments of the row pass and of the column pass at tile level,
// fenced after the next chunk's first wait; the column pass's p fragments
// are waited for before col_step returns.
using Frags = uint32_t[HD / 16][4];

// x = A0 B0^T, then y = A1 B1^T, over one chunk of NK rows of B (wgmma RS:
// A from registers, B K-major), as two commit groups left in flight
template <int NK>
__device__ __forceinline__ void two_products(float (&x)[NK / 2],
                                             float (&y)[NK / 2],
                                             const Frags& a0, uint64_t b0,
                                             const Frags& a1, uint64_t b1) {
    sm90::fence_operands(x);
    sm90::fence_operands(y);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_kmajor<NK>(x, a0[kk], b0 + 2 * kk, kk > 0);
    sm90::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_rs_kmajor<NK>(y, a1[kk], b1 + 2 * kk, kk > 0);
    sm90::wgmma_commit();
}

// wait until at most N commit groups are in flight, then read `d`
template <int N, int R>
__device__ __forceinline__ void await(float (&d)[R]) {
    sm90::wgmma_wait<N>();
    sm90::fence_operands(d);
}

// d += A (the first NK/16 k-steps of bf16 fragments in registers) . B
// (MN-major at `b`), as one commit group left in flight. `a` must stay
// untouched until a wait covers the group: the caller owns it and fences it
// after that wait (see the note on A fragments above).
template <int NK>
__device__ __forceinline__ void rs_product(float (&d)[32], Frags& a,
                                           uint64_t b) {
    sm90::fence_operands(d);
    sm90::fence_operands(a);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
        sm90::wgmma_m64n64k16_rs(d, a[kk], b + 128 * kk, 1);
    sm90::wgmma_commit();
}

// Row pass, walk 1: fold one chunk of NK keys into the running max m (log2
// units), the per-lane sums l of exp2(x - m) and rr of exp2(x - m) dP. The
// exponentials run while dP is still in the tensor cores.
template <int NK>
__device__ __forceinline__ void row_stats_step(const Frags& dq,
                                               const Frags& ddo,
                                               uint64_t dk, uint64_t dv,
                                               int left, float sl2, int t,
                                               float (&m)[2], float (&l)[2],
                                               float (&rr)[2]) {
    float s[NK / 2], dp[NK / 2];
    two_products<NK>(s, dp, dq, dk, ddo, dv);
    await<1>(s);
    attn::scale_mask<NK>(s, left, sl2, t);
    float bm[2];
    attn::row_max<NK>(s, bm);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], bm[r]);
        const float alpha = attn::ex2(m[r] - m_new);  // 0 on the first chunk
        m[r] = m_new;
        l[r] *= alpha;
        rr[r] *= alpha;
    }
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) {
        s[i] = attn::ex2(s[i] - m[(i >> 1) & 1]);
        l[(i >> 1) & 1] += s[i];
    }
    await<0>(dp);
#pragma unroll
    for (int i = 0; i < NK / 2; ++i) rr[(i >> 1) & 1] += s[i] * dp[i];
}

// Row pass, walk 2: p and dP of one chunk again, dS rounded in registers
// (`dsa`, the caller's), dQ += dS K (K MN-major at `dk_mn`), left in
// flight: the next chunk's products queue behind it and its first wait
// covers it, after which `dsa` may be written again (`finish` after the
// last).
template <int NK>
__device__ __forceinline__ void row_grad_step(
    const Frags& dq, const Frags& ddo, uint64_t dk, uint64_t dv,
    uint64_t dk_mn, int left, float sl2, int t, const float (&lse)[2],
    const float (&r)[2], Frags& dsa, float (&acc)[32]) {
    float s[NK / 2], dp[NK / 2];
    two_products<NK>(s, dp, dq, dk, ddo, dv);
    await<1>(s);
    sm90::fence_operands(dsa);     // the previous dS K has read them
    attn::scale_mask<NK>(s, left, sl2, t);
#pragma unroll
    for (int i = 0; i < NK / 2; ++i)
        s[i] = attn::ex2(s[i] - lse[(i >> 1) & 1]);          // p
    await<0>(dp);
    // the C layout of score columns 16k..16k+15 is the A layout of the
    // k-th step of dS K
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            ds[e] = s[4 * j + e] * (dp[4 * j + e] - r[e >> 1]);
        dsa[j / 2][(j % 2) * 2] = attn::pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j % 2) * 2 + 1] = attn::pack_bf16(ds[2], ds[3]);
    }
    rs_product<NK>(acc, dsa, dk_mn);
}

// wait for every product still in flight, then release the A fragments
// they read and read `acc`
__device__ __forceinline__ void finish(float (&acc)[32], Frags& a0,
                                       Frags& a1, Frags& ds) {
    sm90::wgmma_wait<0>();
    sm90::fence_operands(a0);
    sm90::fence_operands(a1);
    sm90::fence_operands(ds);
    sm90::fence_operands(acc);
}

// Column pass: one chunk of NK queries into dK and dV. S^T = K Q^T and
// dP^T = V dO^T; query q (column 8j + 2t + e of the chunk) takes its
// log2-sum-exp and r from `st` (the chunk's first query); queries at or
// past `left` (the chunk's valid ones) give p = dS = 0 by selects, since
// their statistics are never written. dV += bf16(p^T) dO goes to the
// tensor cores while dP^T is waited for and dS^T formed, then dK +=
// dS^T Q (dO, Q MN-major). dK's product is left in flight as in
// row_grad_step, on the caller's `dsa`; dV's is waited for before the
// return, which costs nothing (it ran while dS^T was formed) and lets its
// p fragments die with the step.
template <int NK>
__device__ __forceinline__ void col_step(
    const Frags& dk, const Frags& dv, uint64_t dq, uint64_t ddo,
    uint64_t dq_mn, uint64_t ddo_mn, const float* st, int left, float sl2,
    int t, Frags& dsa, float (&acc_k)[32], float (&acc_v)[32]) {
    // issued before the products, so that they land while those run
    float4 sv[NK / 8];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
        sv[j] = __ldg(reinterpret_cast<const float4*>(st + 2 * (8 * j
                                                                + 2 * t)));
    float s[NK / 2], dp[NK / 2];
    two_products<NK>(s, dp, dk, dq, dv, ddo);
    await<1>(s);
    sm90::fence_operands(dsa);     // the previous dK product has read them
    Frags pa;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const bool valid = 8 * j + 2 * t + (e & 1) < left;
            const float lse = (e & 1) ? sv[j].z : sv[j].x;
            s[4 * j + e] =
                valid ? attn::ex2(s[4 * j + e] * sl2 - lse) : 0.f;   // p
        }
        pa[j / 2][(j % 2) * 2] = attn::pack_bf16(s[4 * j], s[4 * j + 1]);
        pa[j / 2][(j % 2) * 2 + 1] =
            attn::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
    rs_product<NK>(acc_v, pa, ddo_mn);
    await<1>(dp);
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const bool valid = 8 * j + 2 * t + (e & 1) < left;
            const float r = (e & 1) ? sv[j].w : sv[j].y;
            ds[e] = valid ? s[4 * j + e] * (dp[4 * j + e] - r) : 0.f;
        }
        dsa[j / 2][(j % 2) * 2] = attn::pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j % 2) * 2 + 1] = attn::pack_bf16(ds[2], ds[3]);
    }
    rs_product<NK>(acc_k, dsa, dq_mn);
    sm90::wgmma_wait<1>();         // dV's product: done with pa
    sm90::fence_operands(pa);
    sm90::fence_operands(acc_v);
}

// One pass over one (batch, head). The consumer's own pair (a0, a1) and
// the resident pair (b0, b1): ROWS (Q, dO) against (K, V); COLS (K, V)
// against (Q, dO).
template <int PASS>
__global__ void __launch_bounds__(NTHREADS, 1)
bwd_kernel(const __grid_constant__ CUtensorMap map_a0,
           const __grid_constant__ CUtensorMap map_a1,
           const __grid_constant__ CUtensorMap map_b0,
           const __grid_constant__ CUtensorMap map_b1, const Params p) {
    extern __shared__ unsigned char smem_raw[];
    // 1024-byte aligned for the swizzle; kept an offset from the shared
    // array so that every access stays a shared-memory one
    unsigned char* own = smem_raw + sm90::align1024_pad(smem_raw);
    unsigned char* res = own + 2 * NCONS * TILE_BYTES;
    uint64_t* own_full =
        reinterpret_cast<uint64_t*>(res + 2 * p.n_t * TILE_BYTES);
    uint64_t* own_empty = own_full + NCONS;
    uint64_t* res_full = own_empty + NCONS;

    const int bh = blockIdx.x;
    const int h = bh % p.H, b = bh / p.H;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

    if (threadIdx.x == 0) {
        for (int w = 0; w < NCONS; ++w) {
            sm90::mbar_init(&own_full[w], 1);
            sm90::mbar_init(&own_empty[w], 128);   // a warpgroup
        }
        for (int j = 0; j < p.n_t; ++j) sm90::mbar_init(&res_full[j], 1);
        sm90::fence_mbar_init();
    }
    __syncthreads();

    if (warp < 4) {
        // ---- producer: one thread issues every load of the block; the
        // warpgroup hands its registers to the consumers
        sm90::setmaxnreg_dec<40>();
        if (threadIdx.x != 0) return;
        auto load_pair = [&](const CUtensorMap* m0, const CUtensorMap* m1,
                             unsigned char* dst, uint64_t* bar, int row0) {
            sm90::mbar_arrive_expect_tx(bar, 2 * TILE_BYTES);
            sm90::tma_load_4d(dst, m0, bar, 0, h, row0, b);
            sm90::tma_load_4d(dst + TILE_BYTES, m1, bar, 0, h, row0, b);
        };
        for (int w = 0; w < NCONS && w < p.n_t; ++w)
            load_pair(&map_a0, &map_a1, own + w * 2 * TILE_BYTES,
                      &own_full[w], w * TILE);
        for (int j = 0; j < p.n_t; ++j)
            load_pair(&map_b0, &map_b1, res + j * 2 * TILE_BYTES,
                      &res_full[j], j * TILE);
        // later own tiles, each into its consumer's slot once that
        // consumer has its previous one in registers
        for (int i = NCONS; i < p.n_t; ++i) {
            const int w = i % NCONS, c = i / NCONS;
            sm90::mbar_wait(&own_empty[w], (c - 1) & 1);
            load_pair(&map_a0, &map_a1, own + w * 2 * TILE_BYTES,
                      &own_full[w], i * TILE);
        }
        return;
    }

    // ---- consumer warpgroups
    sm90::setmaxnreg_inc<232>();
    const int wg = warp / 4 - 1;
    const int t = lane % 4;
    const int row_in_tile = (warp % 4) * 16 + lane / 4;
    unsigned char* mine = own + wg * 2 * TILE_BYTES;
    const int last = p.n_t - 1;
    const int tail = p.S - last * TILE;          // rows of the last chunk
    const bool short_tail = tail <= 16;
    const long long D = (long long)p.H * HD;
    bf16* out = p.dqkv + (long long)b * p.S * 3 * D + h * HD;
    float* stats = p.stats + (long long)bh * p.n_t * TILE * 2;
    // the resident chunk j, waited for once loaded
    auto chunk = [&](int j) -> unsigned char* {
        sm90::mbar_wait(&res_full[j], 0);
        return res + j * 2 * TILE_BYTES;
    };

    const int n_mine = (p.n_t - wg + NCONS - 1) / NCONS;
    for (int c = 0; c < n_mine; ++c) {
        const int i = wg + c * NCONS;
        const int row = i * TILE + row_in_tile;
        // the own pair into registers, as the A operand of every score
        // product of the tile; its slot goes back to the producer at once
        Frags fa0, fa1;
        sm90::mbar_wait(&own_full[wg], c & 1);
        load_frags(fa0, mine, warp % 4, lane);
        load_frags(fa1, mine + TILE_BYTES, warp % 4, lane);
        // The producer refills the slot by TMA, an async-proxy write, once
        // every consumer thread has arrived. The mbarrier's release orders
        // these ldmatrix reads only within the generic proxy; the PTX
        // memory model orders generic-proxy accesses before async-proxy
        // ones through a proxy fence alone, so each thread fences its reads
        // before it arrives (a few cycles, once a tile).
        sm90::fence_proxy_async();
        sm90::mbar_arrive(&own_empty[wg]);     // each after its own reads
        Frags dsa = {};                        // dS fragments (see Frags)
        if constexpr (PASS == ROWS) {
            float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f},
                  rr[2] = {0.f, 0.f};
            for (int j = 0; j < p.n_t; ++j) {
                unsigned char* kv = chunk(j);
                const uint64_t dk = sm90::desc_sw128(kv);
                const uint64_t dv = sm90::desc_sw128(kv + TILE_BYTES);
                if (j == last && short_tail)
                    row_stats_step<16>(fa0, fa1, dk, dv, tail, p.sl2, t, m,
                                       l, rr);
                else
                    row_stats_step<64>(fa0, fa1, dk, dv, p.S - j * TILE,
                                       p.sl2, t, m, l, rr);
            }
            float lse[2], r[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                l[k] += __shfl_xor_sync(0xffffffffu, l[k], 1);
                l[k] += __shfl_xor_sync(0xffffffffu, l[k], 2);
                rr[k] += __shfl_xor_sync(0xffffffffu, rr[k], 1);
                rr[k] += __shfl_xor_sync(0xffffffffu, rr[k], 2);
                lse[k] = m[k] + log2f(l[k]);
                r[k] = rr[k] / l[k];
                if (t == 0 && row + 8 * k < p.S)
                    *reinterpret_cast<float2*>(stats + 2 * (row + 8 * k)) =
                        make_float2(lse[k], r[k]);
            }
            float acc[32];
#pragma unroll
            for (int k = 0; k < 32; ++k) acc[k] = 0.f;
            for (int j = 0; j < p.n_t; ++j) {
                unsigned char* kv = res + j * 2 * TILE_BYTES;   // loaded
                const uint64_t dk = sm90::desc_sw128(kv);
                const uint64_t dv = sm90::desc_sw128(kv + TILE_BYTES);
                const uint64_t dk_mn = sm90::desc_sw128_mn(kv);
                if (j == last && short_tail)
                    row_grad_step<16>(fa0, fa1, dk, dv, dk_mn, tail, p.sl2,
                                      t, lse, r, dsa, acc);
                else
                    row_grad_step<64>(fa0, fa1, dk, dv, dk_mn,
                                      p.S - j * TILE, p.sl2, t, lse, r, dsa,
                                      acc);
            }
            finish(acc, fa0, fa1, dsa);
            const float f[2] = {p.out_scale, p.out_scale};
            attn::store_rows(acc, f, out, row, p.S, 3 * D, t);   // dQ
        } else {
            float acc_k[32], acc_v[32];
#pragma unroll
            for (int k = 0; k < 32; ++k) acc_k[k] = acc_v[k] = 0.f;
            for (int j = 0; j < p.n_t; ++j) {
                unsigned char* qo = chunk(j);
                const uint64_t dq = sm90::desc_sw128(qo);
                const uint64_t ddo = sm90::desc_sw128(qo + TILE_BYTES);
                const uint64_t dq_mn = sm90::desc_sw128_mn(qo);
                const uint64_t ddo_mn = sm90::desc_sw128_mn(qo + TILE_BYTES);
                const float* st = stats + 2 * j * TILE;
                if (j == last && short_tail)
                    col_step<16>(fa0, fa1, dq, ddo, dq_mn, ddo_mn, st, tail,
                                 p.sl2, t, dsa, acc_k, acc_v);
                else
                    col_step<64>(fa0, fa1, dq, ddo, dq_mn, ddo_mn, st,
                                 p.S - j * TILE, p.sl2, t, dsa, acc_k, acc_v);
            }
            finish(acc_k, fa0, fa1, dsa);
            sm90::fence_operands(acc_v);
            const float fk[2] = {p.out_scale, p.out_scale};
            const float fv[2] = {1.f, 1.f};
            attn::store_rows(acc_k, fk, out + D, row, p.S, 3 * D, t);
            attn::store_rows(acc_v, fv, out + 2 * D, row, p.S, 3 * D, t);
        }
    }
}

template <int PASS>
cudaError_t configure() {
    static unsigned configured = 0;
    return sm90::once_per_device(configured, [] {
        cudaError_t e = cudaFuncSetAttribute(
            bwd_kernel<PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            232448);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                bwd_kernel<PASS>,
                cudaFuncAttributePreferredSharedMemoryCarveout,
                cudaSharedmemCarveoutMaxShared);
        return e;
    });
}

}  // namespace

extern "C" const char* alm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// qkv [B, S, 3*H*64], dout [B, S, H*64] bf16 on CUDA device `device` ->
// dqkv [B, S, 3*H*64] bf16, on `stream`; stats is f32 scratch of
// B*H*ceil(S/64)*64*2 values. `qs` is null for a power-of-two `scale`
// (applied to the f32 products), else bf16(q * scale) as a contiguous
// [B, S, H*64] tensor.
extern "C" int alm_fused_qkv_attention_bwd(const void* qkv, const void* dout,
                                           const void* qs, void* dqkv,
                                           void* stats, int B, int S, int H,
                                           float scale, int device,
                                           void* stream) {
    if (S < 1 || S > MAX_SEQ || B < 1 || H < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    // The autograd engine runs the backward on a worker thread of its own,
    // which has no current CUDA context until its first kernel launch (the
    // framework binds one lazily); encoding a tensor map needs one, so bind
    // the device's primary context first.
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    // q, k, v of head h: columns h*64, D + h*64, 2D + h*64 of each row
    const long long D = (long long)H * HD, row = 3 * D;
    const bf16* base = static_cast<const bf16*>(qkv);
    CUtensorMap m_q, m_k, m_v, m_do;
    err = qs != nullptr
              ? attn::make_map(&m_q, qs, S * D, D, HD, B, S, H)
              : attn::make_map(&m_q, base, S * row, row, HD, B, S, H);
    if (err == cudaSuccess)
        err = attn::make_map(&m_k, base + D, S * row, row, HD, B, S, H);
    if (err == cudaSuccess)
        err = attn::make_map(&m_v, base + 2 * D, S * row, row, HD, B, S, H);
    if (err == cudaSuccess)
        err = attn::make_map(&m_do, dout, S * D, D, HD, B, S, H);
    if (err == cudaSuccess) err = configure<ROWS>();
    if (err == cudaSuccess) err = configure<COLS>();
    if (err != cudaSuccess) return static_cast<int>(err);
    const float q_mul = qs != nullptr ? 1.f : scale;
    Params p{};
    p.dqkv = static_cast<bf16*>(dqkv);
    p.stats = static_cast<float*>(stats);
    p.S = S;
    p.H = H;
    p.n_t = (S + TILE - 1) / TILE;
    p.sl2 = q_mul * attn::LOG2E;
    p.out_scale = scale;
    const unsigned blocks = static_cast<unsigned>(B * H);
    const size_t smem = smem_bytes(p.n_t);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bwd_kernel<ROWS><<<blocks, NTHREADS, smem, st>>>(m_q, m_do, m_k, m_v, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    p.out_scale = q_mul;
    bwd_kernel<COLS><<<blocks, NTHREADS, smem, st>>>(m_k, m_v, m_q, m_do, p);
    return static_cast<int>(cudaGetLastError());
}
