// Hopper (sm_90a) building blocks shared by the port's wgmma kernels:
// mbarrier rings, TMA tile loads, wgmma on 128-byte-swizzled K-major bf16
// tiles and register rebalancing between warpgroups. Plain inline PTX
// (PTX ISA 8.0); every helper is one instruction or a short wait loop.
//
// The operand layout every kernel here uses: a tile of R rows x 64 bf16
// (128 bytes a row, K contiguous) at a 1024-byte-aligned shared address,
// with the 16-byte chunks of row r permuted as chunk ^ (r % 8). That is
// what TMA writes with CU_TENSOR_MAP_SWIZZLE_128B and what a wgmma
// descriptor of layout type 1 (128-byte swizzle) reads; a kernel that
// writes such a tile with its own threads uses `sw128_offset`. The same
// tile serves wgmma both as a K-major operand (rows = M or N, 128 bytes of
// K each: `desc_sw128`) and, with the transpose bit, as an MN-major B
// (rows = K, 128 bytes of N each: `desc_sw128_mn`), as attention's V.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sm90 {

// 32-bit shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes from `p` to the next 1024-byte-aligned shared address
__device__ __forceinline__ uint32_t align1024_pad(const void* p) {
    return (1024 - (smem_u32(p) & 1023)) & 1023;
}

// byte offset of 16-byte chunk `chunk` (0-7) of row `row` in a swizzled tile
__device__ __forceinline__ uint32_t sw128_offset(int row, int chunk) {
    return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// ---- mbarriers -----------------------------------------------------------

// initialise a barrier that completes a phase after `count` arrivals
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival (release semantics at CTA scope)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n.reg .b64 st;\n"
                 "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    uint32_t done = 0;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}

// ---- TMA -----------------------------------------------------------------

// 2-D tile at element coordinates (c0 innermost, c1) into `dst`; completes
// its bytes on `bar`. Parts of the box outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// 3-D tile at element coordinates (c0 innermost, c1, c2), as tma_load_2d
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

// 4-D tile at element coordinates (c0 innermost, ..., c3), as tma_load_2d
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
        :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
           "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma) of the same bytes
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1-15) over the first `count` threads that reach it
__device__ __forceinline__ void named_bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// descriptor of a 128-byte-swizzled K-major tile at `p` (1024-byte aligned):
// start address >> 4, leading offset 1 (unused by this layout), stride
// 1024 bytes between 8-row groups, layout type 1. Adding 2 to it steps 32
// bytes (16 bf16) along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>(1) << 16)
           | (static_cast<uint64_t>(1024 >> 4) << 32)
           | (static_cast<uint64_t>(1) << 62);
}

// descriptor of the same tile read as an MN-major operand (wgmma's
// transpose bit set): rows are K, each 128 bytes of N = 64. Its 8-row
// groups along K lie 1024 bytes apart; the other offset, between 64-wide
// blocks of N, is never used at N = 64. The two offset fields swap roles
// between the K-major and the MN-major layout, so both hold 1024 bytes.
// Adding 128 to it steps 16 rows (16 K) on.
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* p) {
    return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4)
           | (static_cast<uint64_t>(1024 >> 4) << 16)
           | (static_cast<uint64_t>(1024 >> 4) << 32)
           | (static_cast<uint64_t>(1) << 62);
}

// order earlier register and shared-memory accesses before the next wgmma
__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// close the group of wgmma issued since the last commit
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accesses of accumulator registers across
// a wgmma fence or wait
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int R, int C>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[R][C]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j)
            asm volatile("" : "+r"(a[i][j]) :: "memory");
}

// d[0:8] (+)= a[64 x 16] . b[16 x 16]^T; a, b K-major bf16 in shared memory
// (128-byte swizzle descriptors), f32 accumulate; scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n16k16(float (&d)[8], uint64_t a,
                                                uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:32] (+)= a[64 x 16] . b[16 x 64] with a in registers and b MN-major
// in shared memory (`desc_sw128_mn`: rows = the 16 K, 128 bytes of N
// each), f32 accumulate. Each warp w of the warpgroup holds rows 16w..+15
// of a in the A-fragment layout of mma.sync m16n8k16: a[0] (row g, k 2t,
// 2t+1), a[1] (g + 8, 2t), a[2] (g, 2t + 8), a[3] (g + 8, 2t + 8), with
// g = lane / 4, t = lane % 4. That is the accumulator layout of an m64nN
// wgmma, so an f32 product tile repacked as bf16 pairs (accumulators 8k..
// 8k+7 give the A fragment of K columns 16k..16k+15) feeds this one
// without a trip through shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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

// d[0:32] (+)= a[64 x 16] . b[64 x 16]^T; a, b K-major bf16 in shared
// memory (128-byte swizzle descriptors), f32 accumulate; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a,
                                 uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:64] (+)= a[64 x 16] . b[128 x 16]^T; a, b K-major bf16 in shared
// memory (128-byte swizzle descriptors), f32 accumulate; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                 uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:128] (+)= a[64 x 16] . b[256 x 16]^T; a, b K-major bf16 in shared
// memory (128-byte swizzle descriptors), f32 accumulate; scale_d = 0
// overwrites d
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                 uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
}


// The same product as wgmma_m64n256k16 (the same accumulator layout) as two
// m64n128k16 on the two halves of b's rows: each instruction needs only
// 64 accumulators, so a kernel capped below 154 registers a thread (512
// threads) still compiles it after setmaxnreg raises its consumers
__device__ __forceinline__ void wgmma_m64n256k16_2x128(float (&d)[128],
                                                      uint64_t a, uint64_t b,
                                                      int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %131, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %128, %129, p, 1, 1, 0, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %130, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "l"(b + 1024), "r"(scale_d));
}

// d (+)= a[64 x 16] . b[N x 16]^T for N in {16, 64, 128, 256}
template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a,
                                           uint64_t b, int scale_d) {
    if constexpr (N == 16) wgmma_m64n16k16(d, a, b, scale_d);
    else if constexpr (N == 64) wgmma_m64n64k16(d, a, b, scale_d);
    else if constexpr (N == 128) wgmma_m64n128k16(d, a, b, scale_d);
    else wgmma_m64n256k16(d, a, b, scale_d);
}

// ---- register rebalancing between warpgroups ---------------------------

// raise this warpgroup's per-thread register limit to R
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

// lower this warpgroup's per-thread register limit to R, freeing the rest
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// ---- host ------------------------------------------------------------------

// Run `set` (cudaFuncSetAttribute calls) once per device for a kernel whose
// attributes `done` tracks, so that a launch costs no runtime calls beyond
// the launch itself. A race only repeats the same setting.
template <typename Set>
inline cudaError_t once_per_device(unsigned& done, Set set) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned bit = dev < 32 ? 1u << dev : 0u;
    if (done & bit) return cudaSuccess;
    err = set();
    if (err == cudaSuccess) done |= bit;
    return err;
}


// Tensor map of a row-major bf16 tensor of `rank` dims (dims[0] innermost,
// strides in bytes for dims 1..rank-1) read in boxes of `box` elements with
// 128-byte swizzle and zero fill. cuTensorMapEncodeTiled is looked up by
// name in the libcuda.so.1 the process already has loaded, so the library
// needs no -lcuda and no toolkit-specific entry-point API.
inline cudaError_t encode_tile_map(CUtensorMap* map, int rank, const void* base,
                                   const cuuint64_t* dims,
                                   const cuuint64_t* strides,
                                   const cuuint32_t* box) {
    using Encode = CUresult (*)(
        CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
        const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
        const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
        CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
    static Encode encode = nullptr;
    if (encode == nullptr) {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
        if (lib != nullptr)
            encode = reinterpret_cast<Encode>(
                dlsym(lib, "cuTensorMapEncodeTiled"));
        if (encode == nullptr) return cudaErrorSymbolNotFound;
    }
    const cuuint32_t elem_strides[5] = {1, 1, 1, 1, 1};
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
        dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
