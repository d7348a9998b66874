// Fused multi-head self-attention forward straight off the qkv projection.
//
// Replaces the Pallas kernel `_fused_qkv_kernel` in
// advancedliteratemachinery_tpu/ops/attention.py (launched by
// `fused_qkv_attention`). Input qkv [B, S, 3D] bf16 in the timm q|k|v
// layout, output [B, S, D] bf16: per head h, softmax(q_h k_h^T * scale) v_h
// with f32 scores, f32 softmax statistics and f32 accumulation; `safe`
// keeps a running row max, unsafe fixes it at 0 (Policy.unsafe_softmax);
// the probabilities go into P.V as bf16 and into the row sum unrounded,
// and the output is normalised at the end. No transposed copy of q, k or v
// ever touches device memory.
//
// What bounds it on an H100: at MGP-STR-base shapes (B=256, S=257, D=768,
// H=12, hd=64) the kernel must read 303 MB and write 101 MB (0.12 ms at
// 3.35 TB/s) and do 52 GFLOP of products (0.05 ms at 989 TFLOP/s bf16), so
// it is memory-bound: it has to read qkv once and keep the [S, S] scores
// out of memory. Next come its 267 M exponentials (64 query rows a tile
// against 4 x 64 + 16 keys, 5 tiles a head): 0.064 ms on 16 ex2 a clock an
// SM at 1.98 GHz.
//
// The design is the attention core of sm90_attention.cuh in its ONLINE
// form, always resident: a block is one (batch, head). Its producer warp
// reads q, k and v of the head by TMA through three 4-D maps over views of
// qkv (columns 0, D and 2D on; rows past S arrive as zeros, so no tile
// reads the next image), each 64-key chunk of K and V once into its own
// slot on its own mbarrier, so the first chunk's products start while the
// rest land. The two consumer warpgroups take the head's 64-row query
// tiles in turn (S=257: 5 tiles, 3 + 2), each with wgmma SS for Q K^T and
// wgmma RS for P V, P straight from the score accumulators. The last chunk
// at S=257 holds one key: its Q K^T is one m64n16k16 a k-step and its P V
// one k-step, not four. At S=257 a block takes 97 KB of shared memory, so
// two share an SM and one block's loads run under the other's products
// (at S=768, 210 KB: one block an SM).

#include "sm90_attention.cuh"

namespace {

constexpr int MAX_SEQ = 768;     // K and V of 768 keys fill 192 KB

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
    // q, k, v of head h: columns h*64, D + h*64, 2D + h*64 of each row
    const long long D = (long long)H * attn::HD, row = 3 * D;
    const long long strides[9] = {S * row, row, attn::HD, S * row, row,
                                  attn::HD, S * row, row, attn::HD};
    const attn::bf16* base = static_cast<const attn::bf16*>(qkv);
    return static_cast<int>(attn::run<attn::ONLINE, false>(
        base, base + D, base + 2 * D, out, strides, B, S, H, scale, safe,
        static_cast<cudaStream_t>(stream)));
}
