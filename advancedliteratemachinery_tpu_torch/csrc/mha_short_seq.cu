// Per-(batch, head) softmax attention on separate q, k, v.
//
// Replaces the Pallas kernel `_mha_kernel` in
// advancedliteratemachinery_tpu/ops/attention.py (launched by
// `mha_short_seq`). q, k, v [B, S, H, 64] bf16, each read in place through
// its own (batch, row, head) strides, so a view of a qkv projection or of a
// [B, H, S, 64] tensor needs no transposed copy (the JAX wrapper transposes
// to BHSD around its kernel); output [B, S, H, 64] bf16, contiguous. With
// the JAX kernel's arithmetic: s = (q k^T) * scale in f32, safe softmax,
// the probabilities normalised and only then rounded to bf16 before the
// product with v.
//
// What bounds it on an H100: at B=128, S=257, H=12 it must read q, k, v and
// write o (202 MB: 0.060 ms at 3.35 TB/s) and do 4 B H S^2 64 = 26 GFLOP
// of products (0.026 ms at 989 TFLOP/s bf16): memory-bound; at B=16,
// S=1024 it is bound by the products (0.052 ms; 0.078 with the first
// walk's Q K^T, which the rounding point forces). Both walks take an
// exponential a score: 267 M at S=257 and 403 M at S=1024, 0.064 and
// 0.096 ms on 16 ex2 a clock an SM at 1.98 GHz.
//
// The design is the attention core of sm90_attention.cuh in its TWO_WALK
// form: because p is rounded after it is normalised, each row's max and
// sum come from a first walk over K before a second walk forms p and
// accumulates P V. Both walks run over shared memory, fed by the producer
// warp by TMA through a 4-D map per operand over the view's own strides
// (the map encoder takes every stride the wrapper accepts: views of a
// projection, [B, H, S, 64] through `.transpose(1, 2)`, stride 0). Where one
// head's K and V (2 x 64 keys x 128 bytes a chunk) leave room for two
// blocks an SM, that is up to RESIDENT_MAX_CHUNKS chunks (S <= 320, 97 KB
// a block), the block is a (batch, head): K and V are read once and both
// walks of all the head's query tiles run over them. Longer heads (S=1024:
// 256 KB of K and V) are streamed: the block is a (batch, head, pair of
// 64-row query tiles) and both walks run through a 4-stage ring of K/V
// chunks (80 KB a block, two an SM), so at B=16, H=12 the 192 heads become
// 1536 blocks instead of 1.45 waves of 192.

#include "sm90_attention.cuh"

namespace {

constexpr int MAX_SEQ = 1024;
// resident while two blocks fit an SM's 233,472 bytes: a block takes 1 KB
// of alignment slack, 16 KB of Q tiles, 16 KB a K/V chunk and its barriers,
// and the SM reserves 1 KB for each; five chunks take 2 x 100,464 bytes,
// six 2 x 116,864
constexpr int RESIDENT_MAX_CHUNKS = 5;

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
    const long long strides[9] = {qsb, qss, qsh, ksb, kss, ksh,
                                  vsb, vss, vsh};
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if ((S + attn::TILE - 1) / attn::TILE <= RESIDENT_MAX_CHUNKS)
        return static_cast<int>(attn::run<attn::TWO_WALK, false>(
            q, k, v, out, strides, B, S, H, scale, 1, st));
    return static_cast<int>(attn::run<attn::TWO_WALK, true>(
        q, k, v, out, strides, B, S, H, scale, 1, st));
}
