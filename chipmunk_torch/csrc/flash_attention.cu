// Dense flash attention forward with a log2-domain lse, and its variant
// that also emits per-query-group column sums of the previous step's
// softmax.
//
// Replaces (TPU reference, Pallas):
//   dense_attn        <- chipmunk_tpu/kernels/flash_attention.py:55 (_flash_kernel)
//   dense_colsum_attn <- chipmunk_tpu/kernels/flash_attention.py:100 (_colsum_kernel)
//
// Bound on the H100: operations, 4 * Sq * Sk * D * H at 989 TFLOP/s.  At
// the FLUX shape (24 heads, 4352 tokens, D = 128) one call is 233 GFLOP
// against ~107 MB of q/k/v/o, so the tensor cores, not the 3.35 TB/s of
// HBM, set the floor (~0.24 ms); at 540p (67,584 queries, keys cut at
// 67,576) 56.1 TFLOP, ~57 ms.
//
// Design: attn_sm90_kernel (attn_sm90.cuh) with the keys in order
// (DenseKeys below): a producer warpgroup that keeps a ring of 128-key K
// and V tiles full by TMA, and two consumer warpgroups of 64 query rows
// that take turns at wgmma.  Three stages for dense_attn, two for the
// column-sum variant.  The 3-D tensor maps (d, S, B H) take the head
// stride as their outer stride, so keys cut at a valid length or the
// query rows of a dense tail are read as views; rows past Sq and keys
// past Sk come in as zeros, and keys past Sk are also masked in the
// scores.  Registers: 24 + 2 x 240 (ptxas reports no spills).  Shared
// memory: Q 32 KB + 3 stages x (K 32 KB + V 32 KB) = 224 KB, plus 1 KB for
// alignment and the barriers, of the 227 KB a block may have (a third
// stage measured faster than two at every shape of the path).  The grid
// runs query tiles fastest, so the CTAs resident at one time share a head
// and its K/V stays in the 50 MB L2 (a head's K+V at 540p is 34.6 MB).
// The video path's 384-row dense tail is 72 such CTAs over 24 heads, on
// 132 SMs; a 64-row form of the same template (one consumer, 144 CTAs, a
// second partial wave) measured slower there.
//
// The column-sum variant: one CTA is exactly one 128-row query group, its
// 8 consumer warps 16 rows each.  cs[bh, g, b] = sum over the group's
// rows i and the keys j of score block b of 2^(s_ij tau - prev_lse_i).
// The second exp2 of that sum is folded out: with m the running max that
// the softmax has just used, p_ij = 2^(s_ij tau - m) is the f32
// probability before its bf16 rounding, and
//     2^(s_ij tau - prev_lse_i) = p_ij * 2^(m - prev_lse_i),
// an identity in real arithmetic; so per 64-key half tile a thread takes
// its row sums of p (which the softmax sums for l anyway) times one factor
// per row and tile.  The two forms differ by a few f32 roundings (~1e-6
// relative, against the 1e-3 tolerance).  PAD_LSE rows get a factor of
// exactly 0 (2^(m - 3e4) underflows), and masked keys have p = 0, so both
// add exactly 0.  The sums leave the consumers' path: each consumer
// thread writes its two half-tile partials to a two-slot hand-off ring
// in shared memory and arrives on that slot's mbarrier; a reducer warp
// (warp 1 of the producer warpgroup, otherwise idle) sums the 8 warps'
// partials lane by lane, then across the lanes, adds them to the group's
// row of nb sums, which only it touches, frees the slot, and writes the
// row out after the key loop.  Fixed orders throughout, so two calls give
// the same bits, and no block-wide barrier in the key loop.  A first form
// in which each warp reduced its own partials by shuffles into a
// [warp][block] slot cost a quarter more time at 540p: the shuffles sat
// on the consumer warps' own path.  Shared
// memory: a two-stage ring (160 KB; three would leave no room), the
// 4 KB hand-off ring and nb x 4 bytes; chipmunk_colsum_max_blocks()
// gives the largest nb that fits.
#include "attn_sm90.cuh"

using namespace chipmunk;
using namespace chipmunk::sm90;

namespace {

// Keys 0 .. Sk - 1 in order, tile i from key i * KT; keys past Sk masked.
struct DenseKeys {
  int Sk;
  __device__ DenseKeys(const Params& p, int, int) : Sk(p.Sk) {}
  __device__ int tiles() const { return (Sk + KT - 1) / KT; }
  __device__ void load(const CUtensorMap* tk, const CUtensorMap* tv,
                       uint32_t sk, uint32_t sv, uint32_t k_full,
                       uint32_t v_full, int*, int i, int bh) const {
    mbar_expect_tx(k_full, TILE);
    tma_load_tile(sk, tk, k_full, i * KT, bh, KT * BOX_ROW);
    mbar_expect_tx(v_full, TILE);
    tma_load_tile(sv, tv, v_full, i * KT, bh, KT * BOX_ROW);
  }
  __device__ void mask(const int*, int i, float (&s)[64], int t) const {
    const int key0 = i * KT;
    if (key0 + KT > Sk) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + 2 * t + (e & 1) >= Sk) s[4 * j + e] = neg_inf();
    }
  }
};

template <int ST, bool CS>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int BH, int q_hs, int kv_hs, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_head_map(&tq, q, BH, p.Sq, q_hs, BM);
  if (err == 0) err = make_head_map(&tk, k, BH, p.Sk, kv_hs, KT);
  if (err == 0) err = make_head_map(&tv, v, BH, p.Sk, kv_hs, KT);
  if (err != 0) return err;
  return launch_attn<ST, CS, DenseKeys>(
      tq, tk, tv, p, (p.Sq + BM - 1) / BM, BH,
      ring_bytes<ST>() + (CS ? HAND_BYTES + 4 * p.nb : 0), stream);
}

}  // namespace

// The largest number of score blocks whose column-sum slots fit beside
// the ring (dense_colsum_attn raises above it).
extern "C" int chipmunk_colsum_max_blocks() {
  return (SMEM_MAX - ring_bytes<2>() - HAND_BYTES) / 4;
}

extern "C" int chipmunk_dense_attn(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int BH, int Sq, int Sk,
                                   int q_hs, int kv_hs, float tau,
                                   void* stream) {
  if (Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  Params p{(__nv_bfloat16*)o, (float*)lse, nullptr, nullptr, Sq, Sk, KT, 0,
           tau};
  return launch<3, false>(q, k, v, p, BH, q_hs, kv_hs, (cudaStream_t)stream);
}

extern "C" int chipmunk_dense_colsum_attn(const void* q, const void* k,
                                          const void* v, const void* prev_lse,
                                          void* o, void* lse, void* cs, int BH,
                                          int Sq, int Sk, int q_hs, int kv_hs,
                                          int score_block, float tau,
                                          void* stream) {
  if (Sq < 128 || Sq % 128 || Sk < 1 || score_block < 64 || score_block % 64)
    return (int)cudaErrorInvalidValue;
  Params p{(__nv_bfloat16*)o, (float*)lse, (const float*)prev_lse, (float*)cs,
           Sq, Sk, score_block, (Sk + score_block - 1) / score_block, tau};
  return launch<2, true>(q, k, v, p, BH, q_hs, kv_hs,
                            (cudaStream_t)stream);
}
