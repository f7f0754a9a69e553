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
//
// Score blocks of 1-32 keys (DenseKeysG<P>, attn_sm90.cuh: CS_P): each
// consumer thread hands over P partials a tile (32 at one key, 16 at 2,
// 4 and 8, 8 at 16, 4 at 32) through a ring of 2 x P KB, and the
// producer's warps 1-3 reduce them and store each block's sum once into
// the CTA's row in global memory, so any nb fits.  Query groups other
// than 128 rows (qg, any divisor of Sq; the same DenseKeysG, GROUPED):
// ceil(qg / 128) CTAs a group, rows past the group computed but neither
// stored nor summed.  With more than one CTA a group each writes its own
// partial row and colsum_fold_kernel sums the group's rows in order.  The
// 128-row groups at score blocks of 64 keys or more keep DenseKeys, the
// code of the main paths.
#include "attn_sm90.cuh"

using namespace chipmunk;
using namespace chipmunk::sm90;

namespace {

// Keys 0 .. Sk - 1 in order, tile i from key i * KT; keys past Sk masked.
struct DenseKeys {
  static constexpr bool GROUPED = false;
  static constexpr int CS_P = 0;
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

// Query groups of p.qg rows in p.cpg CTAs each, and column sums of P
// partials a thread (attn_sm90.cuh); the keys as DenseKeys.
template <int P>
struct DenseKeysG : DenseKeys {
  static constexpr bool GROUPED = true;
  static constexpr int CS_P = P;
  using DenseKeys::DenseKeys;
};

template <int ST, bool CS, class Keys = DenseKeys>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int BH, int q_hs, int kv_hs, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_head_map(&tq, q, BH, p.Sq, q_hs, BM);
  if (err == 0) err = make_head_map(&tk, k, BH, p.Sk, kv_hs, KT);
  if (err == 0) err = make_head_map(&tv, v, BH, p.Sk, kv_hs, KT);
  if (err != 0) return err;
  // column sums: the hand-off ring, and below 64-key blocks no slots
  constexpr int P = Keys::CS_P;
  return launch_attn<ST, CS, Keys>(
      tq, tk, tv, p,
      Keys::GROUPED ? p.Sq / p.qg * p.cpg : (p.Sq + BM - 1) / BM, BH,
      ring_bytes<ST>() + (CS ? hand_bytes<P>() + (P ? 0 : 4 * p.nb) : 0),
      stream);
}

// cs[bh][g][b] = sum over k < cpg, in order, of part[bh][g cpg + k][b]:
// the rows of a group's CTAs.  Grid (ceil(nb / 256), G, BH).
__global__ void colsum_fold_kernel(const float* __restrict__ part,
                                   float* __restrict__ cs, int cpg, int nb) {
  const int b = blockIdx.x * 256 + threadIdx.x;
  if (b >= nb) return;
  const size_t row = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const float* src = part + row * cpg * nb + b;
  float v = src[0];
  for (int k = 1; k < cpg; ++k) v += src[(size_t)k * nb];
  cs[row * nb + b] = v;
}

// The column-sum kernel for p.score_block (1, 2, 4, 8, 16, 32 or a
// multiple of 64) and p.qg.
int launch_colsum(const void* q, const void* k, const void* v,
                  const Params& p, int BH, int q_hs, int kv_hs,
                  cudaStream_t stream) {
  const int sb = p.score_block;
  if (sb % 64 == 0)
    return p.qg == BM ? launch<2, true>(q, k, v, p, BH, q_hs, kv_hs, stream)
                      : launch<2, true, DenseKeysG<0>>(q, k, v, p, BH, q_hs,
                                                       kv_hs, stream);
  if (sb == 1)
    return launch<2, true, DenseKeysG<32>>(q, k, v, p, BH, q_hs, kv_hs,
                                           stream);
  if (sb == 2 || sb == 4 || sb == 8)
    return launch<2, true, DenseKeysG<16>>(q, k, v, p, BH, q_hs, kv_hs,
                                           stream);
  if (sb == 16)
    return launch<2, true, DenseKeysG<8>>(q, k, v, p, BH, q_hs, kv_hs,
                                          stream);
  if (sb == 32)
    return launch<2, true, DenseKeysG<4>>(q, k, v, p, BH, q_hs, kv_hs,
                                          stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The largest number of score blocks of score_block keys whose column
// sums a CTA can hold (dense_colsum_attn raises above it): the slots
// beside the ring for 64 keys or more; below 64 the sums go to global
// memory and any number fits.
extern "C" int chipmunk_colsum_max_blocks(int score_block) {
  if (score_block < 64) return 0x7fffffff;
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

// cs [BH][Sq / qg][nb]; part: [BH][Sq / qg * cpg][nb] scratch where a
// group has cpg = ceil(qg / 128) > 1 CTAs, else unused.
extern "C" int chipmunk_dense_colsum_attn(const void* q, const void* k,
                                          const void* v, const void* prev_lse,
                                          void* o, void* lse, void* cs,
                                          void* part, int BH, int Sq, int Sk,
                                          int q_hs, int kv_hs, int qg,
                                          int score_block, float tau,
                                          void* stream) {
  if (Sq < 1 || qg < 1 || Sq % qg || Sk < 1 || score_block < 1)
    return (int)cudaErrorInvalidValue;
  const int cpg = (qg + BM - 1) / BM;
  if (cpg > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  Params p{(__nv_bfloat16*)o, (float*)lse, (const float*)prev_lse,
           (float*)(cpg > 1 ? part : cs), Sq, Sk, score_block,
           (Sk + score_block - 1) / score_block, tau};
  p.qg = qg;
  p.cpg = cpg;
  const cudaStream_t st = (cudaStream_t)stream;
  const int err = launch_colsum(q, k, v, p, BH, q_hs, kv_hs, st);
  if (err != 0 || cpg == 1) return err;
  colsum_fold_kernel<<<dim3((p.nb + 255) / 256, Sq / qg, BH), 256, 0, st>>>(
      (const float*)part, (float*)cs, cpg, p.nb);
  return (int)cudaGetLastError();
}
