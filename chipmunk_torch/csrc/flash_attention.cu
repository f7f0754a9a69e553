// Dense flash attention forward with a log2-domain lse, and its variant
// that also emits per-query-group column sums of the previous step's
// softmax.
//
// Replaces (TPU reference, Pallas):
//   dense_attn        <- chipmunk_tpu/kernels/flash_attention.py:55 (_flash_kernel)
//   dense_colsum_attn <- chipmunk_tpu/kernels/flash_attention.py:100 (_colsum_kernel)
//
// Bound on the H100: operations.  At the FLUX shape (24 heads, 4352 tokens,
// D = 128) one call is 4*S*S*D*H = 233 GFLOP against ~107 MB of q/k/v/o, so
// the tensor cores, not the 3.35 TB/s of HBM, set the floor (~0.24 ms at
// 989 TFLOP/s).
//
// q, k and v are read at a head stride of their own (q_hs, kv_hs
// elements), so a slice along S of a larger tensor -- the keys cut at a
// model's valid length, the query rows of a dense tail -- needs no copy;
// o and lse are fresh and contiguous.
//
// Design: the TPU kernel walks KV blocks as a sequential grid axis with
// (m, l, acc) in VMEM scratch; here that axis is a loop inside the block,
// and the state lives in registers of the warp that owns the rows
// (attn_tile.cuh).  mma.sync bf16 tiles with f32 accumulation; K/V tiles
// of 64 keys stream through a two-stage cp.async ring in shared memory,
// shared by all warps of the block and read with ldmatrix.  The colsum
// variant gives one block exactly one 128-row query group (8 warps), so a
// group's column sums are a block reduction with no atomics; they are
// normalised by the previous step's lse and therefore independent of the
// running max.  Later work: wgmma + TMA pipelines.
#include "attn_tile.cuh"

using namespace chipmunk;

namespace {

constexpr int KT = 64;   // keys per staged tile

struct NoHook {
  __device__ void operator()(int, float (*)[4]) const {}
};

template <int NW>
__global__ void __launch_bounds__(NW * 32)
dense_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int Sq, int Sk, int q_hs, int kv_hs, float tau) {
  extern __shared__ __align__(16) unsigned char smem[];
  KVStage<KT>* ring = reinterpret_cast<KVStage<KT>*>(smem);
  const int bh = blockIdx.y, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * NW * 16 + warp * 16;
  q += (size_t)bh * q_hs;
  k += (size_t)bh * kv_hs;
  v += (size_t)bh * kv_hs;
  WarpRows w;
  init_rows(w, q, row0, Sq);
  attend<KT, NW * 32>(w, ring, k, v, Sk, (Sk + KT - 1) / KT,
                      [](int i) { return i * KT; }, Sk, tau, NoHook());
  finish_rows(w, o + (size_t)bh * Sq * HD, lse + (size_t)bh * Sq, row0, Sq);
}

// One block = one query group of 8 warps x 16 = 128 rows.
// cs[bh, g, b] = sum over the group's rows i and the keys j of score block
// b of 2^(s_ij * tau - prev_lse_i).
__global__ void __launch_bounds__(256)
dense_colsum_attn_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const float* __restrict__ prev_lse,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, float* __restrict__ cs,
                         int Sq, int Sk, int q_hs, int kv_hs, int score_block,
                         float tau) {
  constexpr int NW = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  KVStage<KT>* ring = reinterpret_cast<KVStage<KT>*>(smem);
  __shared__ float red[NW];
  const int bh = blockIdx.y, grp = blockIdx.x, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int G = gridDim.x, nb = (Sk + score_block - 1) / score_block;
  const int row0 = grp * NW * 16 + warp * 16;
  q += (size_t)bh * q_hs;
  k += (size_t)bh * kv_hs;
  v += (size_t)bh * kv_hs;
  prev_lse += (size_t)bh * Sq;
  // padded query rows carry PAD_LSE, so they add exactly 0
  const float pl0 = row0 + g < Sq ? prev_lse[row0 + g] : PAD_LSE;
  const float pl1 = row0 + g + 8 < Sq ? prev_lse[row0 + g + 8] : PAD_LSE;
  float* cs_row = cs + ((size_t)bh * G + grp) * nb;
  WarpRows w;
  init_rows(w, q, row0, Sq);
  float part = 0.f;
  auto colsum = [&](int i, float (*s)[4]) {
    const int key0 = i * KT;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s[j][e] != NEG_INF) part += exp2f(s[j][e] - (e < 2 ? pl0 : pl1));
    if ((key0 + KT) % score_block == 0 || key0 + KT >= Sk) {
      // close the score block: warp sums, then a fixed-order block sum
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) red[warp] = part;
      __syncthreads();
      if (threadIdx.x == 0) {
        float tot = 0.f;
        for (int r = 0; r < NW; ++r) tot += red[r];
        cs_row[key0 / score_block] = tot;
      }
      part = 0.f;
    }
  };
  attend<KT, NW * 32>(w, ring, k, v, Sk, (Sk + KT - 1) / KT,
                      [](int i) { return i * KT; }, Sk, tau, colsum);
  finish_rows(w, o + (size_t)bh * Sq * HD, lse + (size_t)bh * Sq, row0, Sq);
}

}  // namespace

extern "C" int chipmunk_dense_attn(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int BH, int Sq, int Sk,
                                   int q_hs, int kv_hs, float tau,
                                   void* stream) {
  constexpr int NW = 4;
  constexpr int SMEM = kv_ring_bytes<KT>();
  static const int attr = allow_smem(dense_attn_kernel<NW>, SMEM);
  if (attr != 0) return attr;
  dim3 grid((Sq + NW * 16 - 1) / (NW * 16), BH);
  dense_attn_kernel<NW><<<grid, NW * 32, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, Sq, Sk, q_hs,
      kv_hs, tau);
  return (int)cudaGetLastError();
}

extern "C" int chipmunk_dense_colsum_attn(const void* q, const void* k,
                                          const void* v, const void* prev_lse,
                                          void* o, void* lse, void* cs, int BH,
                                          int Sq, int Sk, int q_hs, int kv_hs,
                                          int score_block, float tau,
                                          void* stream) {
  constexpr int SMEM = kv_ring_bytes<KT>();
  static const int attr = allow_smem(dense_colsum_attn_kernel, SMEM);
  if (attr != 0) return attr;
  dim3 grid(Sq / 128, BH);
  dense_colsum_attn_kernel<<<grid, 256, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const float*)prev_lse, (__nv_bfloat16*)o,
      (float*)lse, (float*)cs, Sq, Sk, q_hs, kv_hs, score_block, tau);
  return (int)cudaGetLastError();
}
