// Flash-attention building blocks shared by flash_attention.cu and
// csp_attention.cu: head dim 128, bf16 operands, f32 softmax state.
//
// One warp owns 16 query rows.  Its Q fragments stay in registers for the
// whole key loop, its scores never leave registers (the C fragment of
// S = Q K^T is re-packed in place as the A fragment of P V), and K/V move
// through a two-stage ring of 64-key tiles in shared memory, filled by
// cp.async while the previous tile is in the tensor cores.  Both tiles are
// stored as they lie in memory ([key][d]); ldmatrix (.trans for V) turns
// them into mma fragments.  Softmax is base 2 with tau = log2(e)/sqrt(D)
// applied to the scores, running max and sum per row as in the TPU kernels.
#pragma once

#include "common.cuh"

namespace chipmunk {

constexpr int HD = 128;        // head dim
constexpr int LDK = HD + 8;    // padded row: ldmatrix rows hit distinct banks

template <int KT>
struct KVStage {
  __nv_bfloat16 k[KT * LDK];   // [key][d]
  __nv_bfloat16 v[KT * LDK];   // [key][d]
};

// Bytes of dynamic shared memory for the two-stage ring.
template <int KT>
constexpr int kv_ring_bytes() { return 2 * (int)sizeof(KVStage<KT>); }

// Start copying keys [key0, key0 + KT) of one head into a stage; rows at
// or past n_rows are zero-filled (the caller masks them out).
template <int KT, int NT>
__device__ __forceinline__ void issue_kv_tile(KVStage<KT>& st,
                                              const __nv_bfloat16* k,
                                              const __nv_bfloat16* v,
                                              int key0, int n_rows) {
  constexpr int CH = HD / 8;   // 16-byte chunks per row
  for (int i = threadIdx.x; i < KT * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = key0 + r < n_rows;
    const size_t off = ok ? (size_t)(key0 + r) * HD + c : 0;
    cp_async16(&st.k[r * LDK + c], k + off, ok);
    cp_async16(&st.v[r * LDK + c], v + off, ok);
  }
}

struct WarpRows {
  uint32_t qa[HD / 16][4];   // Q A-fragments, 8 contraction steps
  float o[HD / 8][4];        // output accumulator, 16 column tiles
  float m[2];                // running max of rows g and g+8 (scaled)
  float l[2];                // this thread's share of the running sums
};

// Load the warp's 16 query rows (row0 ...) straight into A fragments;
// rows at or past n_rows read as zero.
__device__ __forceinline__ void init_rows(WarpRows& w, const __nv_bfloat16* q,
                                          int row0, int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    w.qa[kk][0] = r0 < n_rows ? ld32(q + (size_t)r0 * HD + c) : 0u;
    w.qa[kk][1] = r1 < n_rows ? ld32(q + (size_t)r1 * HD + c) : 0u;
    w.qa[kk][2] = r0 < n_rows ? ld32(q + (size_t)r0 * HD + c + 8) : 0u;
    w.qa[kk][3] = r1 < n_rows ? ld32(q + (size_t)r1 * HD + c + 8) : 0u;
  }
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
    w.o[dn][0] = w.o[dn][1] = w.o[dn][2] = w.o[dn][3] = 0.f;
  w.m[0] = w.m[1] = NEG_INF;
  w.l[0] = w.l[1] = 0.f;
}

// s = (Q K^T) * tau for the stage's KT keys; keys with absolute index
// key0 + j >= key_limit get NEG_INF.
template <int KT>
__device__ __forceinline__ void tile_scores(float s[KT / 8][4],
                                            const WarpRows& w,
                                            const KVStage<KT>& st, float tau,
                                            int key0, int key_limit) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // matrix i of the x4 load: keys j*8.., d columns 8i.. of a 32-wide slab
    const __nv_bfloat16* kr = &st.k[(j * 8 + (lane & 7)) * LDK + (lane >> 3) * 8];
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, kr + kk * 32);
      mma_bf16(s[j], w.qa[2 * kk], b[0], b[1]);
      mma_bf16(s[j], w.qa[2 * kk + 1], b[2], b[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + j * 8 + 2 * t + (e & 1);
      s[j][e] = key < key_limit ? s[j][e] * tau : NEG_INF;
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Online-softmax step: fold the tile's scores into (m, l, o).  s is
// overwritten with the probabilities.  Masked entries contribute exactly
// 0, also when a whole tile is masked.
template <int KT>
__device__ __forceinline__ void tile_update(WarpRows& w, float s[KT / 8][4],
                                            const KVStage<KT>& st) {
  const int lane = threadIdx.x & 31;
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  const float mn0 = fmaxf(w.m[0], quad_max(mx0));
  const float mn1 = fmaxf(w.m[1], quad_max(mx1));
  const float a0 = exp2f(w.m[0] - mn0), a1 = exp2f(w.m[1] - mn1);
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mn = e < 2 ? mn0 : mn1;
      s[j][e] = s[j][e] == NEG_INF ? 0.f : exp2f(s[j][e] - mn);
    }
    ls0 += s[j][0] + s[j][1];
    ls1 += s[j][2] + s[j][3];
  }
  w.l[0] = w.l[0] * a0 + ls0;
  w.l[1] = w.l[1] * a1 + ls1;
  w.m[0] = mn0;
  w.m[1] = mn1;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    w.o[dn][0] *= a0; w.o[dn][1] *= a0;
    w.o[dn][2] *= a1; w.o[dn][3] *= a1;
  }
  // matrix i of the x4.trans load: keys 8(i&1).. of the 16-key step,
  // d columns 8(i>>1).. of a 16-wide pair of output tiles
  const int mi = lane >> 3;
  const __nv_bfloat16* vr =
      &st.v[((mi & 1) * 8 + (lane & 7)) * LDK + (mi >> 1) * 8];
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    // P (bf16, as the TPU kernel casts p to V's dtype) as an A fragment
    const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                            pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                            pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                            pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < HD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_t(b, vr + kk * 16 * LDK + dp * 16);
      mma_bf16(w.o[2 * dp], pa, b[0], b[1]);
      mma_bf16(w.o[2 * dp + 1], pa, b[2], b[3]);
    }
  }
}

// The key loop of one block: n_tiles tiles, tile i starting at key
// key_of(i) of the head's n_rows keys, keys at or past key_limit masked.
// on_scores(i, s) sees each tile's scaled scores before the softmax step
// (it must be called, and may synchronise, uniformly across the block).
template <int KT, int NT, typename KeyOf, typename OnScores>
__device__ __forceinline__ void attend(WarpRows& w, KVStage<KT>* ring,
                                       const __nv_bfloat16* k,
                                       const __nv_bfloat16* v, int n_rows,
                                       int n_tiles, KeyOf key_of,
                                       int key_limit, float tau,
                                       OnScores on_scores) {
  if (n_tiles > 0) issue_kv_tile<KT, NT>(ring[0], k, v, key_of(0), n_rows);
  cp_async_commit();
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles)
      issue_kv_tile<KT, NT>(ring[(i + 1) & 1], k, v, key_of(i + 1), n_rows);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float s[KT / 8][4];
    tile_scores<KT>(s, w, ring[i & 1], tau, key_of(i), key_limit);
    on_scores(i, s);
    tile_update<KT>(w, s, ring[i & 1]);
    __syncthreads();   // the stage is refilled two tiles later
  }
}

// o = acc / l (l == 0 guarded to 1) as bf16; lse = m + log2(l) when
// lse != nullptr.  Rows at or past n_rows are not written.
__device__ __forceinline__ void finish_rows(WarpRows& w, __nv_bfloat16* o,
                                            float* lse, int row0, int n_rows) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + g + 8 * h;
    float l = quad_sum(w.l[h]);
    l = l == 0.f ? 1.f : l;
    if (r >= n_rows) continue;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn)
      *reinterpret_cast<uint32_t*>(o + (size_t)r * HD + dn * 8 + 2 * t) =
          pack_bf16(w.o[dn][2 * h] / l, w.o[dn][2 * h + 1] / l);
    if (lse != nullptr && t == 0) lse[r] = w.m[h] + log2f(l);
  }
}

// Allow a kernel the ring's dynamic shared memory (above the 48 KB
// default); returns the cudaError_t of the attribute call.
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace chipmunk
