// Sparse-delta MLP step, in two passes behind one wrapper (csp_mlp_fused).
//
// Replaces (TPU reference, Pallas):
//   chipmunk_tpu/kernels/csp_mlp.py:326 (_fused_kernel, bf16-weight variant);
//   the passes are also the port's csp_mlp_mm1 (<- csp_mlp.py:93, _mm1_kernel)
//   and csp_mlp_mm2 (<- csp_mlp.py:216, _mm2_kernel).
//
//   mm1: for token tile x[t] and selected neuron block n of its bm-block,
//        act = fp8(gelu_tanh(x @ w1t[n]^T + b1[n])), packed = bf16(act - cache),
//        act_cache[t, n] = act   (in place; positions past the count give 0)
//   mm2: out_cache[t] = fp8(out_cache[t] + packed[t] @ w2[selected rows])
//        with f32 accumulation over all selected blocks.
//
// Bound on the H100: operations.  At the FLUX shape (T = 4608 tokens,
// C = 3072, ~15 selected 256-neuron blocks per 512-token block) each pass
// is 2 * T * 3840 * C = 109 GFLOP, ~0.11 ms at 989 TFLOP/s, while the
// bytes it must move (x, the selected weight rows, the caches) are tens
// of MB (~0.02 ms).
//
// Design: the TPU kernel keeps a [bm = 512, Cout = 3072] f32 accumulator
// (6 MB) in VMEM across the neuron blocks; no SM holds that, so the fused
// step is split where the reference splits it.  mm1 is a gathered GEMM on
// 128x128 output tiles (one per token tile, neuron sub-block) whose
// epilogue does bias, GELU, the fp8 rounding of the act *before* the delta
// (the kernel's numerics, not mlp_ref's), the delta and the cache refresh.
// mm2 is a 128x128 output-tile GEMM whose contraction runs only over the
// selected blocks.  Both are mma.sync bf16 with f32 accumulation fed by
// ldmatrix from a three-stage cp.async ring in shared memory (w2's rows
// are read transposed by ldmatrix.trans); wgmma/TMA come later.
#include "common.cuh"

using namespace chipmunk;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, NT = 256, STAGES = 3;
constexpr int LDA = BK + 8;    // [row][k] tiles: ldmatrix rows hit distinct banks
constexpr int LDB = BN + 8;    // [k][col] tile of mm2

struct Stage1 {                // mm1: x rows and w1t rows, both [row][k]
  __nv_bfloat16 a[BM * LDA];
  __nv_bfloat16 b[BN * LDA];
};

struct Stage2 {                // mm2: packed rows [row][k], w2 rows [k][col]
  __nv_bfloat16 a[BM * LDA];
  __nv_bfloat16 b[BK * LDB];
};

// A [128 x 32] tile with k contiguous: 512 chunks of 16 bytes, 2 a thread
__device__ __forceinline__ void issue_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           size_t ld) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int id = threadIdx.x + NT * u, row = id >> 2, c = (id & 3) * 8;
    cp_async16(dst + row * LDA + c, src + row * ld + c, true);
  }
}

// A [32 x 128] tile with the column contiguous (rows of w2)
__device__ __forceinline__ void issue_krows(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            size_t ld) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int id = threadIdx.x + NT * u, row = id >> 4, c = (id & 15) * 8;
    cp_async16(dst + row * LDB + c, src + row * ld + c, true);
  }
}

// 8 warps as 2 (rows) x 4 (cols); each warp owns a 64 x 32 output patch.
// A fragments come from a [row][k] tile; B fragments from a [col][k] tile
// (b_kmajor) or from a [k][col] tile through ldmatrix.trans.
template <bool b_kmajor>
__device__ __forceinline__ void mma_stage(float acc[4][4][4],
                                          const __nv_bfloat16* sa,
                                          const __nv_bfloat16* sb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldsm_x4(a[mt], sa + (wm * 64 + mt * 16 + (lane & 15)) * LDA + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      const int n = wn * 32 + np * 16;
      if (b_kmajor)   // matrices: (n 0-7 | 8-15) x (k 0-7 | 8-15)
        ldsm_x4(r, sb + (n + (mi >> 1) * 8 + (lane & 7)) * LDA + kk * 16 +
                       (mi & 1) * 8);
      else            // the same four, read transposed from [k][col]
        ldsm_x4_t(r, sb + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LDB + n +
                         (mi >> 1) * 8);
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// The k loop over n_k tiles of 32 through a STAGES-deep cp.async ring:
// issue(kt, stage) starts tile kt's copies, compute(stage) consumes one.
template <typename Stage, typename Issue, typename Compute>
__device__ __forceinline__ void k_loop(Stage* ring, int n_k, Issue issue,
                                       Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) issue(s, ring[s]);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // tile kt landed; tile kt-1's stage is free
    const int nxt = kt + STAGES - 1;
    if (nxt < n_k) issue(nxt, ring[nxt % STAGES]);
    cp_async_commit();
    compute(ring[kt % STAGES]);
  }
}

// Visit the C fragment: fn(mt, nt, h, row_in_tile, col_in_tile) for the
// element pair (acc[mt][nt][2h], acc[mt][nt][2h+1]) at cols col, col+1.
template <typename F>
__device__ __forceinline__ void for_each_pair(F fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(mt, nt, h, wm * 64 + mt * 16 + g + 8 * h, wn * 32 + nt * 8 + 2 * t);
}

// grid (T / 128, jmax * bn / 128)
__global__ void __launch_bounds__(NT)
csp_mlp_mm1_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w1t,
                   const __nv_bfloat16* __restrict__ b1,
                   uint8_t* __restrict__ act_cache,
                   const int* __restrict__ inds, const int* __restrict__ counts,
                   __nv_bfloat16* __restrict__ packed, int C, int N, int jmax,
                   int bn, int bm) {
  const int t0 = blockIdx.x * BM, m = t0 / bm;
  const int subs = bn / BN, j = blockIdx.y / subs, sub = blockIdx.y % subs;
  const size_t P = (size_t)jmax * bn;
  __nv_bfloat16* pk = packed + (size_t)t0 * P + (size_t)j * bn + sub * BN;
  if (j >= counts[m]) {
    // unselected slot: a zero delta, so consumers may read all jmax slots
    for (int id = threadIdx.x; id < BM * BN / 8; id += NT) {
      const int row = id / (BN / 8), c = (id % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(pk + row * P + c) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int n0 = inds[(size_t)m * jmax + j] * bn + sub * BN;
  const __nv_bfloat16* xa = x + (size_t)t0 * C;
  const __nv_bfloat16* wb = w1t + (size_t)n0 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][4] = {};
  k_loop(reinterpret_cast<Stage1*>(smem), C / BK,
         [&](int kt, Stage1& st) {
           issue_rows(st.a, xa + kt * BK, C);
           issue_rows(st.b, wb + kt * BK, C);
         },
         [&](const Stage1& st) { mma_stage<true>(acc, st.a, st.b); });
  for_each_pair([&](int mt, int nt, int h, int row, int col) {
    const int n = n0 + col;
    uint8_t* cache = act_cache + (size_t)(t0 + row) * N + n;
    const uint16_t old = *reinterpret_cast<const uint16_t*>(cache);
    const uint8_t a0 = f2fp8(gelu_tanh(acc[mt][nt][2 * h] + bf2f(b1[n])));
    const uint8_t a1 = f2fp8(gelu_tanh(acc[mt][nt][2 * h + 1] + bf2f(b1[n + 1])));
    *reinterpret_cast<uint32_t*>(pk + row * P + col) =
        pack_bf16(fp82f(a0) - fp82f(old & 0xff), fp82f(a1) - fp82f(old >> 8));
    *reinterpret_cast<uint16_t*>(cache) = (uint16_t)(a0 | (a1 << 8));
  });
}

// grid (T / 128, C / 128)
__global__ void __launch_bounds__(NT)
csp_mlp_mm2_kernel(const __nv_bfloat16* __restrict__ packed,
                   const __nv_bfloat16* __restrict__ w2,
                   uint8_t* __restrict__ out_cache,
                   const int* __restrict__ inds, const int* __restrict__ counts,
                   int C, int jmax, int bn, int bm) {
  const int t0 = blockIdx.x * BM, c0 = blockIdx.y * BN, m = t0 / bm;
  const size_t P = (size_t)jmax * bn;
  const int* row_inds = inds + (size_t)m * jmax;
  const int per_block = bn / BK, nk = counts[m] * per_block;
  const __nv_bfloat16* pa = packed + (size_t)t0 * P;
  auto a_src = [&](int kt) { return pa + (size_t)kt * BK; };
  auto b_src = [&](int kt) {
    const int j = kt / per_block, n = (kt % per_block) * BK;
    return w2 + ((size_t)row_inds[j] * bn + n) * C + c0;
  };
  float acc[4][4][4];
  for_each_pair([&](int mt, int nt, int h, int row, int col) {
    const uint16_t v = *reinterpret_cast<const uint16_t*>(
        out_cache + (size_t)(t0 + row) * C + c0 + col);
    acc[mt][nt][2 * h] = fp82f(v & 0xff);
    acc[mt][nt][2 * h + 1] = fp82f(v >> 8);
  });
  extern __shared__ __align__(16) unsigned char smem[];
  k_loop(reinterpret_cast<Stage2*>(smem), nk,
         [&](int kt, Stage2& st) {
           issue_rows(st.a, a_src(kt), P);
           issue_krows(st.b, b_src(kt), C);
         },
         [&](const Stage2& st) { mma_stage<false>(acc, st.a, st.b); });
  for_each_pair([&](int mt, int nt, int h, int row, int col) {
    *reinterpret_cast<uint16_t*>(out_cache + (size_t)(t0 + row) * C + c0 + col) =
        (uint16_t)(f2fp8(acc[mt][nt][2 * h]) | (f2fp8(acc[mt][nt][2 * h + 1]) << 8));
  });
}

}  // namespace

extern "C" int chipmunk_csp_mlp_mm1(const void* x, const void* w1t,
                                    const void* b1, void* act_cache,
                                    const void* inds, const void* counts,
                                    void* packed, int T, int C, int N, int jmax,
                                    int bn, int bm, void* stream) {
  constexpr int SMEM = STAGES * (int)sizeof(Stage1);
  static const int attr = (int)cudaFuncSetAttribute(
      csp_mlp_mm1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != 0) return attr;
  dim3 grid(T / BM, jmax * (bn / BN));
  csp_mlp_mm1_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1t,
      (const __nv_bfloat16*)b1, (uint8_t*)act_cache, (const int*)inds,
      (const int*)counts, (__nv_bfloat16*)packed, C, N, jmax, bn, bm);
  return (int)cudaGetLastError();
}

extern "C" int chipmunk_csp_mlp_mm2(const void* packed, const void* w2,
                                    void* out_cache, const void* inds,
                                    const void* counts, int T, int C, int jmax,
                                    int bn, int bm, void* stream) {
  constexpr int SMEM = STAGES * (int)sizeof(Stage2);
  static const int attr = (int)cudaFuncSetAttribute(
      csp_mlp_mm2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != 0) return attr;
  dim3 grid(T / BM, C / BN);
  csp_mlp_mm2_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)packed, (const __nv_bfloat16*)w2,
      (uint8_t*)out_cache, (const int*)inds, (const int*)counts, C, jmax, bn,
      bm);
  return (int)cudaGetLastError();
}
