// Sparse-delta MLP step, in two passes behind one wrapper (csp_mlp_fused),
// in three weight/activation variants.
//
// Replaces (TPU reference, Pallas), chipmunk_tpu/kernels/csp_mlp.py:
//   :326 _fused_kernel, as the pair of passes below, for
//     bf16 weights (csp_mlp_mm1/mm2), int8 QTensor weights with bf16
//     activations (`wq`: csp_mlp_mm1_wq/mm2_wq) and int8 weights with int8
//     activations (`wq` + `a8`: quant_rows, csp_mlp_mm1_a8/mm2_a8);
//   :93 _mm1_kernel and :216 _mm2_kernel (bf16 and `wq` int8), which
//     compute the same functions as the first two pairs.
//
//   mm1: for token tile x[t] and selected neuron block n of its bm-block,
//        act = fp8(gelu_tanh(x @ w1t[n]^T + b1[n])), delta = act - cache,
//        act_cache[t, n] = act   (in place; positions past the count give 0)
//   mm2: out_cache[t] = fp8(out_cache[t] + delta[t] @ w2[selected rows])
//        with f32 accumulation over all selected blocks.
//
// Bound on the H100: operations.  At the FLUX shape (T = 4608 tokens,
// C = 3072, ~15 selected 256-neuron blocks per 512-token block) each pass
// is 2 * T * 3840 * C = 109 GOP, ~0.11 ms at 989 TFLOP/s in bf16 and
// ~0.055 ms at 1979 TOP/s in int8, while the bytes it must move (x, the
// selected weight rows, the caches) are tens of MB (~0.01-0.02 ms).
//
// Design: the TPU kernel keeps a [bm = 512, Cout = 3072] f32 accumulator
// (6 MB) in VMEM across the neuron blocks; no SM holds that, so the fused
// step is split where the reference splits it.  mm1 is a gathered GEMM
// whose epilogue does bias, GELU, the fp8 rounding of the act *before* the
// delta (the kernel's numerics, not mlp_ref's), the delta and the cache
// refresh; mm2 is a GEMM whose contraction runs only over the selected
// blocks.  All are mma.sync (bf16 -> f32 or s8 -> s32) fed by ldmatrix from
// cp.async rings in shared memory (gemm_tile.cuh); wgmma/TMA come later.
//
// The `wq` variant converts each int8 weight tile to bf16 while staging it
// (exact) and applies the scales where the reference does: mm1 after the
// product (fma(mid, w1s[n], b1[n])), mm2 on the delta before it
// (delta * bf16(w2s[k]), in bf16).
//
// The `a8` variant follows _fused_kernel's operation order (:359-434):
//   quant_rows: sx = max(max_c |x|, 1e-6) / 127, x8 = clip(rint(x / sx))
//   mm1: mid = fma(f32(int32(x8 . w1q[n])), sx * w1s[n], b1[n]); act and
//        delta as above; ds = delta * w2s[n];
//        sd = max(max over the block's bn neurons |ds|, 1e-12) / 127,
//        d8 = clip(rint(ds / sd))  -> d8 [T, jmax*bn] int8, sd [T, jmax]
//   mm2: acc = f32(out_cache); for each valid block j in order:
//        acc = fma(f32(int32(d8_j . w2q[block j])), sd_j, acc)
// The row max of |ds| spans the whole neuron block, so one mm1 CTA covers
// 64 tokens x all bn (<= 256) neurons.  mm2 flushes its int32 sum into the
// f32 accumulator at every block boundary (each block has its own scale).
// int32 range: |x8 . w1q| <= C * 127^2 = 4.96e7 at C = 3072 and
// |d8 . w2q| <= bn * 127^2, far inside 2^31.  The scalar steps are spelled
// out with the _rn intrinsics: each multiply-add the reference's XLA fuses
// (mid * s + b1, acc + dot * sd) is one fma, every other step rounds on
// its own.  With the integer products exact, x8/sx, d8/sd and (where the
// acts agree) the caches then match the reference bit for bit.
#include "gemm_tile.cuh"

using namespace chipmunk;
using namespace chipmunk::tile;

namespace {

// An unselected slot: zero its [rows x bytes] slice of a row-major array
// (row stride ld bytes), so consumers may read all jmax slots.
__device__ __forceinline__ void zero_slot(void* dst, int rows, int bytes,
                                          size_t ld) {
  for (int id = threadIdx.x; id < rows * bytes / 16; id += NT) {
    const int row = id / (bytes / 16), c = (id % (bytes / 16)) * 16;
    *reinterpret_cast<uint4*>(static_cast<uint8_t*>(dst) + row * ld + c) =
        make_uint4(0, 0, 0, 0);
  }
}

// Two neighbouring fp8 cache entries as floats, and back.
__device__ __forceinline__ float2 ld_fp8x2(const uint8_t* p) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(p);
  return make_float2(fp82f(v & 0xff), fp82f(v >> 8));
}

__device__ __forceinline__ void st_fp8x2(uint8_t* p, float a, float b) {
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)(f2fp8(a) | (f2fp8(b) << 8));
}

// The act of two neighbouring neurons, fp8(gelu_tanh(mid)), written to the
// cache; returns its delta against the old cache entries.
__device__ __forceinline__ float2 refresh_act(uint8_t* cache, float mid0,
                                              float mid1) {
  const float2 old = ld_fp8x2(cache);
  const uint8_t a0 = f2fp8(gelu_tanh(mid0)), a1 = f2fp8(gelu_tanh(mid1));
  *reinterpret_cast<uint16_t*>(cache) = (uint16_t)(a0 | (a1 << 8));
  return make_float2(fp82f(a0) - old.x, fp82f(a1) - old.y);
}

// ---------------------------------------------------------------- bf16

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
  if (j >= counts[m]) return zero_slot(pk, BM, BN * 2, P * 2);
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
    const float2 d = refresh_act(act_cache + (size_t)(t0 + row) * N + n,
                                 acc[mt][nt][2 * h] + bf2f(b1[n]),
                                 acc[mt][nt][2 * h + 1] + bf2f(b1[n + 1]));
    *reinterpret_cast<uint32_t*>(pk + row * P + col) = pack_bf16(d.x, d.y);
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
    const float2 v = ld_fp8x2(out_cache + (size_t)(t0 + row) * C + c0 + col);
    acc[mt][nt][2 * h] = v.x;
    acc[mt][nt][2 * h + 1] = v.y;
  });
  extern __shared__ __align__(16) unsigned char smem[];
  k_loop(reinterpret_cast<Stage2*>(smem), nk,
         [&](int kt, Stage2& st) {
           issue_rows(st.a, a_src(kt), P);
           issue_krows(st.b, b_src(kt), C);
         },
         [&](const Stage2& st) { mma_stage<false>(acc, st.a, st.b); });
  for_each_pair([&](int mt, int nt, int h, int row, int col) {
    st_fp8x2(out_cache + (size_t)(t0 + row) * C + c0 + col, acc[mt][nt][2 * h],
             acc[mt][nt][2 * h + 1]);
  });
}

// --------------------------------------------- wq: int8 weights, bf16 x

// grid (T / 128, jmax * bn / 128).  As csp_mlp_mm1_kernel; the w1 tile
// [128 n][32 k] int8 (W4: one nibble plane of the packed [N, C/2] bytes)
// arrives through registers and is stored as bf16.
template <bool W4>
__global__ void __launch_bounds__(NT)
csp_mlp_mm1_wq_kernel(const __nv_bfloat16* __restrict__ x,
                      const int8_t* __restrict__ w1q,
                      const float* __restrict__ w1s,
                      const __nv_bfloat16* __restrict__ b1,
                      uint8_t* __restrict__ act_cache,
                      const int* __restrict__ inds,
                      const int* __restrict__ counts,
                      __nv_bfloat16* __restrict__ packed, int C, int N,
                      int jmax, int bn, int bm) {
  const int t0 = blockIdx.x * BM, m = t0 / bm;
  const int subs = bn / BN, j = blockIdx.y / subs, sub = blockIdx.y % subs;
  const size_t P = (size_t)jmax * bn;
  __nv_bfloat16* pk = packed + (size_t)t0 * P + (size_t)j * bn + sub * BN;
  if (j >= counts[m]) return zero_slot(pk, BM, BN * 2, P * 2);
  const int n0 = inds[(size_t)m * jmax + j] * bn + sub * BN;
  const __nv_bfloat16* xa = x + (size_t)t0 * C;
  const int wld = W4 ? C / 2 : C;         // bytes per weight row
  const int8_t* wb = w1q + (size_t)n0 * wld;
  __shared__ __align__(16) Stage1 buf[2];
  uint32_t breg[4];            // 4 words of [128 n][32 k] bytes a thread
  float acc[4][4][4] = {};
  k_loop_staged(
      buf, C / BK,
      [&](int kt, Stage1& st) { issue_rows(st.a, xa + kt * BK, C); },
      [&](int kt) {
        // k < C/2 is the low nibble plane of column k, k >= C/2 the high
        // plane of column k - C/2
        const int plane = W4 ? kt * BK >= C / 2 : -1;
        const int kc = kt * BK - (plane > 0 ? C / 2 : 0);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int id = threadIdx.x + NT * u, n = id >> 3, kq = id & 7;
          breg[u] = w_bytes(*reinterpret_cast<const uint32_t*>(
              wb + (size_t)n * wld + kc + 4 * kq), plane);
        }
      },
      [&](Stage1& st) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int id = threadIdx.x + NT * u, n = id >> 3, kq = id & 7;
          *reinterpret_cast<uint2*>(st.b + n * LDA + 4 * kq) =
              s8x4_to_bf16(breg[u]);
        }
      },
      [&](const Stage1& st) { mma_stage<true>(acc, st.a, st.b); },
      [](int) {});
  for_each_pair([&](int mt, int nt, int h, int row, int col) {
    const int n = n0 + col;
    const float2 d = refresh_act(
        act_cache + (size_t)(t0 + row) * N + n,
        __fmaf_rn(acc[mt][nt][2 * h], w1s[n], bf2f(b1[n])),
        __fmaf_rn(acc[mt][nt][2 * h + 1], w1s[n + 1], bf2f(b1[n + 1])));
    *reinterpret_cast<uint32_t*>(pk + row * P + col) = pack_bf16(d.x, d.y);
  });
}

struct Stage2Q {               // Stage2 + the bf16 scales of its 32 k rows
  Stage2 s;
  __nv_bfloat162 scale[BK / 2];
};

// grid (T / 128, C / 128).  As csp_mlp_mm2_kernel; the w2 tile [32 k][128
// c] int8 (W4: one nibble plane of the packed [N, C/2] bytes) arrives
// through registers and is stored as bf16, and the packed delta's
// fragments are multiplied by bf16(w2s[k]) before the product.
template <bool W4>
__global__ void __launch_bounds__(NT)
csp_mlp_mm2_wq_kernel(const __nv_bfloat16* __restrict__ packed,
                      const int8_t* __restrict__ w2q,
                      const float* __restrict__ w2s,
                      uint8_t* __restrict__ out_cache,
                      const int* __restrict__ inds,
                      const int* __restrict__ counts, int C, int jmax, int bn,
                      int bm) {
  const int t0 = blockIdx.x * BM, c0 = blockIdx.y * BN, m = t0 / bm;
  const size_t P = (size_t)jmax * bn;
  const int* row_inds = inds + (size_t)m * jmax;
  const int per_block = bn / BK, nk = counts[m] * per_block;
  const __nv_bfloat16* pa = packed + (size_t)t0 * P;
  // output columns c < C/2 are the low nibble plane of byte column c,
  // c >= C/2 the high plane of byte column c - C/2
  const int wld = W4 ? C / 2 : C, plane = W4 ? c0 >= C / 2 : -1;
  const int cb = c0 - (plane > 0 ? C / 2 : 0);
  float acc[4][4][4];
  for_each_pair([&](int mt, int nt, int h, int row, int col) {
    const float2 v = ld_fp8x2(out_cache + (size_t)(t0 + row) * C + c0 + col);
    acc[mt][nt][2 * h] = v.x;
    acc[mt][nt][2 * h + 1] = v.y;
  });
  __shared__ __align__(16) Stage2Q buf[2];
  uint32_t breg[4];            // 4 words of [32 k][128 c] bytes a thread
  float2 sreg = make_float2(0.f, 0.f);
  k_loop_staged(
      buf, nk,
      [&](int kt, Stage2Q& st) { issue_rows(st.s.a, pa + (size_t)kt * BK, P); },
      [&](int kt) {
        const int j = kt / per_block, n = (kt % per_block) * BK;
        const size_t k0 = (size_t)row_inds[j] * bn + n;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int id = threadIdx.x + NT * u, k = id >> 5, cq = id & 31;
          breg[u] = w_bytes(*reinterpret_cast<const uint32_t*>(
              w2q + (k0 + k) * wld + cb + 4 * cq), plane);
        }
        if (threadIdx.x < BK / 2)
          sreg = make_float2(w2s[k0 + 2 * threadIdx.x],
                             w2s[k0 + 2 * threadIdx.x + 1]);
      },
      [&](Stage2Q& st) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int id = threadIdx.x + NT * u, k = id >> 5, cq = id & 31;
          *reinterpret_cast<uint2*>(st.s.b + k * LDB + 4 * cq) =
              s8x4_to_bf16(breg[u]);
        }
        if (threadIdx.x < BK / 2)
          st.scale[threadIdx.x] = __floats2bfloat162_rn(sreg.x, sreg.y);
      },
      [&](const Stage2Q& st) {
        mma_stage<false>(acc, st.s.a, st.s.b, st.scale);
      },
      [](int) {});
  for_each_pair([&](int mt, int nt, int h, int row, int col) {
    st_fp8x2(out_cache + (size_t)(t0 + row) * C + c0 + col, acc[mt][nt][2 * h],
             acc[mt][nt][2 * h + 1]);
  });
}

// ---------------------------------------------- a8: int8 weights and x

constexpr int BM8 = 64;        // token rows of an a8 CTA

// x [T, C] bf16 -> x8 [T, C] int8, sx [T] f32; one CTA per row
__global__ void __launch_bounds__(NT)
quant_rows_kernel(const __nv_bfloat16* __restrict__ x, int8_t* __restrict__ x8,
                  float* __restrict__ sx, int C) {
  const size_t r = blockIdx.x;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + r * C);
  float m = 0.0f;
  for (int i = threadIdx.x; i < C / 2; i += NT) {
    const float2 v = __bfloat1622float2(xr[i]);
    m = nanmax(m, nanmax(fabsf(v.x), fabsf(v.y)));
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) m = nanmax(m, __shfl_xor_sync(~0u, m, o));
  __shared__ float part[NT / 32];
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = m;
  __syncthreads();
  m = part[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) m = nanmax(m, part[w]);
  const float s = __fmul_rn(nanmax(m, 1e-6f), INV127);
  if (threadIdx.x == 0) sx[r] = s;
  uint16_t* out = reinterpret_cast<uint16_t*>(x8 + r * C);
  for (int i = threadIdx.x; i < C / 2; i += NT) {
    const float2 v = __bfloat1622float2(xr[i]);
    out[i] = (uint16_t)((q8(__fdiv_rn(v.x, s)) & 0xff) |
                        ((q8(__fdiv_rn(v.y, s)) & 0xff) << 8));
  }
}

// grid (T / 64, jmax).  One CTA: 64 tokens x the whole neuron block of
// BNB (= bn) neurons, so the row max of |ds| over the block is local: the
// 4 warps across the block meet in shared memory.  x8 and w1q rows both
// have k contiguous and go through a 3-stage cp.async ring; int4 weights
// (W4) are widened to int8 through registers, double-buffered.
template <int BNB, bool W4>
__global__ void __launch_bounds__(NT)
csp_mlp_mm1_a8_kernel(const int8_t* __restrict__ x8,
                      const float* __restrict__ sx,
                      const int8_t* __restrict__ w1q,
                      const float* __restrict__ w1s,
                      const __nv_bfloat16* __restrict__ b1,
                      const float* __restrict__ w2s,
                      uint8_t* __restrict__ act_cache,
                      const int* __restrict__ inds,
                      const int* __restrict__ counts,
                      int8_t* __restrict__ d8, float* __restrict__ sd, int C,
                      int N, int jmax, int bm) {
  constexpr int NTW = BNB / 32;     // 8-wide n tiles per warp (4 across)
  using Stage = StageS8<BM8, BNB>;
  const int t0 = blockIdx.x * BM8, m = t0 / bm, j = blockIdx.y;
  const size_t P = (size_t)jmax * BNB;
  int8_t* dq = d8 + (size_t)t0 * P + (size_t)j * BNB;
  float* so = sd + (size_t)t0 * jmax + j;
  if (j >= counts[m]) {
    if (threadIdx.x < BM8) so[(size_t)threadIdx.x * jmax] = 0.0f;
    return zero_slot(dq, BM8, BNB, P);
  }
  const int n0 = inds[(size_t)m * jmax + j] * BNB;
  const int8_t* xa = x8 + (size_t)t0 * C;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[BM8][4];
  int acc[2][NTW][4] = {};
  auto compute = [&](const Stage& st) {
    mma_stage_s8<2, NTW, false>(acc, st.a, st.b);
  };
  if constexpr (W4) {
    const int8_t* wb = w1q + (size_t)n0 * (C / 2);
    constexpr int WORDS = BNB * BK8 / 4 / NT;   // B words a thread stages
    uint32_t breg[WORDS];
    k_loop_staged(
        reinterpret_cast<Stage*>(smem), C / BK8,
        [&](int kt, Stage& st) { issue_rows8<BM8>(st.a, xa + kt * BK8, C); },
        [&](int kt) {
          const int plane = kt * BK8 >= C / 2;
          const int kc = kt * BK8 - (plane ? C / 2 : 0);
#pragma unroll
          for (int u = 0; u < WORDS; ++u) {
            const int id = threadIdx.x + NT * u, n = id >> 4, w = id & 15;
            breg[u] = w_bytes(*reinterpret_cast<const uint32_t*>(
                wb + (size_t)n * (C / 2) + kc + 4 * w), plane);
          }
        },
        [&](Stage& st) {
#pragma unroll
          for (int u = 0; u < WORDS; ++u) {
            const int id = threadIdx.x + NT * u, n = id >> 4, w = id & 15;
            *reinterpret_cast<uint32_t*>(st.b + n * LDA8 + 4 * w) = breg[u];
          }
        },
        compute, [](int) {});
  } else {
    const int8_t* wb = w1q + (size_t)n0 * C;
    k_loop(reinterpret_cast<Stage*>(smem), C / BK8,
           [&](int kt, Stage& st) {
             issue_rows8<BM8>(st.a, xa + kt * BK8, C);
             issue_rows8<BNB>(st.b, wb + kt * BK8, C);
           },
           compute);
  }
  // epilogue 1: act, cache refresh, ds = delta * w2s; row max of |ds|
  const int lane = threadIdx.x & 31, wn = (threadIdx.x >> 5) & 3;
  float ds[2][NTW][4], rmax[2][2] = {};
  for_each_pair_s8<2, NTW>([&](int mt, int nt, int h, int row, int col) {
    const int n = n0 + col;
    const float s = sx[t0 + row];
    const float2 d = refresh_act(
        act_cache + (size_t)(t0 + row) * N + n,
        __fmaf_rn((float)acc[mt][nt][2 * h], __fmul_rn(s, w1s[n]),
                  bf2f(b1[n])),
        __fmaf_rn((float)acc[mt][nt][2 * h + 1], __fmul_rn(s, w1s[n + 1]),
                  bf2f(b1[n + 1])));
    const float v0 = __fmul_rn(d.x, w2s[n]), v1 = __fmul_rn(d.y, w2s[n + 1]);
    ds[mt][nt][2 * h] = v0;
    ds[mt][nt][2 * h + 1] = v1;
    rmax[mt][h] = nanmax(rmax[mt][h], nanmax(fabsf(v0), fabsf(v1)));
  });
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rmax[mt][h];
      v = nanmax(v, __shfl_xor_sync(~0u, v, 1));
      v = nanmax(v, __shfl_xor_sync(~0u, v, 2));
      rmax[mt][h] = v;
    }
  for_each_pair_s8<2, NTW>([&](int mt, int nt, int h, int row, int col) {
    if (nt == 0 && (lane & 3) == 0) red[row][wn] = rmax[mt][h];
  });
  __syncthreads();
  // epilogue 2: the block's scale per row, then d8
  for_each_pair_s8<2, NTW>([&](int mt, int nt, int h, int row, int col) {
    const float mx = nanmax(nanmax(red[row][0], red[row][1]),
                            nanmax(red[row][2], red[row][3]));
    const float s = __fmul_rn(nanmax(mx, 1e-12f), INV127);
    *reinterpret_cast<uint16_t*>(dq + (size_t)row * P + col) = (uint16_t)(
        (q8(__fdiv_rn(ds[mt][nt][2 * h], s)) & 0xff) |
        ((q8(__fdiv_rn(ds[mt][nt][2 * h + 1], s)) & 0xff) << 8));
    if (nt == 0 && wn == 0 && (lane & 3) == 0) so[(size_t)row * jmax] = s;
  });
}

// grid (T / 64, C / 128).  acc = f32(out_cache); the k loop runs over the
// selected blocks' rows of w2q ([k][c] bytes, W4: one nibble plane of the
// packed [N, C/2] bytes, transposed on the way into shared memory) and
// flushes the int32 sum, times sd of that block, into acc at every block
// boundary.
template <bool W4>
__global__ void __launch_bounds__(NT)
csp_mlp_mm2_a8_kernel(const int8_t* __restrict__ d8,
                      const float* __restrict__ sd,
                      const int8_t* __restrict__ w2q,
                      uint8_t* __restrict__ out_cache,
                      const int* __restrict__ inds,
                      const int* __restrict__ counts, int C, int jmax, int bn,
                      int bm) {
  using Stage = StageS8T<BM8>;
  const int t0 = blockIdx.x * BM8, c0 = blockIdx.y * BN8, m = t0 / bm;
  const size_t P = (size_t)jmax * bn;
  const int* row_inds = inds + (size_t)m * jmax;
  const int per_block = bn / BK8, nk = counts[m] * per_block;
  const int8_t* pa = d8 + (size_t)t0 * P;
  const int wld = W4 ? C / 2 : C, plane = W4 ? c0 >= C / 2 : -1;
  const int cb = c0 - (plane > 0 ? C / 2 : 0);
  float acc[2][4][4];
  int iacc[2][4][4] = {};
  for_each_pair_s8<2, 4>([&](int mt, int nt, int h, int row, int col) {
    const float2 v = ld_fp8x2(out_cache + (size_t)(t0 + row) * C + c0 + col);
    acc[mt][nt][2 * h] = v.x;
    acc[mt][nt][2 * h + 1] = v.y;
  });
  __shared__ __align__(16) Stage buf[2];
  uint32_t breg[2][4];
  k_loop_staged(
      buf, nk,
      [&](int kt, Stage& st) {
        issue_rows8<BM8>(st.a, pa + (size_t)kt * BK8, P);
      },
      [&](int kt) {
        const int j = kt / per_block, n = (kt % per_block) * BK8;
        load_kn8(breg, w2q + ((size_t)row_inds[j] * bn + n) * wld + cb, wld,
                 plane);
      },
      [&](Stage& st) { store_kn8(breg, st.b); },
      [&](const Stage& st) { mma_stage_s8<2, 4, true>(iacc, st.a, st.b); },
      [&](int kt) {
        if ((kt + 1) % per_block) return;
        const int j = kt / per_block;
        for_each_pair_s8<2, 4>([&](int mt, int nt, int h, int row, int col) {
          const float s = sd[(size_t)(t0 + row) * jmax + j];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int& v = iacc[mt][nt][2 * h + e];
            acc[mt][nt][2 * h + e] = __fmaf_rn((float)v, s,
                                               acc[mt][nt][2 * h + e]);
            v = 0;
          }
        });
      });
  for_each_pair_s8<2, 4>([&](int mt, int nt, int h, int row, int col) {
    st_fp8x2(out_cache + (size_t)(t0 + row) * C + c0 + col, acc[mt][nt][2 * h],
             acc[mt][nt][2 * h + 1]);
  });
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" int chipmunk_csp_mlp_mm1(const void* x, const void* w1t,
                                    const void* b1, void* act_cache,
                                    const void* inds, const void* counts,
                                    void* packed, int T, int C, int N, int jmax,
                                    int bn, int bm, void* stream) {
  constexpr int SMEM = STAGES * (int)sizeof(Stage1);
  static const int attr = set_smem(csp_mlp_mm1_kernel, SMEM);
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
  static const int attr = set_smem(csp_mlp_mm2_kernel, SMEM);
  if (attr != 0) return attr;
  dim3 grid(T / BM, C / BN);
  csp_mlp_mm2_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)packed, (const __nv_bfloat16*)w2,
      (uint8_t*)out_cache, (const int*)inds, (const int*)counts, C, jmax, bn,
      bm);
  return (int)cudaGetLastError();
}

// w4: the weights are int4 plane-packed ([N, C/2] bytes), else int8
extern "C" int chipmunk_csp_mlp_mm1_wq(const void* x, const void* w1q,
                                       const void* w1s, const void* b1,
                                       void* act_cache, const void* inds,
                                       const void* counts, void* packed,
                                       int T, int C, int N, int jmax, int bn,
                                       int bm, int w4, void* stream) {
  dim3 grid(T / BM, jmax * (bn / BN));
  auto kernel = w4 ? csp_mlp_mm1_wq_kernel<true> : csp_mlp_mm1_wq_kernel<false>;
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const int8_t*)w1q, (const float*)w1s,
      (const __nv_bfloat16*)b1, (uint8_t*)act_cache, (const int*)inds,
      (const int*)counts, (__nv_bfloat16*)packed, C, N, jmax, bn, bm);
  return (int)cudaGetLastError();
}

extern "C" int chipmunk_csp_mlp_mm2_wq(const void* packed, const void* w2q,
                                       const void* w2s, void* out_cache,
                                       const void* inds, const void* counts,
                                       int T, int C, int jmax, int bn, int bm,
                                       int w4, void* stream) {
  dim3 grid(T / BM, C / BN);
  auto kernel = w4 ? csp_mlp_mm2_wq_kernel<true> : csp_mlp_mm2_wq_kernel<false>;
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)packed, (const int8_t*)w2q, (const float*)w2s,
      (uint8_t*)out_cache, (const int*)inds, (const int*)counts, C, jmax, bn,
      bm);
  return (int)cudaGetLastError();
}

extern "C" int chipmunk_quant_rows(const void* x, void* x8, void* sx, int T,
                                   int C, void* stream) {
  quant_rows_kernel<<<T, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)x8, (float*)sx, C);
  return (int)cudaGetLastError();
}

template <int BNB, bool W4>
static int launch_mm1_a8(const void* x8, const void* sx, const void* w1q,
                         const void* w1s, const void* b1, const void* w2s,
                         void* act_cache, const void* inds, const void* counts,
                         void* d8, void* sd, int T, int C, int N, int jmax,
                         int bm, cudaStream_t stream) {
  constexpr int SMEM = (W4 ? 2 : STAGES) * (int)sizeof(StageS8<BM8, BNB>);
  static const int attr = set_smem(csp_mlp_mm1_a8_kernel<BNB, W4>, SMEM);
  if (attr != 0) return attr;
  dim3 grid(T / BM8, jmax);
  csp_mlp_mm1_a8_kernel<BNB, W4><<<grid, NT, SMEM, stream>>>(
      (const int8_t*)x8, (const float*)sx, (const int8_t*)w1q,
      (const float*)w1s, (const __nv_bfloat16*)b1, (const float*)w2s,
      (uint8_t*)act_cache, (const int*)inds, (const int*)counts, (int8_t*)d8,
      (float*)sd, C, N, jmax, bm);
  return (int)cudaGetLastError();
}

extern "C" int chipmunk_csp_mlp_mm1_a8(const void* x8, const void* sx,
                                       const void* w1q, const void* w1s,
                                       const void* b1, const void* w2s,
                                       void* act_cache, const void* inds,
                                       const void* counts, void* d8, void* sd,
                                       int T, int C, int N, int jmax, int bn,
                                       int bm, int w4, void* stream) {
  auto launch = bn == 256 ? (w4 ? launch_mm1_a8<256, true>
                                : launch_mm1_a8<256, false>)
              : bn == 128 ? (w4 ? launch_mm1_a8<128, true>
                                : launch_mm1_a8<128, false>)
              : nullptr;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(x8, sx, w1q, w1s, b1, w2s, act_cache, inds, counts, d8, sd,
                T, C, N, jmax, bm, (cudaStream_t)stream);
}

extern "C" int chipmunk_csp_mlp_mm2_a8(const void* d8, const void* sd,
                                       const void* w2q, void* out_cache,
                                       const void* inds, const void* counts,
                                       int T, int C, int jmax, int bn, int bm,
                                       int w4, void* stream) {
  dim3 grid(T / BM8, C / BN8);
  auto kernel = w4 ? csp_mlp_mm2_a8_kernel<true> : csp_mlp_mm2_a8_kernel<false>;
  kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)d8, (const float*)sd, (const int8_t*)w2q,
      (uint8_t*)out_cache, (const int*)inds, (const int*)counts, C, jmax, bn,
      bm);
  return (int)cudaGetLastError();
}
