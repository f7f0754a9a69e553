// Sparse-delta MLP step, in two passes behind one wrapper (csp_mlp_fused),
// in five weight/activation variants, each with fp8 e4m3 or bf16 act and
// out caches (independently, as the reference takes either).
//
// Replaces (TPU reference, Pallas), chipmunk_tpu/kernels/csp_mlp.py:
//   :326 _fused_kernel, as the pair of passes below, for
//     bf16 weights (csp_mlp_mm1/mm2), int8 or int4 QTensor weights with
//     bf16 activations (`wq`/`w4`: csp_mlp_mm1_wq/mm2_wq) and int8 or int4
//     weights with int8 activations (`a8`: quant_rows + csp_mlp_mm1_a8 /
//     mm2_a8; `a8w4`: the same launches with int4 weights);
//   :93 _mm1_kernel and :216 _mm2_kernel (bf16, `wq` int8 and `w4` int4),
//     which compute the same functions as the first two pairs.
//
//   mm1: for token tile x[t] and selected neuron block n of its bm-block,
//        act = cast(gelu_tanh(x @ w1t[n]^T + b1[n])) to the act cache's
//        type, delta = act - cache, act_cache[t, n] = act (in place;
//        positions past the count give 0)
//   mm2: out_cache[t] = cast(out_cache[t] + delta[t] @ w2[selected rows])
//        with f32 accumulation over all selected blocks.
// A cache write rounds as the reference's astype: fp8 with NaN above 464
// (f2fp8_hw), bf16 to nearest even (put2).
//
// Bound on the H100: operations.  At the FLUX shape (T = 4608 tokens,
// C = 3072, ~15 selected 256-neuron blocks per 512-token block) each pass
// is 2 * T * 3840 * C = 109 GOP, ~0.11 ms at 989 TFLOP/s in bf16 and
// 0.054 ms at 1979 TOP/s in int8, while the bytes it must move (x, the
// selected weight rows, the caches) are tens of MB (~0.01-0.02 ms).
//
// Design: the TPU kernel keeps a [bm = 512, Cout = 3072] f32 accumulator
// (6 MB) in VMEM across the neuron blocks; no SM holds that, so the fused
// step is split where the reference splits it.  mm1 is a gathered GEMM
// whose epilogue does bias, GELU, the rounding of the act to the cache's
// type *before* the delta (the kernel's numerics, not mlp_ref's), the
// delta and the cache refresh; mm2 is a GEMM whose contraction runs only
// over the selected blocks.
//
// Every pair runs on gemm_sm90.cuh: TMA row gathers into a ring, wgmma
// (bf16: m64n256k16 / m64n128k16 -> f32; s8: m64n256k32 / m64n128k32 ->
// s32), a producer warpgroup and two consumer warpgroups of 64 rows.  The
// bf16 pair and the a8 pair (int8 weights) read both operands from shared
// memory.  w2's rows are [k][c]: bf16 wgmma reads it where it lies,
// MN-major through its transpose-B flag; s8 wgmma reads both operands
// K-major only, so the a8 mm2 reads a K-major copy of the codes ([C, N],
// made once per weight by the wrapper, kmajor_codes).  The quantized
// weights with bf16 x (wq: int8, w4: int4) take bf16 wgmma transposed, so
// that the weight is the A operand: its codes arrive raw by TMA and the
// consumers convert them into A fragments in registers (Mm1Wq / Mm2Wq,
// Mm1W4 / Mm2W4).  The a8w4 pair (int4 weights, int8 x) takes the same
// form with s8 wgmma, the codes widened to s8 in registers (Mm1A8W4,
// Mm2A8W4).
//
// The `wq` and `w4` variants convert the weight codes to bf16 (exact)
// and apply the scales where the reference does: mm1 after the product
// (fma(mid, w1s[n], b1[n])), mm2 on the delta before it (delta *
// bf16(w2s[k]), in bf16).
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
// all bn (<= 256) neurons of its rows.  A wider block (bn > 256: 128
// tokens x 512 neurons of s32 sums do not fit two consumer warpgroups'
// registers) is split: the same Ops run per 256- (or 128-) neuron
// sub-block and write ds (f32) and each row's sub-block max of |ds|
// (Mm1A8Part, Mm1A8W4Part), and a second kernel takes the max of the
// partials for sd and writes d8 (a8_split_finish_kernel): the same
// operations in the same order, so the same bits.  mm2 flushes its int32
// sum into the f32 accumulator at every block boundary (each block has its
// own scale).
// int32 range: |x8 . w1q| <= C * 127^2 = 4.96e7 at C = 3072 and
// |d8 . w2q| <= bn * 127^2, far inside 2^31.  The scalar steps are spelled
// out with the _rn intrinsics: each multiply-add the reference's XLA fuses
// (mid * s + b1, acc + dot * sd) is one fma, every other step rounds on
// its own.  With the integer products exact, x8/sx, d8/sd and (where the
// acts agree) the caches then match the reference bit for bit.
#include <type_traits>

#include "gemm_sm90.cuh"

using namespace chipmunk;

namespace {

// The count of token block m clipped to [1, jmax], as the reference
// clips it: the wrappers pass the counts and indices as they are, and no
// kernel reads an index past the count.
__device__ __forceinline__ int count_of(const int* counts, int m, int jmax) {
  return min(max(counts[m], 1), jmax);
}

// Two neighbouring cache entries (fp8 e4m3 as uint8_t, or bf16) as
// floats; put2 rounds two floats to the cache's type (fp8: the reference's
// NaN above 464, f2fp8_hw; bf16: to nearest even, as astype), stores them
// and returns the rounded values.
__device__ __forceinline__ float2 ld2(const uint8_t* p) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(p);
  return make_float2(fp82f(v & 0xff), fp82f(v >> 8));
}

__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 put2(uint8_t* p, float a, float b) {
  const uint8_t a0 = f2fp8_hw(a), a1 = f2fp8_hw(b);
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)(a0 | (a1 << 8));
  return make_float2(fp82f(a0), fp82f(a1));
}

__device__ __forceinline__ float2 put2(__nv_bfloat16* p, float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
  return __bfloat1622float2(v);
}

// The code of x rounded to the cache's type (as put2 rounds it), and two
// codes stored as put2 stores them, returned as floats.
template <class CT>
__device__ __forceinline__ int act_code(float x);

template <>
__device__ __forceinline__ int act_code<uint8_t>(float x) {
  return f2fp8_hw(x);
}

template <>
__device__ __forceinline__ int act_code<__nv_bfloat16>(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 put_codes(uint8_t* p, int a, int b) {
  *reinterpret_cast<uint16_t*>(p) = (uint16_t)(a | (b << 8));
  return make_float2(fp82f(a), fp82f(b));
}

__device__ __forceinline__ float2 put_codes(__nv_bfloat16* p, int a, int b) {
  *reinterpret_cast<uint32_t*>(p) = (uint32_t)a | ((uint32_t)b << 16);
  return make_float2(__uint_as_float((uint32_t)a << 16),
                     __uint_as_float((uint32_t)b << 16));
}

// ---------------------------------------------- a8: int8 weights and x

constexpr int NT = 256;             // threads of a quant_rows CTA

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

// ------------------------------------ a8 on Hopper (gemm_sm90.cuh)

using sm90::bar_sync;
using sm90::fence_async;
using sm90::GK;
using sm90::GM;
using sm90::launch_gemm;
using sm90::make_byte_map;
using sm90::mbar_expect_tx;
using sm90::mbar_wait;
using sm90::smem_u32;
using sm90::swz128;
using sm90::tma_load;
using sm90::tma_store;
using sm90::tma_store_commit_wait;

// csp_mlp_mm1_a8 replaces the fc1 half of _fused_kernel with a8
// (chipmunk_tpu/kernels/csp_mlp.py:326).  Bound: operations, 2 bm bn C per
// selected (token block, neuron block), 0.054 ms at the FLUX shape at 1979
// TOP/s.  The products run at the s8 wgmma rate from TMA-fed tiles of
// 128 x 256; the epilogue, which costs as much again on the CUDA cores, is
// kept free of branches (f2fp8_hw, div_rn) so its element chains overlap.
// One CTA per (128-token tile, selected neuron block j);
// A = x8 rows [t0, t0 + 128), B = w1q rows [n0, n0 + BN) of the block,
// k = C.  The producer first loads the tile's old act-cache entries
// [128 rows][BN] by TMA into shared memory past the ring, under the
// products.  Epilogue per thread (two rows, BN / 4 columns each): mid,
// the act, the refresh of the staged entries and ds = delta * w2s[n] in
// place of the s32 sums; the row max of |ds| over the block (the row lies
// in one quad: two shfl_xor), sd (written out), and d8 staged in the free
// ring; then one thread stores the act tile and the d8 tile by TMA.  The
// staged tiles carry the 128-byte swizzle, so a warp's eight rows hit
// eight different banks.  A slot past the count only writes its zeros.
template <int BN_, class CT>
struct Mm1A8 {
  static constexpr int BN = BN_;
  static constexpr int ES = sizeof(CT);              // bytes of an entry
  static constexpr int EXTRA = GM * BN * ES;         // the act tile
  static constexpr int ST =
      1024 + 4 * (GM + BN) * GK + EXTRA + 128 <= sm90::SMEM_MAX ? 4 : 3;
  static constexpr bool B_MN = false;
  struct Params {
    CUtensorMap act_map;     // act cache [T][N], box [128 rows][128 bytes]
    CUtensorMap d8_map;      // d8 [T][jmax BN], box [128 rows][128 bytes]
    const float* sx;
    const float* w1s;
    const __nv_bfloat16* b1;
    const float* w2s;
    const int* inds;
    const int* counts;
    int8_t* d8;
    float* sd;
    int C, jmax, bm;
  };
  const Params& p;
  int t0, j, n0;
  bool on;

  __device__ Mm1A8(const Params& p_) : p(p_) {
    t0 = blockIdx.x * GM;
    j = blockIdx.y;
    const int m = t0 / p.bm;
    on = j < count_of(p.counts, m, p.jmax);
    n0 = on ? p.inds[(size_t)m * p.jmax + j] * BN : 0;
  }
  __device__ bool live() const { return on; }
  __device__ void idle() const {
    const size_t P = (size_t)p.jmax * BN;
    int8_t* dq = p.d8 + (size_t)t0 * P + (size_t)j * BN;
    for (int id = threadIdx.x; id < GM * BN / 16; id += blockDim.x)
      *reinterpret_cast<uint4*>(dq + (id / (BN / 16)) * P +
                                (id % (BN / 16)) * 16) = make_uint4(0, 0, 0, 0);
    if (threadIdx.x < GM) p.sd[(size_t)(t0 + threadIdx.x) * p.jmax + j] = 0.f;
  }
  __device__ int tiles() const { return p.C / GK; }
  __device__ void side_load(uint32_t extra, uint32_t bar) const {
    mbar_expect_tx(bar, EXTRA);
    for (int b = 0; b < BN * ES / 128; ++b)
      tma_load(extra + b * GM * 128, &p.act_map, bar, n0 + b * 128 / ES, t0,
               0);
  }
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    ka = kb = i * GK;
    ra = t0;
    rb = n0;
  }
  __device__ bool restart(int i) const { return i == 0; }
  __device__ bool flush(int) const { return false; }
  __device__ void issued(int, int) {}
  template <int A>
  __device__ void begin(int (&)[A], int, unsigned char*, uint32_t) {}
  template <int A>
  __device__ void after(int, int (&)[A], int) {}

  template <int A>
  __device__ void end(int (&acc)[A], int c, unsigned char* ring,
                      unsigned char* act_s, uint32_t bar) {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int l0 = 64 * c + 16 * warp + g;           // tile rows l0, l0 + 8
    const float s0 = __ldg(p.sx + t0 + l0), s1 = __ldg(p.sx + t0 + l0 + 8);
    // In passes, so that the element chains interleave: no pass stores
    // where a later element of it loads.  1: mid, then the act rounded
    // to the cache's type (its code, in place of the sum).
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int n = n0 + 8 * jj + 2 * t;
      const float2 ws = __ldg(reinterpret_cast<const float2*>(p.w1s + n));
      const float2 bb = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(p.b1 + n)));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = h ? s1 : s0;
        int& a0 = acc[4 * jj + 2 * h];
        int& a1 = acc[4 * jj + 2 * h + 1];
        a0 = act_code<CT>(gelu_tanh(
            __fmaf_rn((float)a0, __fmul_rn(s, ws.x), bb.x)));
        a1 = act_code<CT>(gelu_tanh(
            __fmaf_rn((float)a1, __fmul_rn(s, ws.y), bb.y)));
      }
    }
    // 2: against the staged old entries, which take the new codes; ds =
    // delta * w2s[n] (in place of the codes) and the row max of |ds|
    float rmax[2] = {0.f, 0.f};
    mbar_wait(bar, 0);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int col = 8 * jj + 2 * t, x = col * ES;
      const float2 vs =
          __ldg(reinterpret_cast<const float2*>(p.w2s + n0 + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int& a0 = acc[4 * jj + 2 * h];
        int& a1 = acc[4 * jj + 2 * h + 1];
        CT* e = reinterpret_cast<CT*>(act_s + (x >> 7) * (GM * 128) +
                                      swz128(l0 + 8 * h, x & 127));
        const float2 old = ld2(e);
        const float2 a = put_codes(e, a0, a1);
        const float v0 = __fmul_rn(a.x - old.x, vs.x);
        const float v1 = __fmul_rn(a.y - old.y, vs.y);
        a0 = __float_as_int(v0);
        a1 = __float_as_int(v1);
        rmax[h] = nanmax(rmax[h], nanmax(fabsf(v0), fabsf(v1)));
      }
    }
    bar_sync(1, 256);                  // both consumers are past the ring
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rmax[h];
      v = nanmax(v, __shfl_xor_sync(~0u, v, 1));
      v = nanmax(v, __shfl_xor_sync(~0u, v, 2));
      const float sdv = __fmul_rn(nanmax(v, 1e-12f), INV127);
      const int l = l0 + 8 * h;
      if (t == 0) p.sd[(size_t)(t0 + l) * p.jmax + j] = sdv;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int x = 8 * jj + 2 * t;
        *reinterpret_cast<uint16_t*>(ring + (x >> 7) * (GM * 128) +
                                     swz128(l, x & 127)) = (uint16_t)(
            (q8(div_rn(__int_as_float(acc[4 * jj + 2 * h]), sdv)) & 0xff) |
            ((q8(div_rn(__int_as_float(acc[4 * jj + 2 * h + 1]), sdv))
              & 0xff) << 8));
      }
    }
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < BN * ES / 128; ++b)
        tma_store(&p.act_map, smem_u32(act_s) + b * GM * 128,
                  n0 + b * 128 / ES, t0);
      for (int b = 0; b < BN / 128; ++b)
        tma_store(&p.d8_map, smem_u32(ring) + b * GM * 128,
                  j * BN + b * 128, t0);
      tma_store_commit_wait();
    }
  }
};

// A neuron block wider than 256 (bn a multiple of 128): Mm1A8 per BN-neuron
// sub-block s of selected block j, grid (T / 128, jmax * bn / BN).  Its
// epilogue refreshes the act cache as Mm1A8's and writes ds (f32, [T][jmax
// bn]) and each row's max of |ds| over the sub-block (pmax [T][jmax S], S
// = bn / BN); a8_split_finish_kernel then forms sd and d8.  A slot past
// the count writes nothing (the second kernel writes its zeros).
template <int BN_, class CT>
struct Mm1A8Part : Mm1A8<BN_, CT> {
  using Base = Mm1A8<BN_, CT>;
  using Base::BN;
  struct Params : Base::Params {
    float* ds;
    float* pmax;
    int bn;
  };
  const Params& q;
  int s;                     // the sub-block

  __device__ Mm1A8Part(const Params& p_) : Base(p_), q(p_) {
    const int S = q.bn / BN, m = this->t0 / q.bm;
    this->j = blockIdx.y / S;
    s = blockIdx.y % S;
    this->on = this->j < count_of(q.counts, m, q.jmax);
    this->n0 = this->on ? q.inds[(size_t)m * q.jmax + this->j] * q.bn + s * BN
                        : 0;
  }
  __device__ void idle() const {}

  // One pass per entry (this mode is off the main path): mid, the act
  // rounded to the cache's type into the staged old entries, ds = delta *
  // w2s[n] to memory and the row max of |ds|, in Mm1A8's operations
  template <int A>
  __device__ void end(int (&acc)[A], int c, unsigned char*,
                      unsigned char* act_s, uint32_t bar) {
    constexpr int ES = Base::ES;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int t = lane & 3, l0 = 64 * c + 16 * warp + (lane >> 2);
    const int t0 = this->t0, j = this->j, n0 = this->n0, S = q.bn / BN;
    const size_t P = (size_t)q.jmax * q.bn;
    float* ds = q.ds + (size_t)(t0 + l0) * P + j * q.bn + s * BN + 2 * t;
    float rmax[2] = {0.f, 0.f};
    mbar_wait(bar, 0);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int col = 8 * jj + 2 * t, n = n0 + col, x = col * ES;
      const float2 ws = __ldg(reinterpret_cast<const float2*>(q.w1s + n));
      const float2 bb = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(q.b1 + n)));
      const float2 vs = __ldg(reinterpret_cast<const float2*>(q.w2s + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float sx = __ldg(q.sx + t0 + l0 + 8 * h);
        CT* e = reinterpret_cast<CT*>(act_s + (x >> 7) * (GM * 128) +
                                      swz128(l0 + 8 * h, x & 127));
        const float2 old = ld2(e);
        const float2 a = put_codes(
            e,
            act_code<CT>(gelu_tanh(__fmaf_rn(
                (float)acc[4 * jj + 2 * h], __fmul_rn(sx, ws.x), bb.x))),
            act_code<CT>(gelu_tanh(__fmaf_rn(
                (float)acc[4 * jj + 2 * h + 1], __fmul_rn(sx, ws.y), bb.y))));
        const float v0 = __fmul_rn(a.x - old.x, vs.x);
        const float v1 = __fmul_rn(a.y - old.y, vs.y);
        *reinterpret_cast<float2*>(ds + 8 * h * P + 8 * jj) =
            make_float2(v0, v1);
        rmax[h] = nanmax(rmax[h], nanmax(fabsf(v0), fabsf(v1)));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rmax[h];
      v = nanmax(v, __shfl_xor_sync(~0u, v, 1));
      v = nanmax(v, __shfl_xor_sync(~0u, v, 2));
      if (t == 0)
        q.pmax[((size_t)(t0 + l0 + 8 * h) * q.jmax + j) * S + s] = v;
    }
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < BN * ES / 128; ++b)
        tma_store(&q.act_map, smem_u32(act_s) + b * GM * 128,
                  n0 + b * 128 / ES, t0);
      tma_store_commit_wait();
    }
  }
};

// d8 and sd of a split a8 mm1 (Mm1A8Part, Mm1A8W4Part): for row t and a
// valid slot j, sd = max(max of the S sub-block maxima, 1e-12) / 127 and
// d8 = clip(rint(ds / sd)), as the one-pass epilogues; zeros past the
// count.  One CTA a row; a pass over 4 bn bytes, with no products.
__global__ void __launch_bounds__(NT)
a8_split_finish_kernel(const float* __restrict__ ds,
                       const float* __restrict__ pmax,
                       const int* __restrict__ counts, int8_t* __restrict__ d8,
                       float* __restrict__ sd, int jmax, int bn, int S,
                       int bm) {
  const size_t t = blockIdx.x, P = (size_t)jmax * bn;
  const int cnt = count_of(counts, (int)(t / bm), jmax);
  for (int j = 0; j < jmax; ++j) {
    float sdv = 0.f;
    if (j < cnt) {
      const float* pm = pmax + (t * jmax + j) * S;
      float v = pm[0];
      for (int k = 1; k < S; ++k) v = nanmax(v, pm[k]);
      sdv = __fmul_rn(nanmax(v, 1e-12f), INV127);
    }
    if (threadIdx.x == 0) sd[t * jmax + j] = sdv;
    for (int x = 4 * threadIdx.x; x < bn; x += 4 * NT) {
      uint32_t w = 0;
      if (j < cnt) {
        const float4 v =
            *reinterpret_cast<const float4*>(ds + t * P + j * bn + x);
        w = (q8(div_rn(v.x, sdv)) & 0xff) |
            ((q8(div_rn(v.y, sdv)) & 0xff) << 8) |
            ((q8(div_rn(v.z, sdv)) & 0xff) << 16) |
            ((uint32_t)(q8(div_rn(v.w, sdv)) & 0xff) << 24);
      }
      *reinterpret_cast<uint32_t*>(d8 + t * P + j * bn + x) = w;
    }
  }
}

// csp_mlp_mm2_a8 replaces the fc2 half of _fused_kernel with a8 (same
// site).  Bound: operations, 0.054 ms at the FLUX shape.  The products run
// at the s8 wgmma rate from TMA-fed 128 x 128 tiles, reading the K-major
// copy of the codes (no transpose per tile); each block's sd is loaded
// while its products run.  What remains is the tile's operand traffic from
// L2 (A and B of 128 x 128 each per k stage).
// One CTA per (128-token tile, 128 output columns); A =
// d8 rows [t0, t0 + 128) at slot j's k bytes, B = the K-major codes w2t
// [C, N] rows [c0, c0 + 128) at block inds[m, j]'s k bytes.  The k loop
// runs over the counts[m] valid blocks in order, bn / 128 stages each; at
// each block's last stage the s32 sum (exact in any k order) goes into the
// f32 sum as fma(f32(sum), sd[t, j], acc), the order of the reference.
template <class CT>
struct Mm2A8 {
  static constexpr int BN = 128, ST = 6, EXTRA = 0;
  static constexpr bool B_MN = false;
  struct Params {
    const float* sd;
    CT* out;
    const int* inds;
    const int* counts;
    int C, jmax, bn, bm;
  };
  const Params& p;
  int t0, c0, per, cnt;
  const int* row;
  float f[64];
  float sd0, sd1;              // the current block's sd of the two rows

  __device__ Mm2A8(const Params& p_) : p(p_) {
    t0 = blockIdx.x * GM;
    c0 = blockIdx.y * BN;
    const int m = t0 / p.bm;
    per = p.bn / GK;
    cnt = count_of(p.counts, m, p.jmax);
    row = p.inds + (size_t)m * p.jmax;
  }
  __device__ bool live() const { return true; }
  __device__ void idle() const {}
  __device__ int tiles() const { return cnt * per; }
  __device__ void side_load(uint32_t, uint32_t) const {}
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    const int jb = i / per, kk = (i % per) * GK;
    ka = jb * p.bn + kk;
    ra = t0;
    kb = row[jb] * p.bn + kk;
    rb = c0;
  }
  __device__ bool restart(int i) const { return i % per == 0; }
  __device__ bool flush(int i) const { return i % per == per - 1; }

  // thread's rows r0, r0 + 8 and columns c0 + 8 jj + 2 t (+1)
  template <class F>
  __device__ void each(int c, F fn) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int r0 = t0 + 64 * c + 16 * warp + (lane >> 2);
#pragma unroll
    for (int jj = 0; jj < 16; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(4 * jj + 2 * h, r0 + 8 * h, c0 + 8 * jj + 2 * (lane & 3));
  }
  template <int A>
  __device__ void begin(int (&)[A], int c, unsigned char*, uint32_t) {
    each(c, [&](int e, int r, int col) {
      const float2 v = ld2(p.out + (size_t)r * p.C + col);
      f[e] = v.x;
      f[e + 1] = v.y;
    });
  }
  // at a block's first stage, its sd (read while the products run)
  __device__ void issued(int i, int c) {
    if (i % per) return;
    const int r0 = t0 + 64 * c + 16 * ((threadIdx.x / 32) % 4) +
                   ((threadIdx.x & 31) >> 2);
    sd0 = p.sd[(size_t)r0 * p.jmax + i / per];
    sd1 = p.sd[(size_t)(r0 + 8) * p.jmax + i / per];
  }
  template <int A>
  __device__ void after(int, int (&acc)[A], int c) {
    const int r0 = t0 + 64 * c + 16 * ((threadIdx.x / 32) % 4) +
                   ((threadIdx.x & 31) >> 2);
    each(c, [&](int e, int r, int) {
      const float s = r == r0 ? sd0 : sd1;
      f[e] = __fmaf_rn((float)acc[e], s, f[e]);
      f[e + 1] = __fmaf_rn((float)acc[e + 1], s, f[e + 1]);
    });
  }
  template <int A>
  __device__ void end(int (&)[A], int c, unsigned char*, unsigned char*,
                      uint32_t) {
    each(c, [&](int e, int r, int col) {
      put2(p.out + (size_t)r * p.C + col, f[e], f[e + 1]);
    });
  }
};

// ------------------------------------ bf16 on Hopper (gemm_sm90.cuh)

// csp_mlp_mm1 replaces the fc1 half of _fused_kernel with bf16 weights
// (chipmunk_tpu/kernels/csp_mlp.py:326) and _mm1_kernel (:93).  Bound:
// operations, 2 bm bn C per selected (token block, neuron block), 0.098 ms
// at the FLUX shape at 989 TFLOP/s.  The products run at the bf16 wgmma
// rate from TMA-fed 128 x BN tiles; the epilogue follows Mm1A8's: the old
// act tile staged by TMA under the products, the element chain free of
// branches (f2fp8_hw, put_codes), the act tile and the delta tile stored
// whole by TMA.
// One CTA per (128-token tile, BN-neuron sub-block of selected block j):
// grid (T / 128, jmax * bn / BN); A = x rows [t0, t0 + 128), B = w1t rows
// [n0, n0 + BN), k = C in stages of 64.  Epilogue per thread (two rows,
// BN / 4 columns): mid = sum + b1[n] and the act's code (gelu_tanh
// rounded to the cache's type) in place of the sum; against the staged
// old entries, which take the new codes, delta = act - old; the delta as
// bf16 staged in the free ring.  A slot past the count writes its zeros.
template <int BN_, class CT>
struct Mm1Bf16 {
  static constexpr int BN = BN_;
  static constexpr int ES = sizeof(CT);              // bytes of an entry
  static constexpr int EXTRA = GM * BN * ES;         // the act tile
  static constexpr int ROOM = sm90::SMEM_MAX - 1024 - EXTRA - 128;
  static constexpr int ST = 6 * (GM + BN) * GK <= ROOM ? 6
                            : 4 * (GM + BN) * GK <= ROOM ? 4 : 3;
  static constexpr bool B_MN = false;
  struct Params {
    CUtensorMap act_map;     // act cache [T][N], box [128 rows][128 bytes]
    CUtensorMap pk_map;      // packed [T][jmax bn] bf16, box [128][64]
    const __nv_bfloat16* b1;
    const int* inds;
    const int* counts;
    __nv_bfloat16* packed;
    int jmax, bn, bm, C;
  };
  const Params& p;
  int t0, col0, n0;          // first token, packed column, neuron
  bool on;

  __device__ Mm1Bf16(const Params& p_) : p(p_) {
    t0 = blockIdx.x * GM;
    const int subs = p.bn / BN, j = blockIdx.y / subs;
    const int m = t0 / p.bm, sub = (blockIdx.y % subs) * BN;
    on = j < count_of(p.counts, m, p.jmax);
    col0 = j * p.bn + sub;
    n0 = on ? p.inds[(size_t)m * p.jmax + j] * p.bn + sub : 0;
  }
  __device__ bool live() const { return on; }
  __device__ void idle() const {
    const size_t P = (size_t)p.jmax * p.bn;
    __nv_bfloat16* pk = p.packed + (size_t)t0 * P + col0;
    for (int id = threadIdx.x; id < GM * BN / 8; id += blockDim.x)
      *reinterpret_cast<uint4*>(pk + (id / (BN / 8)) * P +
                                (id % (BN / 8)) * 8) = make_uint4(0, 0, 0, 0);
  }
  __device__ int tiles() const { return p.C / 64; }
  __device__ void side_load(uint32_t extra, uint32_t bar) const {
    mbar_expect_tx(bar, EXTRA);
    for (int b = 0; b < BN * ES / 128; ++b)
      tma_load(extra + b * GM * 128, &p.act_map, bar, n0 + b * 128 / ES, t0,
               0);
  }
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    ka = kb = i * 64;
    ra = t0;
    rb = n0;
  }
  __device__ bool restart(int i) const { return i == 0; }
  __device__ bool flush(int) const { return false; }
  __device__ void issued(int, int) {}
  template <int A>
  __device__ void begin(float (&)[A], int, unsigned char*, uint32_t) {}
  template <int A>
  __device__ void after(int, float (&)[A], int) {}

  template <int A>
  __device__ void end(float (&acc)[A], int c, unsigned char* ring,
                      unsigned char* act_s, uint32_t bar) {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int l0 = 64 * c + 16 * warp + g;           // tile rows l0, l0 + 8
    // In passes, as Mm1A8.  1: mid, then the act's code in place of it.
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const float2 bb = __bfloat1622float2(__ldg(
          reinterpret_cast<const __nv_bfloat162*>(p.b1 + n0 + 8 * jj + 2 * t)));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& a0 = acc[4 * jj + 2 * h];
        float& a1 = acc[4 * jj + 2 * h + 1];
        a0 = __int_as_float(act_code<CT>(gelu_tanh(a0 + bb.x)));
        a1 = __int_as_float(act_code<CT>(gelu_tanh(a1 + bb.y)));
      }
    }
    // 2: against the staged old entries, which take the new codes; the
    // delta in place of the codes
    mbar_wait(bar, 0);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int x = (8 * jj + 2 * t) * ES;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& a0 = acc[4 * jj + 2 * h];
        float& a1 = acc[4 * jj + 2 * h + 1];
        CT* e = reinterpret_cast<CT*>(act_s + (x >> 7) * (GM * 128) +
                                      swz128(l0 + 8 * h, x & 127));
        const float2 old = ld2(e);
        const float2 a = put_codes(e, __float_as_int(a0), __float_as_int(a1));
        a0 = a.x - old.x;
        a1 = a.y - old.y;
      }
    }
    bar_sync(1, 256);                  // both consumers are past the ring
    // 3: the delta as bf16 into the ring, BN / 64 boxes [128 rows][64]
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj) {
        const int x = (8 * jj + 2 * t) * 2;
        *reinterpret_cast<uint32_t*>(ring + (x >> 7) * (GM * 128) +
                                     swz128(l0 + 8 * h, x & 127)) =
            pack_bf16(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
      }
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < BN * ES / 128; ++b)
        tma_store(&p.act_map, smem_u32(act_s) + b * GM * 128,
                  n0 + b * 128 / ES, t0);
      for (int b = 0; b < BN / 64; ++b)
        tma_store(&p.pk_map, smem_u32(ring) + b * GM * 128, col0 + 64 * b,
                  t0);
      tma_store_commit_wait();
    }
  }
};

// csp_mlp_mm2 replaces the fc2 half of _fused_kernel with bf16 weights
// (same site) and _mm2_kernel (:216).  Bound: operations, 0.098 ms at the
// FLUX shape.  The products run at the bf16 wgmma rate from TMA-fed
// 128 x BN tiles, reading w2 where it lies: its rows are k, so B is
// MN-major (B_MN), BN / 64 boxes of [64 k rows][64 columns] a stage, and
// no transposed copy of the weight is kept.  The out-cache tile comes in
// and goes out whole by TMA, staged in shared memory.
// One CTA per (128-token tile, BN output columns): grid (T / 128, C / BN);
// A = packed rows [t0, t0 + 128), slot j's k, B = w2 rows of block
// inds[m, j], columns [c0, c0 + BN).  The accumulator starts as
// f32(out_cache) (begin, from the staged tile) and sums over the
// counts[m] valid blocks, bn / 64 stages each, with no flush; end rounds
// it to the cache's type (put2) in the staged tile and stores that.
template <int BN_, class CT>
struct Mm2Bf16 {
  static constexpr int BN = BN_;
  static constexpr int ES = sizeof(CT);              // bytes of an entry
  static constexpr int EXTRA = GM * BN * ES;         // the out tile
  static constexpr int ROOM = sm90::SMEM_MAX - 1024 - EXTRA - 128;
  static constexpr int ST = 6 * (GM + BN) * GK <= ROOM ? 6
                            : 4 * (GM + BN) * GK <= ROOM ? 4 : 3;
  static constexpr bool B_MN = true;
  struct Params {
    CUtensorMap out_map;     // out cache [T][C], box [128 rows][128 bytes]
    const int* inds;
    const int* counts;
    int jmax, bn, bm;
  };
  const Params& p;
  int t0, c0, per, cnt;
  const int* row;

  __device__ Mm2Bf16(const Params& p_) : p(p_) {
    t0 = blockIdx.x * GM;
    c0 = blockIdx.y * BN;
    const int m = t0 / p.bm;
    per = p.bn / 64;
    cnt = count_of(p.counts, m, p.jmax);
    row = p.inds + (size_t)m * p.jmax;
  }
  __device__ bool live() const { return true; }
  __device__ void idle() const {}
  __device__ int tiles() const { return cnt * per; }
  __device__ void side_load(uint32_t extra, uint32_t bar) const {
    mbar_expect_tx(bar, EXTRA);
    for (int b = 0; b < BN * ES / 128; ++b)
      tma_load(extra + b * GM * 128, &p.out_map, bar, c0 + b * 128 / ES, t0,
               0);
  }
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    const int jb = i / per, kk = (i % per) * 64;
    ka = jb * p.bn + kk;
    ra = t0;
    kb = c0;
    rb = row[jb] * p.bn + kk;
  }
  __device__ bool restart(int) const { return false; }
  __device__ bool flush(int) const { return false; }
  __device__ void issued(int, int) {}
  template <int A>
  __device__ void after(int, float (&)[A], int) {}

  // fn(e, entry): the thread's accumulator pair e, e + 1 and its two
  // entries in the staged tile (rows l0, l0 + 8, columns 8 jj + 2 t)
  template <class F>
  __device__ void each(int c, unsigned char* out_s, F fn) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int l0 = 64 * c + 16 * warp + (lane >> 2);
#pragma unroll
    for (int jj = 0; jj < BN / 8; ++jj) {
      const int x = (8 * jj + 2 * (lane & 3)) * ES;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(4 * jj + 2 * h,
           reinterpret_cast<CT*>(out_s + (x >> 7) * (GM * 128) +
                                 swz128(l0 + 8 * h, x & 127)));
    }
  }
  template <int A>
  __device__ void begin(float (&acc)[A], int c, unsigned char* out_s,
                        uint32_t bar) {
    mbar_wait(bar, 0);
    each(c, out_s, [&](int e, const CT* v) {
      const float2 f = ld2(v);
      acc[e] = f.x;
      acc[e + 1] = f.y;
    });
  }
  template <int A>
  __device__ void end(float (&acc)[A], int c, unsigned char*,
                      unsigned char* out_s, uint32_t) {
    each(c, out_s, [&](int e, CT* v) { put2(v, acc[e], acc[e + 1]); });
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < BN * ES / 128; ++b)
        tma_store(&p.out_map, smem_u32(out_s) + b * GM * 128,
                  c0 + b * 128 / ES, t0);
      tma_store_commit_wait();
    }
  }
};

// ------------------------------ w4: int4 weights, bf16 x, on Hopper

__device__ __forceinline__ uint32_t bf2_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 u32_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}

// Two offset-binary int4 codes, the nibbles at bits 0-3 and 16-19 of x,
// as the bf16 pair code - 8, exactly: each nibble n goes into the
// mantissa of bf16 128.0 (0x4300 | n is 128 + n), and one subtraction of
// 136 gives n - 8.
__device__ __forceinline__ uint32_t nib2(uint32_t x) {
  return bf2_u32(__hsub2(u32_bf2((x & 0x000F000Fu) | 0x43004300u),
                         u32_bf2(0x43084308u)));
}

// Two int8 codes, the bytes at bits 0-7 and 16-23 of x, as the bf16 pair
// of their values, exactly, for all 256 codes: the low 7 bits go into the
// mantissa of bf16 128.0 (128 + m), and the sign bit selects what is
// subtracted, 128.0 or 256.0 (0x4380): m - 128 s.  Two LOP3 and a bf16
// subtract; faster on an H100 than the float route (two I2F and a pack) in
// both wq kernels.
__device__ __forceinline__ uint32_t s8x2(uint32_t x) {
  return bf2_u32(__hsub2(u32_bf2((x & 0x007F007Fu) | 0x43004300u),
                         u32_bf2((x & 0x00800080u) | 0x43004300u)));
}

// csp_mlp_mm1_w4 replaces _mm1_kernel with int4 weights
// (chipmunk_tpu/kernels/csp_mlp.py:93) and the fc1 half of _fused_kernel's
// w4 branch (:389).  Bound: operations, as the bf16 mm1 (2 bm bn C per
// selected block, 0.107 ms at the FLUX shape at 989 TFLOP/s).  The
// product is taken transposed, act^T = W x^T, so that the weight is
// wgmma's A operand, built in registers: no converted tile goes through
// shared memory, and each code is converted once per 128 x NT tile (half
// as often per product as with the weight as B).  One CTA per (NT-token
// tile, 128-neuron sub-block of selected block j), NT = 256 where bm
// allows, else 128: B = x rows [t0, t0 + NT) by TMA, 64 k a stage; the
// packed rows [n0, n0 + 128) by TMA as raw boxes of [128][128 bytes]
// (128-byte swizzle), byte columns [128 q, 128 q + 128) each read once
// from memory and feeding four stages: the low nibbles (k = 128 q + j)
// and the high ones (k = C/2 + 128 q + j) of each 64-byte half.  A
// consumer warpgroup's 64 neurons: 16 two-byte reads a thread a stage,
// each read a bf16 pair of its m64k16 fragments (nib2).  Epilogue per
// thread (neurons n, n + 1; NT / 4 tokens): mid = fma(sum, w1s[n],
// b1[n]) and the act's code, then against the old act tile [NT tokens]
// [128 neurons] staged by TMA under the products, which takes the codes;
// the delta as bf16 staged in the free ring; both tiles stored by TMA.
template <int NT, class CT>
struct Mm1W4 {
  static constexpr int BN = NT;                      // B rows: tokens
  static constexpr int ES = sizeof(CT);              // bytes of an entry
  static constexpr int EXTRA = NT * 128 * ES;        // the act tile
  static constexpr int RAW = 128 * 128, RS = 2, EVERY = 4, MT = 1;
  static constexpr bool B_MN = false, CONVERT = false;
  static constexpr int FIT =
      (sm90::SMEM_MAX - 1024 - EXTRA - 256 - RS * RAW) / (NT * GK);
  static constexpr int ST = FIT >= 6 ? 6 : FIT >= 4 ? 4 : FIT;
  struct Params {
    CUtensorMap act_map;     // act cache [T][N], box [NT rows][128 bytes]
    CUtensorMap pk_map;      // packed [T][jmax bn] bf16, box [NT][64]
    const float* w1s;
    const __nv_bfloat16* b1;
    const int* inds;
    const int* counts;
    __nv_bfloat16* packed;
    int jmax, bn, bm, C;
  };
  const Params& p;
  int t0, col0, n0;          // first token, packed column, neuron
  bool on;

  __device__ Mm1W4(const Params& p_) : p(p_) {
    t0 = blockIdx.x * NT;
    const int subs = p.bn / 128, j = blockIdx.y / subs;
    const int m = t0 / p.bm, sub = (blockIdx.y % subs) * 128;
    on = j < count_of(p.counts, m, p.jmax);
    col0 = j * p.bn + sub;
    n0 = on ? p.inds[(size_t)m * p.jmax + j] * p.bn + sub : 0;
  }
  __device__ bool live() const { return on; }
  __device__ void idle() const {
    const size_t P = (size_t)p.jmax * p.bn;
    __nv_bfloat16* pk = p.packed + (size_t)t0 * P + col0;
    for (int id = threadIdx.x; id < NT * 16; id += blockDim.x)
      *reinterpret_cast<uint4*>(pk + (id / 16) * P + (id % 16) * 8) =
          make_uint4(0, 0, 0, 0);
  }
  __device__ int tiles() const { return p.C / 64; }
  __device__ void side_load(uint32_t extra, uint32_t bar) const {
    mbar_expect_tx(bar, EXTRA);
    for (int b = 0; b < ES; ++b)
      tma_load(extra + b * NT * 128, &p.act_map, bar, n0 + b * 128 / ES, t0,
               0);
  }
  // stage i: plane i % 2 of half (i / 2) % 2 of raw box i / 4
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    kb = (i & 1) * (p.C / 2) + 128 * (i >> 2) + 64 * ((i >> 1) & 1);
    rb = t0;
    ka = ra = 0;
  }
  __device__ void raw_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                           int q) const {
    tma_load(dst, map, bar, 128 * q, n0, 0);
  }
  // A: fragment rows g and g + 8 of warp w are the neurons 16 w + 2 g
  // and 16 w + 2 g + 1 of the warpgroup's 64, so that a thread's entries
  // pair up along the act cache's rows
  __device__ void a_frag(int i, int c, const unsigned char* raw,
                         uint32_t (&af)[1][4][4]) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int r0 = 64 * c + 16 * warp + 2 * (lane >> 2);
    const int x0 = 64 * ((i >> 1) & 1) + 2 * (lane & 3), sh = 4 * (i & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const uint32_t v = *reinterpret_cast<const uint16_t*>(
              raw + swz128(r0 + rr, x0 + 16 * kk + 8 * h));
          af[0][kk][2 * h + rr] = nib2(__byte_perm(v >> sh, 0, 0x4140));
        }
  }
  __device__ bool restart(int i) const { return i == 0; }
  __device__ bool flush(int) const { return false; }
  __device__ void issued(int, int) {}
  template <int A>
  __device__ void begin(float (&)[A], int, unsigned char*, uint32_t) {}
  template <int A>
  __device__ void after(int, float (&)[A], int) {}

  // fn(a0, a1, j, r, nl): the accumulator entries of the thread's tile
  // token 8 j + r (r < 8: its swizzled place is that of row r plus 1024 j
  // bytes) and neurons nl, nl + 1
  template <class F>
  __device__ void each(float* acc, int c, F fn) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int nl = 64 * c + 16 * warp + 2 * (lane >> 2);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        fn(acc[4 * j + e], acc[4 * j + e + 2], j, 2 * (lane & 3) + e, nl);
  }
  template <int A>
  __device__ void end(float (&acc)[A], int c, unsigned char* ring,
                      unsigned char* act_s, uint32_t bar) {
    const int n = n0 + 64 * c + 16 * ((threadIdx.x / 32) % 4) +
                  2 * ((threadIdx.x & 31) >> 2);
    const float2 ws = __ldg(reinterpret_cast<const float2*>(p.w1s + n));
    const float2 bb = __bfloat1622float2(
        __ldg(reinterpret_cast<const __nv_bfloat162*>(p.b1 + n)));
    // In passes, as Mm1A8, each pair's results packed into the register
    // of its first entry.  1: mid, then the two acts' codes (16 bits each).
    each(acc, c, [&](float& a0, float& a1, int, int, int) {
      a0 = __uint_as_float(
          (uint32_t)act_code<CT>(gelu_tanh(__fmaf_rn(a0, ws.x, bb.x))) |
          (uint32_t)act_code<CT>(gelu_tanh(__fmaf_rn(a1, ws.y, bb.y)))
              << 16);
    });
    // 2: against the staged old entries, which take the new codes; the
    // deltas as a bf16 pair
    mbar_wait(bar, 0);
    each(acc, c, [&](float& a0, float&, int j, int r, int nl) {
      const int x = nl * ES;
      CT* e = reinterpret_cast<CT*>(act_s + (x >> 7) * (NT * 128) +
                                    swz128(r, x & 127) + 1024 * j);
      const float2 old = ld2(e);
      const uint32_t w = __float_as_uint(a0);
      const float2 a = put_codes(e, w & 0xffff, w >> 16);
      a0 = __uint_as_float(pack_bf16(a.x - old.x, a.y - old.y));
    });
    bar_sync(1, 256);                  // both consumers are past the ring
    // 3: the deltas into the ring, 2 boxes [NT rows][64]
    each(acc, c, [&](float& a0, float&, int j, int r, int nl) {
      *reinterpret_cast<uint32_t*>(ring + (nl >> 6) * (NT * 128) +
                                   swz128(r, (nl & 63) * 2) + 1024 * j) =
          __float_as_uint(a0);
    });
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < ES; ++b)
        tma_store(&p.act_map, smem_u32(act_s) + b * NT * 128,
                  n0 + b * 128 / ES, t0);
      for (int b = 0; b < 2; ++b)
        tma_store(&p.pk_map, smem_u32(ring) + b * NT * 128, col0 + 64 * b,
                  t0);
      tma_store_commit_wait();
    }
  }
};

// csp_mlp_mm1_wq replaces _mm1_kernel with int8 weights
// (chipmunk_tpu/kernels/csp_mlp.py:93, :118-131) and the fc1 half of
// _fused_kernel's wq branch (:398-404).  Bound: operations, as the bf16
// mm1 (2 bm bn C per selected block, 0.107 ms at the FLUX shape at 989
// TFLOP/s).  Mm1W4 with one code a byte: transposed (act^T = W x^T), the
// codes as wgmma's A operand built in registers from raw TMA boxes of the
// [N, C] codes, [128 neurons][128 bytes] (128-byte swizzle), each byte
// read once from memory and feeding two stages of 64 k (k = 128 q + x).
// A fragment register is one two-byte read of a row (k, k + 1), one PRMT
// and s8x2.  x by TMA (NT tokens a CTA), the grid, the two fragment sets
// and the epilogue (mid = fma(sum, w1s[n], b1[n]), the act's code, the
// delta against the staged old act tile) are Mm1W4's.
template <int NT, class CT, bool S2>
struct Mm1Wq : Mm1W4<NT, CT> {
  using Base = Mm1W4<NT, CT>;
  static constexpr int EVERY = 2;
  struct Params : Base::Params {
    const float* w2s;        // S2: w2's row scales
  };
  const Params& q;

  __device__ Mm1Wq(const Params& p_) : Base(p_), q(p_) {}
  // stage i: k [64 i, 64 i + 64), half i % 2 of raw box i / 2
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    kb = 64 * i;
    rb = this->t0;
    ka = ra = 0;
  }
  // A: fragment rows g and g + 8 of warp w are the neurons 16 w + 2 g and
  // 16 w + 2 g + 1 of the warpgroup's 64, as Mm1W4's
  __device__ void a_frag(int i, int c, const unsigned char* raw,
                         uint32_t (&af)[1][4][4]) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int r0 = 64 * c + 16 * warp + 2 * (lane >> 2);
    const int x0 = 64 * (i & 1) + 2 * (lane & 3);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const uint32_t v = *reinterpret_cast<const uint16_t*>(
              raw + swz128(r0 + rr, x0 + 16 * kk + 8 * h));
          af[0][kk][2 * h + rr] = s8x2(__byte_perm(v, 0, 0x4140));
        }
  }

  // S2 (the csp_mlp_fused path): Mm1W4::end with each packed delta
  // multiplied by bf16(w2s[n]) in bf16 (one rounding of an exact product:
  // the reference's multiply, which csp_mlp_mm2_wq otherwise makes in its
  // producer), so that mm2 reads the delta as it is (Mm2Wq's PRE)
  template <int A>
  __device__ void end(float (&acc)[A], int c, unsigned char* ring,
                      unsigned char* act_s, uint32_t bar) {
    if constexpr (!S2) {
      Base::end(acc, c, ring, act_s, bar);
    } else {
      constexpr int ES = Base::ES;
      const int n = this->n0 + 64 * c + 16 * ((threadIdx.x / 32) % 4) +
                    2 * ((threadIdx.x & 31) >> 2);
      const float2 ws = __ldg(reinterpret_cast<const float2*>(q.w1s + n));
      const float2 bb = __bfloat1622float2(
          __ldg(reinterpret_cast<const __nv_bfloat162*>(q.b1 + n)));
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(q.w2s + n));
      const __nv_bfloat162 sc = __floats2bfloat162_rn(s2.x, s2.y);
      this->each(acc, c, [&](float& a0, float& a1, int, int, int) {
        a0 = __uint_as_float(
            (uint32_t)act_code<CT>(gelu_tanh(__fmaf_rn(a0, ws.x, bb.x))) |
            (uint32_t)act_code<CT>(gelu_tanh(__fmaf_rn(a1, ws.y, bb.y)))
                << 16);
      });
      mbar_wait(bar, 0);
      this->each(acc, c, [&](float& a0, float&, int j, int r, int nl) {
        const int x = nl * ES;
        CT* e = reinterpret_cast<CT*>(act_s + (x >> 7) * (NT * 128) +
                                      swz128(r, x & 127) + 1024 * j);
        const float2 old = ld2(e);
        const uint32_t w = __float_as_uint(a0);
        const float2 a = put_codes(e, w & 0xffff, w >> 16);
        a0 = __uint_as_float(bf2_u32(
            __hmul2(u32_bf2(pack_bf16(a.x - old.x, a.y - old.y)), sc)));
      });
      bar_sync(1, 256);                // both consumers are past the ring
      this->each(acc, c, [&](float& a0, float&, int j, int r, int nl) {
        *reinterpret_cast<uint32_t*>(ring + (nl >> 6) * (NT * 128) +
                                     swz128(r, (nl & 63) * 2) + 1024 * j) =
            __float_as_uint(a0);
      });
      fence_async();
      bar_sync(1, 256);
      if (threadIdx.x == 128) {
        for (int b = 0; b < ES; ++b)
          tma_store(&q.act_map, smem_u32(act_s) + b * NT * 128,
                    this->n0 + b * 128 / ES, this->t0);
        for (int b = 0; b < 2; ++b)
          tma_store(&q.pk_map, smem_u32(ring) + b * NT * 128,
                    this->col0 + 64 * b, this->t0);
        tma_store_commit_wait();
      }
    }
  }
};

// csp_mlp_mm2_w4 replaces _mm2_kernel with int4 weights (:216) and the fc2
// half of _fused_kernel's w4 branch (:436).  Bound: operations, 0.107 ms
// at the FLUX shape.  Transposed as mm1: out^T = W^T delta^T, the weight
// as A in registers.  One CTA per (128-token tile, 128 byte columns
// [cb, cb + 128) of the packed codes), which hold the 256 output columns
// [cb, cb + 128) (low nibbles) and [C/2 + cb, C/2 + cb + 128) (high): B =
// the packed delta rows [t0, t0 + 128) at slot j's k, 64 k a stage; the
// codes of the stage's 64 k rows by TMA as one raw box [64][128 bytes]
// (128-byte swizzle), each byte read once.  A consumer warpgroup takes 64
// byte columns and both their planes (two m64n128 tiles): two
// ldmatrix.trans a stage give it, for k pairs, the bytes of two
// neighbouring columns, which PRMT parts into the fragments of both (its
// rows g and g + 8 are a column pair) and nib2 converts, per plane.  The
// delta is multiplied by bf16(w2s[k]) in bf16 (one rounding of an exact
// product, the reference's multiply in the packed dtype) in place in
// each stage by warps 1-3 of the producer warpgroup.  The accumulator
// starts as f32(out_cache) from the out tile staged by TMA (two column
// halves), sums over the counts[m] valid blocks and is rounded into the
// tile, which goes out by TMA.
template <class CT>
struct Mm2W4 {
  static constexpr int BN = 128;                     // B rows: tokens
  static constexpr int ES = sizeof(CT);              // bytes of an entry
  static constexpr int EXTRA = GM * 256 * ES;        // the out tile
  static constexpr int RAW = 64 * 128, EVERY = 1, MT = 2;
  static constexpr bool B_MN = false, CONVERT = true;
  static constexpr int FIT =
      (sm90::SMEM_MAX - 1024 - EXTRA - 256) / (BN * GK + RAW);
  static constexpr int ST = FIT >= 6 ? 6 : FIT, RS = ST;
  struct Params {
    CUtensorMap out_map;     // out cache [T][C], box [128 rows][128 bytes]
    const float* w2s;
    const int* inds;
    const int* counts;
    int jmax, bn, bm, C;
  };
  const Params& p;
  int t0, cb, per, cnt;
  const int* row;

  __device__ Mm2W4(const Params& p_) : p(p_) {
    t0 = blockIdx.x * GM;
    cb = blockIdx.y * 128;
    const int m = t0 / p.bm;
    per = p.bn / 64;
    cnt = count_of(p.counts, m, p.jmax);
    row = p.inds + (size_t)m * p.jmax;
  }
  __device__ bool live() const { return true; }
  __device__ void idle() const {}
  __device__ int tiles() const { return cnt * per; }
  // the weight row of stage i's first k; the output column of tile
  // column x
  __device__ int krow(int i) const {
    return row[i / per] * p.bn + (i % per) * 64;
  }
  __device__ int col(int x) const {
    return cb + x + (x >= 128 ? p.C / 2 - 128 : 0);
  }
  __device__ void side_load(uint32_t extra, uint32_t bar) const {
    mbar_expect_tx(bar, EXTRA);
    for (int b = 0; b < 2 * ES; ++b)
      tma_load(extra + b * GM * 128, &p.out_map, bar, col(b * 128 / ES), t0,
               0);
  }
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    kb = (i / per) * p.bn + (i % per) * 64;
    rb = t0;
    ka = ra = 0;
  }
  __device__ void raw_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                           int i) const {
    tma_load(dst, map, bar, cb, krow(i), 0);
  }
  // A: ldmatrix.trans of k rows 16 kk + 8 hh + (0..7) at byte columns
  // col0 .. col0 + 15 gives lane (g, t) the bytes (k 2t, 2t + 1) of the
  // columns col0 + 2g (rows g of the fragments) and col0 + 2g + 1 (rows
  // g + 8), low plane (af[0]) and high (af[1])
  __device__ void a_frag(int, int c, const unsigned char* raw,
                         uint32_t (&af)[2][4][4]) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int col0 = 64 * c + 16 * warp;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      uint32_t v[4];
      ldsm_x4_t(v, raw + swz128(32 * kp + lane, col0));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kk = 2 * kp + m / 2, hh = m % 2;
        const uint32_t ev = __byte_perm(v[m], 0, 0x4240);
        const uint32_t od = __byte_perm(v[m], 0, 0x4341);
        af[0][kk][2 * hh] = nib2(ev);
        af[0][kk][2 * hh + 1] = nib2(od);
        af[1][kk][2 * hh] = nib2(ev >> 4);
        af[1][kk][2 * hh + 1] = nib2(od >> 4);
      }
    }
  }
  // thread ct of 96: the delta tile's 16-byte chunks ct % 8 (k 8 (ct % 8)
  // ..) of rows ct / 8, + 12, ..., four loads ahead of their stores; s
  // holds the thread's 8 scales of stage i and takes those of i + 1
  using Carry = float4[2];
  __device__ void convert_begin(int ct, Carry& s) const {
    const float4* sp =
        reinterpret_cast<const float4*>(p.w2s + krow(0) + 8 * (ct % 8));
    s[0] = __ldg(sp);
    s[1] = __ldg(sp + 1);
  }
  __device__ void convert(int i, int ct, unsigned char* tile,
                          Carry& s) const {
    const int ch = ct % 8;
    const float4 s0 = s[0], s1 = s[1];
    if (i + 1 < tiles()) {      // the next stage's scales, under this one
      const float4* sp =
          reinterpret_cast<const float4*>(p.w2s + krow(i + 1) + 8 * ch);
      s[0] = __ldg(sp);
      s[1] = __ldg(sp + 1);
    }
    const uint32_t sc[4] = {
        bf2_u32(__floats2bfloat162_rn(s0.x, s0.y)),
        bf2_u32(__floats2bfloat162_rn(s0.z, s0.w)),
        bf2_u32(__floats2bfloat162_rn(s1.x, s1.y)),
        bf2_u32(__floats2bfloat162_rn(s1.z, s1.w))};
    auto mul = [](uint32_t v, uint32_t s) {
      return bf2_u32(__hmul2(u32_bf2(v), u32_bf2(s)));
    };
    for (int r0 = ct / 8; r0 < GM; r0 += 48) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = r0 + 12 * u < GM ? *reinterpret_cast<const uint4*>(
                                      tile + swz128(r0 + 12 * u, 16 * ch))
                                : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r0 + 12 * u < GM)
          *reinterpret_cast<uint4*>(tile + swz128(r0 + 12 * u, 16 * ch)) =
              make_uint4(mul(v[u].x, sc[0]), mul(v[u].y, sc[1]),
                         mul(v[u].z, sc[2]), mul(v[u].w, sc[3]));
    }
  }
  __device__ bool restart(int) const { return false; }
  __device__ bool flush(int) const { return false; }
  __device__ void issued(int, int) {}
  template <int A>
  __device__ void after(int, float (&)[A], int) {}

  // fn(a0, a1, entry): the thread's accumulator entries of a token and
  // two neighbouring columns, and the first's entry in the staged tile
  // (tokens 8 j + 2 t (+ 1); tile columns 128 mt + 64 c + 16 warp + 2 g
  // (+ 1))
  template <class F>
  __device__ void each(float* acc, int c, unsigned char* out_s, F fn) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int bc = 64 * c + 16 * warp + 2 * (lane >> 2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = (128 * mt + bc) * ES;
          fn(acc[64 * mt + 4 * j + e], acc[64 * mt + 4 * j + e + 2],
             reinterpret_cast<CT*>(out_s + (x >> 7) * (GM * 128) +
                                   swz128(2 * (lane & 3) + e, x & 127) +
                                   1024 * j));
        }
  }
  template <int A>
  __device__ void begin(float (&acc)[A], int c, unsigned char* out_s,
                        uint32_t bar) {
    mbar_wait(bar, 0);
    each(acc, c, out_s, [](float& a0, float& a1, const CT* e) {
      const float2 v = ld2(e);
      a0 = v.x;
      a1 = v.y;
    });
  }
  template <int A>
  __device__ void end(float (&acc)[A], int c, unsigned char*,
                      unsigned char* out_s, uint32_t) {
    each(acc, c, out_s,
         [](float& a0, float& a1, CT* e) { put2(e, a0, a1); });
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < 2 * ES; ++b)
        tma_store(&p.out_map, smem_u32(out_s) + b * GM * 128,
                  col(b * 128 / ES), t0);
      tma_store_commit_wait();
    }
  }
};

// csp_mlp_mm2_wq replaces _mm2_kernel with int8 weights (:216, :249-256)
// and the fc2 half of _fused_kernel's wq branch (:446-452).  Bound:
// operations, 0.107 ms at the FLUX shape.  Mm2W4 with one code a byte:
// out^T = W^T delta^T, the codes of the stage's 64 k rows by TMA as MT raw
// boxes [64][128 bytes] (128-byte swizzle), each byte read once: a CTA
// per (128 tokens, CW = 128 MT output columns [cb, cb + CW)); a consumer
// warpgroup takes 64 columns of each box (MT m64 tiles).  Two
// ldmatrix.trans a box and stage give a thread, for k pairs, the bytes of
// two neighbouring columns, which one PRMT parts into its fragment rows g
// and g + 8 (a column pair) and s8x2 converts.  The delta is scaled by
// bf16(w2s[k]) in place by the producer's warps 1-3 (Mm2W4::convert), or,
// with PRE (the csp_mlp_fused path), arrives scaled from Mm1Wq's epilogue
// (22% faster at the FLUX shape on an H100).  The out tile comes in and
// goes out by TMA.  MT 2 (256 columns) where C allows, else 1 (two
// fragment sets; 60% slower at the FLUX shape: the scaling is paid twice
// per product).
template <int MT_, class CT, bool PRE>
struct Mm2Wq : Mm2W4<CT> {
  using Base = Mm2W4<CT>;
  static constexpr bool CONVERT = !PRE;
  static constexpr int MT = MT_, CW = 128 * MT_;    // output columns
  static constexpr int ES = sizeof(CT);              // bytes of an entry
  static constexpr int EXTRA = GM * CW * ES;         // the out tile
  static constexpr int RAW = MT * 64 * 128;
  static constexpr int FIT =
      (sm90::SMEM_MAX - 1024 - EXTRA - 256) / (Base::BN * GK + RAW);
  static constexpr int ST = FIT >= 6 ? 6 : FIT, RS = ST;

  __device__ Mm2Wq(const typename Base::Params& p_) : Base(p_) {
    this->cb = blockIdx.y * CW;
  }
  __device__ void side_load(uint32_t extra, uint32_t bar) const {
    mbar_expect_tx(bar, EXTRA);
    for (int b = 0; b < MT * ES; ++b)
      tma_load(extra + b * GM * 128, &this->p.out_map, bar,
               this->cb + b * 128 / ES, this->t0, 0);
  }
  __device__ void raw_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                           int i) const {
    for (int b = 0; b < MT; ++b)
      tma_load(dst + b * 64 * 128, map, bar, this->cb + 128 * b,
               this->krow(i), 0);
  }
  // A: as Mm2W4's, the box of tile mt at byte 8192 mt
  __device__ void a_frag(int, int c, const unsigned char* raw,
                         uint32_t (&af)[MT][4][4]) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int col0 = 64 * c + 16 * warp;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint32_t v[4];
        ldsm_x4_t(v, raw + 64 * 128 * mt + swz128(32 * kp + lane, col0));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int kk = 2 * kp + m / 2, hh = m % 2;
          af[mt][kk][2 * hh] = s8x2(__byte_perm(v[m], 0, 0x4240));
          af[mt][kk][2 * hh + 1] = s8x2(__byte_perm(v[m], 0, 0x4341));
        }
      }
  }

  // fn(a0, a1, entry): as Mm2W4::each, over the MT tiles (tile columns
  // 128 mt + 64 c + 16 warp + 2 g (+ 1))
  template <class F>
  __device__ void each(float* acc, int c, unsigned char* out_s, F fn) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int bc = 64 * c + 16 * warp + 2 * (lane >> 2);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = (128 * mt + bc) * ES;
          fn(acc[64 * mt + 4 * j + e], acc[64 * mt + 4 * j + e + 2],
             reinterpret_cast<CT*>(out_s + (x >> 7) * (GM * 128) +
                                   swz128(2 * (lane & 3) + e, x & 127) +
                                   1024 * j));
        }
  }
  template <int A>
  __device__ void begin(float (&acc)[A], int c, unsigned char* out_s,
                        uint32_t bar) {
    mbar_wait(bar, 0);
    each(acc, c, out_s, [](float& a0, float& a1, const CT* e) {
      const float2 v = ld2(e);
      a0 = v.x;
      a1 = v.y;
    });
  }
  template <int A>
  __device__ void end(float (&acc)[A], int c, unsigned char*,
                      unsigned char* out_s, uint32_t) {
    each(acc, c, out_s,
         [](float& a0, float& a1, CT* e) { put2(e, a0, a1); });
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < MT * ES; ++b)
        tma_store(&this->p.out_map, smem_u32(out_s) + b * GM * 128,
                  this->cb + b * 128 / ES, this->t0);
      tma_store_commit_wait();
    }
  }
};

// ------------------------- a8w4: int4 weights, int8 x, on Hopper

// The codes of four offset-binary nibbles as s8, times 16: a nibble n
// moved into the high half of its byte with its top bit flipped is 16 (n
// - 8) in two's complement.  lo: the low nibbles of x's four bytes; hi:
// the high ones.  The s32 products are then 16 times the reference's
// (|16 x 8 x 127 x C| < 2^31 for C < 132,000) and are shifted back before
// any float step: exact, each sum being a multiple of 16.
__device__ __forceinline__ uint32_t nib_lo16(uint32_t x) {
  return ((x << 4) & 0xF0F0F0F0u) ^ 0x80808080u;
}

__device__ __forceinline__ uint32_t nib_hi16(uint32_t x) {
  return (x & 0xF0F0F0F0u) ^ 0x80808080u;
}

// csp_mlp_mm1_a8 with int4 weights replaces the fc1 half of
// _fused_kernel's a8 + w4 branch (chipmunk_tpu/kernels/csp_mlp.py:326,
// :389-401).  Bound: operations, 2 bm bn C per selected (token block,
// neuron block), 0.054 ms at the FLUX shape at 1979 TOP/s.  The product
// is taken transposed, act^T = W1 x8^T, so that the codes are s8
// wgmma's A operand, built in registers from raw TMA boxes of the packed
// bytes: no widened copy of the weight in memory or in shared memory.
// One CTA per (TOK-token tile, selected neuron block j) holds the whole
// block (bn = 128 MT neurons: two consumer warpgroups of MT m64 tiles),
// as the row max of |ds| spans it: B = x8 rows [t0, t0 + TOK) by TMA, 128
// k a stage; the packed rows [n0, n0 + bn) by TMA as raw boxes [bn][128
// bytes] (128-byte swizzle), byte columns [128 q, 128 q + 128) read once
// from memory and feeding two stages, the low nibbles (k = 128 q + x) and
// the high ones (k = C/2 + 128 q + x).  A fragment register is one 32-bit
// read of a row: 4 consecutive k of both planes; fragment rows g and g +
// 8 of warp w are the neurons 16 w + 2 g and 16 w + 2 g + 1, so that a
// thread's entries pair up along the act cache's rows.  Epilogue per
// thread (neuron pairs of its MT tiles, TOK / 4 tokens): mid = fma(sum,
// sx[t] w1s[n], b1[n]) and the act's code; against the old act tile
// staged by TMA under the products, which takes the codes; ds = delta *
// w2s[n]; the row max of |ds| over the quad's rows (shfl_xor over g),
// then over the 8 warps through shared memory; sd, and d8 staged in the
// free ring; both tiles stored by TMA.  A slot past the count only writes
// its zeros.
template <int MT_, int TOK, class CT>
struct Mm1A8W4 {
  static constexpr int BN = TOK;                     // B rows: tokens
  static constexpr int MT = MT_, BNB = 128 * MT_;    // the neuron block
  static constexpr int ES = sizeof(CT);              // bytes of an entry
  static constexpr int EXTRA = TOK * BNB * ES;       // the act tile
  static constexpr int RAW = BNB * 128, RS = 2, EVERY = 2;
  static constexpr bool B_MN = false, CONVERT = false;
  static constexpr int FIT =
      (sm90::SMEM_MAX - 1024 - EXTRA - 256 - RS * RAW) / (TOK * GK);
  static constexpr int ST = FIT >= 6 ? 6 : FIT >= 4 ? 4 : FIT;
  static_assert(ST * TOK * GK >= TOK * BNB, "the d8 tile in the ring");
  static_assert(RS * RAW >= 9 * TOK * 4, "the row-max exchange");
  struct Params {
    CUtensorMap act_map;     // act cache [T][N], box [TOK rows][128 bytes]
    CUtensorMap d8_map;      // d8 [T][jmax bn], box [TOK rows][128 bytes]
    const float* sx;
    const float* w1s;
    const __nv_bfloat16* b1;
    const float* w2s;
    const int* inds;
    const int* counts;
    int8_t* d8;
    float* sd;
    int C, jmax, bm;
  };
  const Params& p;
  int t0, j, n0;
  bool on;

  __device__ Mm1A8W4(const Params& p_) : p(p_) {
    t0 = blockIdx.x * TOK;
    j = blockIdx.y;
    const int m = t0 / p.bm;
    on = j < count_of(p.counts, m, p.jmax);
    n0 = on ? p.inds[(size_t)m * p.jmax + j] * BNB : 0;
  }
  __device__ bool live() const { return on; }
  __device__ void idle() const {
    const size_t P = (size_t)p.jmax * BNB;
    int8_t* dq = p.d8 + (size_t)t0 * P + (size_t)j * BNB;
    for (int id = threadIdx.x; id < TOK * BNB / 16; id += blockDim.x)
      *reinterpret_cast<uint4*>(dq + (id / (BNB / 16)) * P +
                                (id % (BNB / 16)) * 16) =
          make_uint4(0, 0, 0, 0);
    if (threadIdx.x < TOK)
      p.sd[(size_t)(t0 + threadIdx.x) * p.jmax + j] = 0.f;
  }
  __device__ int tiles() const { return p.C / GK; }
  __device__ void side_load(uint32_t extra, uint32_t bar) const {
    mbar_expect_tx(bar, EXTRA);
    for (int b = 0; b < BNB * ES / 128; ++b)
      tma_load(extra + b * TOK * 128, &p.act_map, bar, n0 + b * 128 / ES,
               t0, 0);
  }
  // stage i: plane i % 2 of raw box i / 2
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    kb = (i & 1) * (p.C / 2) + GK * (i >> 1);
    rb = t0;
    ka = ra = 0;
  }
  __device__ void raw_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                           int q) const {
    tma_load(dst, map, bar, 128 * q, n0, 0);
  }
  __device__ void a_frag(int i, int c, const unsigned char* raw,
                         uint32_t (&af)[MT][4][4]) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r0 = 64 * (MT * c + mt) + 16 * warp + 2 * (lane >> 2);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                raw + swz128(r0 + rr, 32 * kk + 16 * h + 4 * (lane & 3)));
            af[mt][kk][2 * h + rr] = (i & 1) ? nib_hi16(v) : nib_lo16(v);
          }
    }
  }
  __device__ bool restart(int i) const { return i == 0; }
  __device__ bool flush(int) const { return false; }
  __device__ void issued(int, int) {}
  template <int A>
  __device__ void begin(int (&)[A], int, unsigned char*, uint32_t) {}
  template <int A>
  __device__ void after(int, int (&)[A], int) {}

  // fn(a0, a1, mt, jt, r, nl): the accumulator entries of the thread's
  // tile token 8 jt + r (r < 8: its swizzled place is that of row r plus
  // 1024 jt bytes) and neurons nl, nl + 1 of the block, tile mt
  template <class F>
  __device__ void each(int* acc, int c, F fn) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    constexpr int ACC = TOK / 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jt = 0; jt < TOK / 8; ++jt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          fn(acc[ACC * mt + 4 * jt + e], acc[ACC * mt + 4 * jt + e + 2], mt,
             jt, 2 * (lane & 3) + e,
             64 * (MT * c + mt) + 16 * warp + 2 * (lane >> 2));
  }
  template <int A>
  __device__ void end(int (&acc)[A], int c, unsigned char* ring,
                      unsigned char* act_s, uint32_t bar) {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    // In passes, as Mm1A8, each pair's results packed into the register
    // of its first entry.  1: mid, then the two acts' codes (16 bits each).
    each(acc, c, [&](int& a0, int& a1, int, int jt, int r, int nl) {
      const float s = __ldg(p.sx + t0 + 8 * jt + r);
      const float2 ws = __ldg(reinterpret_cast<const float2*>(p.w1s + n0 + nl));
      const float2 bb = __bfloat1622float2(__ldg(
          reinterpret_cast<const __nv_bfloat162*>(p.b1 + n0 + nl)));
      a0 = (int)((uint32_t)act_code<CT>(gelu_tanh(__fmaf_rn(
                     (float)(a0 >> 4), __fmul_rn(s, ws.x), bb.x))) |
                 (uint32_t)act_code<CT>(gelu_tanh(__fmaf_rn(
                     (float)(a1 >> 4), __fmul_rn(s, ws.y), bb.y))) << 16);
    });
    // 2: against the staged old entries, which take the new codes; ds =
    // delta * w2s[n] (in place of the codes) and each token's max of |ds|
    float rmax[TOK / 8][2] = {};
    mbar_wait(bar, 0);
    each(acc, c, [&](int& a0, int& a1, int, int jt, int r, int nl) {
      const float2 vs = __ldg(reinterpret_cast<const float2*>(p.w2s + n0 + nl));
      const int x = nl * ES;
      CT* e = reinterpret_cast<CT*>(act_s + (x >> 7) * (TOK * 128) +
                                    swz128(r, x & 127) + 1024 * jt);
      const float2 old = ld2(e);
      const uint32_t w = (uint32_t)a0;
      const float2 a = put_codes(e, w & 0xffff, w >> 16);
      const float v0 = __fmul_rn(a.x - old.x, vs.x);
      const float v1 = __fmul_rn(a.y - old.y, vs.y);
      a0 = __float_as_int(v0);
      a1 = __float_as_int(v1);
      float& m = rmax[jt][r & 1];
      m = nanmax(m, nanmax(fabsf(v0), fabsf(v1)));
    });
    // 3: each token's max over the block: the quad's eight rows g, then
    // the eight warps through shared memory past the ring (the raw boxes,
    // free once both consumers are past them)
#pragma unroll
    for (int jt = 0; jt < TOK / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = rmax[jt][e];
        v = nanmax(v, __shfl_xor_sync(~0u, v, 4));
        v = nanmax(v, __shfl_xor_sync(~0u, v, 8));
        v = nanmax(v, __shfl_xor_sync(~0u, v, 16));
        rmax[jt][e] = v;
      }
    float* red = reinterpret_cast<float*>(ring + ST * TOK * GK);  // [8][TOK]
    float* sdt = red + 8 * TOK;
    bar_sync(1, 256);                  // both consumers are past the ring
    if (lane < 4) {
#pragma unroll
      for (int jt = 0; jt < TOK / 8; ++jt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[(4 * c + warp) * TOK + 8 * jt + 2 * lane + e] = rmax[jt][e];
    }
    bar_sync(1, 256);
    const int tid = threadIdx.x - 128;
    if (tid < TOK) {
      float v = red[tid];
#pragma unroll
      for (int w = 1; w < 8; ++w) v = nanmax(v, red[w * TOK + tid]);
      const float sdv = __fmul_rn(nanmax(v, 1e-12f), INV127);
      sdt[tid] = sdv;
      p.sd[(size_t)(t0 + tid) * p.jmax + j] = sdv;
    }
    bar_sync(1, 256);
    // 4: d8 into the ring, BNB / 128 boxes [TOK rows][128 bytes]
    each(acc, c, [&](int& a0, int& a1, int, int jt, int r, int nl) {
      const float s = sdt[8 * jt + r];
      *reinterpret_cast<uint16_t*>(ring + (nl >> 7) * (TOK * 128) +
                                   swz128(r, nl & 127) + 1024 * jt) =
          (uint16_t)((q8(div_rn(__int_as_float(a0), s)) & 0xff) |
                     ((q8(div_rn(__int_as_float(a1), s)) & 0xff) << 8));
    });
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < BNB * ES / 128; ++b)
        tma_store(&p.act_map, smem_u32(act_s) + b * TOK * 128,
                  n0 + b * 128 / ES, t0);
      for (int b = 0; b < BNB / 128; ++b)
        tma_store(&p.d8_map, smem_u32(ring) + b * TOK * 128,
                  j * BNB + 128 * b, t0);
      tma_store_commit_wait();
    }
  }
};

// A neuron block wider than 256: Mm1A8W4 per BNB-neuron sub-block s of
// selected block j, grid (T / TOK, jmax * bn / BNB), in the split mode of
// Mm1A8Part (the act cache refreshed; ds and each token's sub-block max
// of |ds| written; sd and d8 by a8_split_finish_kernel).
template <int MT_, int TOK, class CT>
struct Mm1A8W4Part : Mm1A8W4<MT_, TOK, CT> {
  using Base = Mm1A8W4<MT_, TOK, CT>;
  using Base::BNB;
  struct Params : Base::Params {
    float* ds;
    float* pmax;
    int bn;
  };
  const Params& q;
  int s;                     // the sub-block

  __device__ Mm1A8W4Part(const Params& p_) : Base(p_), q(p_) {
    const int S = q.bn / BNB, m = this->t0 / q.bm;
    this->j = blockIdx.y / S;
    s = blockIdx.y % S;
    this->on = this->j < count_of(q.counts, m, q.jmax);
    this->n0 = this->on
                   ? q.inds[(size_t)m * q.jmax + this->j] * q.bn + s * BNB
                   : 0;
  }
  __device__ void idle() const {}

  // One pass per entry, as Mm1A8Part's, in Mm1A8W4's operations; then each
  // token's max of |ds| over the quad's rows and the eight warps (through
  // the raw boxes, free once both consumers are past them)
  template <int A>
  __device__ void end(int (&acc)[A], int c, unsigned char* ring,
                      unsigned char* act_s, uint32_t bar) {
    constexpr int ES = Base::ES;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int t0 = this->t0, j = this->j, n0 = this->n0, S = q.bn / BNB;
    const size_t P = (size_t)q.jmax * q.bn;
    float* ds = q.ds + (size_t)t0 * P + j * q.bn + s * BNB;
    float rmax[TOK / 8][2] = {};
    mbar_wait(bar, 0);
    this->each(acc, c, [&](int& a0, int& a1, int, int jt, int r, int nl) {
      const float sx = __ldg(q.sx + t0 + 8 * jt + r);
      const float2 ws = __ldg(reinterpret_cast<const float2*>(q.w1s + n0 + nl));
      const float2 bb = __bfloat1622float2(__ldg(
          reinterpret_cast<const __nv_bfloat162*>(q.b1 + n0 + nl)));
      const float2 vs = __ldg(reinterpret_cast<const float2*>(q.w2s + n0 + nl));
      const int x = nl * ES;
      CT* e = reinterpret_cast<CT*>(act_s + (x >> 7) * (TOK * 128) +
                                    swz128(r, x & 127) + 1024 * jt);
      const float2 old = ld2(e);
      const float2 a = put_codes(
          e,
          act_code<CT>(gelu_tanh(__fmaf_rn((float)(a0 >> 4),
                                           __fmul_rn(sx, ws.x), bb.x))),
          act_code<CT>(gelu_tanh(__fmaf_rn((float)(a1 >> 4),
                                           __fmul_rn(sx, ws.y), bb.y))));
      const float v0 = __fmul_rn(a.x - old.x, vs.x);
      const float v1 = __fmul_rn(a.y - old.y, vs.y);
      *reinterpret_cast<float2*>(ds + (8 * jt + r) * P + nl) =
          make_float2(v0, v1);
      float& m = rmax[jt][r & 1];
      m = nanmax(m, nanmax(fabsf(v0), fabsf(v1)));
    });
#pragma unroll
    for (int jt = 0; jt < TOK / 8; ++jt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = rmax[jt][e];
        v = nanmax(v, __shfl_xor_sync(~0u, v, 4));
        v = nanmax(v, __shfl_xor_sync(~0u, v, 8));
        v = nanmax(v, __shfl_xor_sync(~0u, v, 16));
        rmax[jt][e] = v;
      }
    float* red = reinterpret_cast<float*>(ring + Base::ST * TOK * GK);
    bar_sync(1, 256);                  // both consumers are past the ring
    if (lane < 4) {
#pragma unroll
      for (int jt = 0; jt < TOK / 8; ++jt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          red[(4 * c + warp) * TOK + 8 * jt + 2 * lane + e] = rmax[jt][e];
    }
    bar_sync(1, 256);
    const int tid = threadIdx.x - 128;
    if (tid < TOK) {
      float v = red[tid];
#pragma unroll
      for (int w = 1; w < 8; ++w) v = nanmax(v, red[w * TOK + tid]);
      q.pmax[((size_t)(t0 + tid) * q.jmax + j) * S + s] = v;
    }
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < BNB * ES / 128; ++b)
        tma_store(&q.act_map, smem_u32(act_s) + b * TOK * 128,
                  n0 + b * 128 / ES, t0);
      tma_store_commit_wait();
    }
  }
};

// csp_mlp_mm2_a8 with int4 weights replaces the fc2 half of
// _fused_kernel's a8 + w4 branch (same site, :413-426).  Bound:
// operations, 0.054 ms at the FLUX shape.  Transposed as mm1: out^T =
// W2^T d8^T, the codes as s8 wgmma's A operand in registers.  One CTA per
// (64-token tile, 128 byte columns [cb, cb + 128) of the packed codes),
// which hold the 256 output columns [cb, cb + 128) (low nibbles) and
// [C/2 + cb, C/2 + cb + 128) (high): B = d8 rows [t0, t0 + 64) at slot
// j's k, 128 k a stage; the codes of the stage's 128 k rows by TMA as one
// raw box [128][128 bytes] (128-byte swizzle), each byte read once.  64
// tokens, as each of the two m64 tiles a consumer warpgroup holds (its 64
// byte columns, both planes) needs an s32 block sum and an f32 running
// sum: 128 + 128 registers at 128 tokens, over the 240 a consumer has.
// The s8 fragment wants 4 consecutive k of one column in a register; the
// codes lie [k][c], so one ldmatrix.trans a k-step gives each thread two
// k pairs of two neighbouring columns (its fragment rows g and g + 8),
// which PRMT merges.  Its four 8 x 16-byte matrices are each the rows of
// one k pair of each thread of a quad, the first pair (k 4t, 4t + 1) of
// threads 0-1 with the second (4t + 2, 4t + 3) of threads 2-3 and the
// reverse: eight rows in eight different swizzle phases, free of bank
// conflicts, the PRMT selector swapping the halves for threads 2-3.  A
// block's s32 sum (bn / 128 stages) goes into the f32 sum as fma(f32(sum),
// sd[t, j], acc), the reference's order, its sd read while the block's
// first products run.  The sum starts as f32(out_cache) from the out tile
// staged by TMA, is rounded into the tile and goes out by TMA.
template <class CT>
struct Mm2A8W4 {
  static constexpr int BN = 64;                      // B rows: tokens
  static constexpr int ES = sizeof(CT);              // bytes of an entry
  static constexpr int EXTRA = BN * 256 * ES;        // the out tile
  static constexpr int RAW = 128 * 128, EVERY = 1, MT = 2;
  static constexpr bool B_MN = false, CONVERT = false;
  static constexpr int FIT =
      (sm90::SMEM_MAX - 1024 - EXTRA - 256) / (BN * GK + RAW);
  static constexpr int ST = FIT >= 6 ? 6 : FIT, RS = ST;
  struct Params {
    CUtensorMap out_map;     // out cache [T][C], box [64 rows][128 bytes]
    const float* sd;
    const int* inds;
    const int* counts;
    int jmax, bn, bm, C;
  };
  const Params& p;
  int t0, cb, per, cnt;
  const int* row;
  float f[64];                 // the f32 sums of the thread's entries
  float sdr[16];               // the current block's sd of its 16 tokens

  __device__ Mm2A8W4(const Params& p_) : p(p_) {
    t0 = blockIdx.x * BN;
    cb = blockIdx.y * 128;
    const int m = t0 / p.bm;
    per = p.bn / GK;
    cnt = count_of(p.counts, m, p.jmax);
    row = p.inds + (size_t)m * p.jmax;
  }
  __device__ bool live() const { return true; }
  __device__ void idle() const {}
  __device__ int tiles() const { return cnt * per; }
  // the weight row of stage i's first k; the output column of tile
  // column x
  __device__ int krow(int i) const {
    return row[i / per] * p.bn + (i % per) * GK;
  }
  __device__ int col(int x) const {
    return cb + x + (x >= 128 ? p.C / 2 - 128 : 0);
  }
  __device__ void side_load(uint32_t extra, uint32_t bar) const {
    mbar_expect_tx(bar, EXTRA);
    for (int b = 0; b < 2 * ES; ++b)
      tma_load(extra + b * BN * 128, &p.out_map, bar, col(b * 128 / ES), t0,
               0);
  }
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    kb = (i / per) * p.bn + (i % per) * GK;
    rb = t0;
    ka = ra = 0;
  }
  __device__ void raw_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                           int i) const {
    tma_load(dst, map, bar, cb, krow(i), 0);
  }
  // A: lane 8 mi + 2 u + b addresses k row 16 (mi / 2) + 4 u + 2 s + b,
  // s = (mi % 2) ^ (u >= 2), of the warp's 16 byte columns; thread (g, t)
  // then holds in v[2 h], v[2 h + 1] the k pairs (4 t, 4 t + 1) and (4 t +
  // 2, 4 t + 3) of k half h (swapped for t >= 2) of the columns 16 warp +
  // 2 g (low byte of each pair) and + 1
  __device__ void a_frag(int, int c, const unsigned char* raw,
                         uint32_t (&af)[2][4][4]) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int mi = lane >> 3, u = (lane >> 1) & 3;
    const int kl = 16 * (mi >> 1) + 4 * u + 2 * ((mi & 1) ^ (u >> 1)) +
                   (lane & 1);
    const bool sw = (lane & 3) >= 2;
    const uint32_t sel_e = sw ? 0x2064 : 0x6420, sel_o = sw ? 0x3175 : 0x7531;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t v[4];
      ldsm_x4_t(v, raw + swz128(32 * kk + kl, 64 * c + 16 * warp));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t ev = __byte_perm(v[2 * h], v[2 * h + 1], sel_e);
        const uint32_t od = __byte_perm(v[2 * h], v[2 * h + 1], sel_o);
        af[0][kk][2 * h] = nib_lo16(ev);
        af[0][kk][2 * h + 1] = nib_lo16(od);
        af[1][kk][2 * h] = nib_hi16(ev);
        af[1][kk][2 * h + 1] = nib_hi16(od);
      }
    }
  }
  __device__ bool restart(int i) const { return i % per == 0; }
  __device__ bool flush(int i) const { return i % per == per - 1; }
  // at a block's first stage, its sd of the thread's tokens 8 jt + 2 t +
  // e (read while the products run)
  __device__ void issued(int i, int) {
    if (i % per) return;
    const float* s = p.sd + (size_t)(t0 + 2 * (threadIdx.x & 3)) * p.jmax +
                     i / per;
#pragma unroll
    for (int jt = 0; jt < 8; ++jt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        sdr[2 * jt + e] = s[(size_t)(8 * jt + e) * p.jmax];
  }
  template <int A>
  __device__ void after(int, int (&acc)[A], int) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jt = 0; jt < 8; ++jt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 32 * mt + 4 * jt + e;
          f[k] = __fmaf_rn((float)(acc[k] >> 4), sdr[2 * jt + (e & 1)],
                           f[k]);
        }
  }

  // fn(k, entry): the thread's accumulator pair k, k + 2 (a token and two
  // neighbouring columns) and the first's entry in the staged tile
  // (tokens 8 jt + 2 t (+ 1); tile columns 128 mt + 64 c + 16 warp + 2 g
  // (+ 1))
  template <class F>
  __device__ void each(int c, unsigned char* out_s, F fn) const {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int bc = 64 * c + 16 * warp + 2 * (lane >> 2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int jt = 0; jt < 8; ++jt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = (128 * mt + bc) * ES;
          fn(32 * mt + 4 * jt + e,
             reinterpret_cast<CT*>(out_s + (x >> 7) * (BN * 128) +
                                   swz128(2 * (lane & 3) + e, x & 127) +
                                   1024 * jt));
        }
  }
  template <int A>
  __device__ void begin(int (&)[A], int c, unsigned char* out_s,
                        uint32_t bar) {
    mbar_wait(bar, 0);
    each(c, out_s, [&](int k, const CT* e) {
      const float2 v = ld2(e);
      f[k] = v.x;
      f[k + 2] = v.y;
    });
  }
  template <int A>
  __device__ void end(int (&)[A], int c, unsigned char*,
                      unsigned char* out_s, uint32_t) {
    each(c, out_s, [&](int k, CT* e) { put2(e, f[k], f[k + 2]); });
    fence_async();
    bar_sync(1, 256);
    if (threadIdx.x == 128) {
      for (int b = 0; b < 2 * ES; ++b)
        tma_store(&p.out_map, smem_u32(out_s) + b * BN * 128,
                  col(b * 128 / ES), t0);
      tma_store_commit_wait();
    }
  }
};

// Run f with a null pointer of the cache's type: bf16 (flag set) or fp8.
template <class F>
int with_cache(int bf16, F f) {
  return bf16 ? f((__nv_bfloat16*)nullptr) : f((uint8_t*)nullptr);
}

}  // namespace

// Each *_bf16 flag says the cache it names is bf16; else it is fp8 e4m3.

template <int BN, class CT>
static int launch_mm1_bf16(const void* x, const void* w1t, const void* b1,
                           void* act_cache, const void* inds,
                           const void* counts, void* packed, int T, int C,
                           int N, int jmax, int bn, int bm,
                           cudaStream_t stream) {
  using Op = Mm1Bf16<BN, CT>;
  typename Op::Params p{};
  CUtensorMap ta, tb;
  int err = make_byte_map(&ta, x, T, (long long)C * 2, GM, 2);
  if (err == 0) err = make_byte_map(&tb, w1t, N, (long long)C * 2, BN, 2);
  if (err == 0)
    err = make_byte_map(&p.act_map, act_cache, T, (long long)N * Op::ES, GM,
                        Op::ES);
  if (err == 0)
    err = make_byte_map(&p.pk_map, packed, T, (long long)jmax * bn * 2, GM,
                        2);
  if (err != 0) return err;
  p.b1 = (const __nv_bfloat16*)b1;
  p.inds = (const int*)inds;
  p.counts = (const int*)counts;
  p.packed = (__nv_bfloat16*)packed;
  p.jmax = jmax;
  p.bn = bn;
  p.bm = bm;
  p.C = C;
  return launch_gemm<__nv_bfloat16, Op>(ta, tb, p,
                                        dim3(T / GM, jmax * (bn / BN)),
                                        stream);
}

template <int BN, class CT>
static int launch_mm2_bf16(const void* packed, const void* w2,
                           void* out_cache, const void* inds,
                           const void* counts, int T, int C, int N, int jmax,
                           int bn, int bm, cudaStream_t stream) {
  using Op = Mm2Bf16<BN, CT>;
  typename Op::Params p{};
  CUtensorMap ta, tb;
  int err = make_byte_map(&ta, packed, T, (long long)jmax * bn * 2, GM, 2);
  if (err == 0) err = make_byte_map(&tb, w2, N, (long long)C * 2, 64, 2);
  if (err == 0)
    err = make_byte_map(&p.out_map, out_cache, T, (long long)C * Op::ES, GM,
                        Op::ES);
  if (err != 0) return err;
  p.inds = (const int*)inds;
  p.counts = (const int*)counts;
  p.jmax = jmax;
  p.bn = bn;
  p.bm = bm;
  return launch_gemm<__nv_bfloat16, Op>(ta, tb, p, dim3(T / GM, C / BN),
                                        stream);
}

// A CTA takes 256 neurons where bn allows, else 128 (bn a multiple of 128).
extern "C" int chipmunk_csp_mlp_mm1(const void* x, const void* w1t,
                                    const void* b1, void* act_cache,
                                    const void* inds, const void* counts,
                                    void* packed, int T, int C, int N, int jmax,
                                    int bn, int bm, int act_bf16,
                                    void* stream) {
  if (bn % 128 || bm % GM || T % bm || C % 64)
    return (int)cudaErrorInvalidValue;
  const int tile = bn % 256 ? 128 : 256;
  return with_cache(act_bf16, [&](auto tag) {
    using CT = std::remove_pointer_t<decltype(tag)>;
    auto launch = tile == 256 ? launch_mm1_bf16<256, CT>
                              : launch_mm1_bf16<128, CT>;
    return launch(x, w1t, b1, act_cache, inds, counts, packed, T, C, N, jmax,
                  bn, bm, (cudaStream_t)stream);
  });
}

// A CTA takes 256 output columns where C allows, else 128 (C a multiple
// of 128).
extern "C" int chipmunk_csp_mlp_mm2(const void* packed, const void* w2,
                                    void* out_cache, const void* inds,
                                    const void* counts, int T, int C, int N,
                                    int jmax, int bn, int bm, int out_bf16,
                                    void* stream) {
  if (C % 128 || bm % GM || T % bm || bn % 64)
    return (int)cudaErrorInvalidValue;
  const int tile = C % 256 ? 128 : 256;
  return with_cache(out_bf16, [&](auto tag) {
    using CT = std::remove_pointer_t<decltype(tag)>;
    auto launch = tile == 256 ? launch_mm2_bf16<256, CT>
                              : launch_mm2_bf16<128, CT>;
    return launch(packed, w2, out_cache, inds, counts, T, C, N, jmax, bn, bm,
                  (cudaStream_t)stream);
  });
}

template <class P, class = void>
struct has_w2s : std::false_type {};
template <class P>
struct has_w2s<P, std::void_t<decltype(P::w2s)>> : std::true_type {};

// The quantized-weight mm1 with bf16 x (Mm1W4 or Mm1Wq): wbytes, the
// bytes of a row of codes (C / 2 or C); w2s for Mm1Wq's S2.
template <class Op>
static int launch_mm1_q(const void* x, const void* w1q, const void* w1s,
                        const void* b1, void* act_cache, const void* inds,
                        const void* counts, void* packed, const void* w2s,
                        int T, int C, int N, int jmax, int bn, int bm,
                        int wbytes, cudaStream_t stream) {
  constexpr int NT = Op::BN;
  typename Op::Params p{};
  CUtensorMap ta, tb;
  int err = make_byte_map(&ta, w1q, N, wbytes, 128);
  if (err == 0) err = make_byte_map(&tb, x, T, (long long)C * 2, NT, 2);
  if (err == 0)
    err = make_byte_map(&p.act_map, act_cache, T, (long long)N * Op::ES, NT,
                        Op::ES);
  if (err == 0)
    err = make_byte_map(&p.pk_map, packed, T, (long long)jmax * bn * 2, NT,
                        2);
  if (err != 0) return err;
  p.w1s = (const float*)w1s;
  p.b1 = (const __nv_bfloat16*)b1;
  p.inds = (const int*)inds;
  p.counts = (const int*)counts;
  p.packed = (__nv_bfloat16*)packed;
  p.jmax = jmax;
  p.bn = bn;
  p.bm = bm;
  p.C = C;
  if constexpr (has_w2s<typename Op::Params>::value) p.w2s = (const float*)w2s;
  return launch_gemm<__nv_bfloat16, Op>(ta, tb, p,
                                        dim3(T / NT, jmax * (bn / 128)),
                                        stream);
}

// The quantized-weight mm2 with a bf16 delta (Mm2W4 or Mm2Wq): wbytes as
// above, tiles the CTAs across C.
template <class Op>
static int launch_mm2_q(const void* packed, const void* w2q, const void* w2s,
                        void* out_cache, const void* inds, const void* counts,
                        int T, int C, int N, int jmax, int bn, int bm,
                        int wbytes, int tiles, cudaStream_t stream) {
  typename Op::Params p{};
  CUtensorMap ta, tb;
  int err = make_byte_map(&ta, w2q, N, wbytes, 64);
  if (err == 0)
    err = make_byte_map(&tb, packed, T, (long long)jmax * bn * 2, GM, 2);
  if (err == 0)
    err = make_byte_map(&p.out_map, out_cache, T, (long long)C * Op::ES, GM,
                        Op::ES);
  if (err != 0) return err;
  p.w2s = (const float*)w2s;
  p.inds = (const int*)inds;
  p.counts = (const int*)counts;
  p.jmax = jmax;
  p.bn = bn;
  p.bm = bm;
  p.C = C;
  return launch_gemm<__nv_bfloat16, Op>(ta, tb, p, dim3(T / GM, tiles),
                                        stream);
}

// w4: the weights are int4 plane-packed ([N, C/2] bytes; C a multiple of
// 256), else int8 ([N, C]; C of 128).  bm and bn multiples of 128; a CTA
// takes 256 tokens where bm allows, else 128.  w2s (int8 only; else
// null): the packed delta comes out multiplied by bf16(w2s[n]), for
// chipmunk_csp_mlp_mm2_wq with prescaled (the csp_mlp_fused path).
extern "C" int chipmunk_csp_mlp_mm1_wq(const void* x, const void* w1q,
                                       const void* w1s, const void* b1,
                                       void* act_cache, const void* inds,
                                       const void* counts, void* packed,
                                       const void* w2s, int T, int C, int N,
                                       int jmax, int bn, int bm, int w4,
                                       int act_bf16, void* stream) {
  if (bn % 128 || bm % GM || T % bm || C % (w4 ? 256 : 128) ||
      (w4 && w2s != nullptr))
    return (int)cudaErrorInvalidValue;
  return with_cache(act_bf16, [&](auto tag) {
    using CT = std::remove_pointer_t<decltype(tag)>;
    const bool t256 = bm % 256 == 0, s2 = w2s != nullptr;
    auto launch =
        w4 ? (t256 ? launch_mm1_q<Mm1W4<256, CT>>
                   : launch_mm1_q<Mm1W4<128, CT>>)
        : s2 ? (t256 ? launch_mm1_q<Mm1Wq<256, CT, true>>
                     : launch_mm1_q<Mm1Wq<128, CT, true>>)
             : (t256 ? launch_mm1_q<Mm1Wq<256, CT, false>>
                     : launch_mm1_q<Mm1Wq<128, CT, false>>);
    return launch(x, w1q, w1s, b1, act_cache, inds, counts, packed, w2s, T,
                  C, N, jmax, bn, bm, w4 ? C / 2 : C, (cudaStream_t)stream);
  });
}

// w4: int4 (C a multiple of 256, 256 columns a CTA: both planes of 128
// byte columns), else int8 (C of 128; 256 columns a CTA where C allows,
// else 128).  bm a multiple of 128, bn of 64; N the rows of w2q; w2s at a
// 16-byte boundary.  prescaled (int8 only): the packed delta is already
// multiplied by bf16(w2s[k]) (chipmunk_csp_mlp_mm1_wq with w2s).
extern "C" int chipmunk_csp_mlp_mm2_wq(const void* packed, const void* w2q,
                                       const void* w2s, void* out_cache,
                                       const void* inds, const void* counts,
                                       int T, int C, int N, int jmax, int bn,
                                       int bm, int w4, int prescaled,
                                       int out_bf16, void* stream) {
  if (C % (w4 ? 256 : 128) || bm % GM || T % bm || bn % 64 ||
      reinterpret_cast<uintptr_t>(w2s) % 16 || (w4 && prescaled))
    return (int)cudaErrorInvalidValue;
  return with_cache(out_bf16, [&](auto tag) {
    using CT = std::remove_pointer_t<decltype(tag)>;
    const bool c256 = C % 256 == 0;
    auto launch = w4 ? launch_mm2_q<Mm2W4<CT>>
                  : c256 ? (prescaled ? launch_mm2_q<Mm2Wq<2, CT, true>>
                                      : launch_mm2_q<Mm2Wq<2, CT, false>>)
                         : (prescaled ? launch_mm2_q<Mm2Wq<1, CT, true>>
                                      : launch_mm2_q<Mm2Wq<1, CT, false>>);
    return launch(packed, w2q, w2s, out_cache, inds, counts, T, C, N, jmax,
                  bn, bm, w4 ? C / 2 : C, c256 ? C / 256 : C / 128,
                  (cudaStream_t)stream);
  });
}

extern "C" int chipmunk_quant_rows(const void* x, void* x8, void* sx, int T,
                                   int C, void* stream) {
  quant_rows_kernel<<<T, NT, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (int8_t*)x8, (float*)sx, C);
  return (int)cudaGetLastError();
}

// With PART, the split mode (Mm1A8Part) over BN-neuron sub-blocks of
// the bn-neuron blocks; else bn == BN.
template <int BN, class CT, bool PART>
static int launch_mm1_a8(const void* x8, const void* sx, const void* w1q,
                         const void* w1s, const void* b1, const void* w2s,
                         void* act_cache, const void* inds, const void* counts,
                         void* d8, void* sd, void* ds, void* pmax, int T, int C,
                         int N, int jmax, int bn, int bm, cudaStream_t stream) {
  using Op = std::conditional_t<PART, Mm1A8Part<BN, CT>, Mm1A8<BN, CT>>;
  typename Op::Params p{};
  CUtensorMap ta, tb;
  int err = make_byte_map(&ta, x8, T, C, GM);
  if (err == 0) err = make_byte_map(&tb, w1q, N, C, BN);
  if (err == 0)
    err = make_byte_map(&p.act_map, act_cache, T, (long long)N * Op::ES, GM,
                        Op::ES);
  if (err == 0 && !PART)
    err = make_byte_map(&p.d8_map, d8, T, (long long)jmax * BN, GM);
  if (err != 0) return err;
  p.sx = (const float*)sx;
  p.w1s = (const float*)w1s;
  p.b1 = (const __nv_bfloat16*)b1;
  p.w2s = (const float*)w2s;
  p.inds = (const int*)inds;
  p.counts = (const int*)counts;
  p.d8 = (int8_t*)d8;
  p.sd = (float*)sd;
  p.C = C;
  p.jmax = jmax;
  p.bm = bm;
  if constexpr (PART) {
    p.ds = (float*)ds;
    p.pmax = (float*)pmax;
    p.bn = bn;
  }
  return launch_gemm<int8_t, Op>(ta, tb, p, dim3(T / GM, jmax * (bn / BN)),
                                 stream);
}

template <int MT, int TOK, class CT, bool PART>
static int launch_mm1_a8w4(const void* x8, const void* sx, const void* w1q,
                           const void* w1s, const void* b1, const void* w2s,
                           void* act_cache, const void* inds,
                           const void* counts, void* d8, void* sd, void* ds,
                           void* pmax, int T, int C, int N, int jmax, int bn,
                           int bm, cudaStream_t stream) {
  using Op = std::conditional_t<PART, Mm1A8W4Part<MT, TOK, CT>,
                                Mm1A8W4<MT, TOK, CT>>;
  typename Op::Params p{};
  CUtensorMap ta, tb;
  int err = make_byte_map(&ta, w1q, N, C / 2, Op::BNB);
  if (err == 0) err = make_byte_map(&tb, x8, T, C, TOK);
  if (err == 0)
    err = make_byte_map(&p.act_map, act_cache, T, (long long)N * Op::ES, TOK,
                        Op::ES);
  if (err == 0 && !PART)
    err = make_byte_map(&p.d8_map, d8, T, (long long)jmax * Op::BNB, TOK);
  if (err != 0) return err;
  p.sx = (const float*)sx;
  p.w1s = (const float*)w1s;
  p.b1 = (const __nv_bfloat16*)b1;
  p.w2s = (const float*)w2s;
  p.inds = (const int*)inds;
  p.counts = (const int*)counts;
  p.d8 = (int8_t*)d8;
  p.sd = (float*)sd;
  p.C = C;
  p.jmax = jmax;
  p.bm = bm;
  if constexpr (PART) {
    p.ds = (float*)ds;
    p.pmax = (float*)pmax;
    p.bn = bn;
  }
  return launch_gemm<int8_t, Op>(ta, tb, p,
                                 dim3(T / TOK, jmax * (bn / Op::BNB)), stream);
}

// bn a multiple of 128.  w4: int4 weights (bm a multiple of 64, C of 256;
// a CTA takes 128 tokens where bm allows, else 64); else int8 (bm a
// multiple of 128).  bn > 256 takes the split mode in 256-neuron
// sub-blocks (128 where 256 does not divide bn), with the scratch ds (f32
// [T, jmax bn]) and pmax (f32, T jmax bn / 128 at least), then
// a8_split_finish_kernel; else one pass (ds and pmax unused).
extern "C" int chipmunk_csp_mlp_mm1_a8(const void* x8, const void* sx,
                                       const void* w1q, const void* w1s,
                                       const void* b1, const void* w2s,
                                       void* act_cache, const void* inds,
                                       const void* counts, void* d8, void* sd,
                                       void* ds, void* pmax, int T, int C,
                                       int N, int jmax, int bn, int bm, int w4,
                                       int act_bf16, void* stream) {
  const bool split = bn > 256;
  if (bn % 128 || (split && (ds == nullptr || pmax == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (w4 ? bm % 64 || T % bm || C % 256 : bm % GM || C % GK)
    return (int)cudaErrorInvalidValue;
  const int sub = bn % 256 ? 128 : 256;
  const int err = with_cache(act_bf16, [&](auto tag) {
    using CT = std::remove_pointer_t<decltype(tag)>;
    const bool t128 = bm % 128 == 0, two = sub == 256;
    auto launch =
        w4 ? (split ? (two ? (t128 ? launch_mm1_a8w4<2, 128, CT, true>
                                   : launch_mm1_a8w4<2, 64, CT, true>)
                           : (t128 ? launch_mm1_a8w4<1, 128, CT, true>
                                   : launch_mm1_a8w4<1, 64, CT, true>))
                    : (two ? (t128 ? launch_mm1_a8w4<2, 128, CT, false>
                                   : launch_mm1_a8w4<2, 64, CT, false>)
                           : (t128 ? launch_mm1_a8w4<1, 128, CT, false>
                                   : launch_mm1_a8w4<1, 64, CT, false>)))
           : (split ? (two ? launch_mm1_a8<256, CT, true>
                           : launch_mm1_a8<128, CT, true>)
                    : (two ? launch_mm1_a8<256, CT, false>
                           : launch_mm1_a8<128, CT, false>));
    return launch(x8, sx, w1q, w1s, b1, w2s, act_cache, inds, counts, d8, sd,
                  ds, pmax, T, C, N, jmax, bn, bm, (cudaStream_t)stream);
  });
  if (err != 0 || !split) return err;
  a8_split_finish_kernel<<<T, NT, 0, (cudaStream_t)stream>>>(
      (const float*)ds, (const float*)pmax, (const int*)counts, (int8_t*)d8,
      (float*)sd, jmax, bn, bn / sub, bm);
  return (int)cudaGetLastError();
}

// w2: w4 ? the int4 codes [N, C/2] (bm a multiple of 64, C of 256) :
// the K-major int8 codes [C, N] (bm a multiple of 128)
extern "C" int chipmunk_csp_mlp_mm2_a8(const void* d8, const void* sd,
                                       const void* w2, void* out_cache,
                                       const void* inds, const void* counts,
                                       int T, int C, int N, int jmax, int bn,
                                       int bm, int w4, int out_bf16,
                                       void* stream) {
  return with_cache(out_bf16, [&](auto tag) {
    using CT = std::remove_pointer_t<decltype(tag)>;
    if (w4) {
      using Op = Mm2A8W4<CT>;
      if (bm % Op::BN || T % bm || bn % GK || C % 256)
        return (int)cudaErrorInvalidValue;
      typename Op::Params p{};
      CUtensorMap ta, tb;
      int err = make_byte_map(&ta, w2, N, C / 2, 128);
      if (err == 0)
        err = make_byte_map(&tb, d8, T, (long long)jmax * bn, Op::BN);
      if (err == 0)
        err = make_byte_map(&p.out_map, out_cache, T, (long long)C * Op::ES,
                            Op::BN, Op::ES);
      if (err != 0) return err;
      p.sd = (const float*)sd;
      p.inds = (const int*)inds;
      p.counts = (const int*)counts;
      p.jmax = jmax;
      p.bn = bn;
      p.bm = bm;
      p.C = C;
      return launch_gemm<int8_t, Op>(ta, tb, p, dim3(T / Op::BN, C / 256),
                                     (cudaStream_t)stream);
    }
    using Op = Mm2A8<CT>;
    if (bm % GM || bn % GK || C % Op::BN) return (int)cudaErrorInvalidValue;
    CUtensorMap ta, tb;
    int err = make_byte_map(&ta, d8, T, (long long)jmax * bn, GM);
    if (err == 0) err = make_byte_map(&tb, w2, C, N, Op::BN);
    if (err != 0) return err;
    const typename Op::Params p{(const float*)sd, (CT*)out_cache,
                                (const int*)inds, (const int*)counts, C, jmax,
                                bn, bm};
    return launch_gemm<int8_t, Op>(ta, tb, p, dim3(T / GM, C / Op::BN),
                                   (cudaStream_t)stream);
  });
}
