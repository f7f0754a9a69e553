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
// Design (attn_sm90.cuh has the building blocks).  One CTA covers 128
// query rows of one (batch, head) in three warpgroups:
//   - warpgroup 0, the producer, drops to 24 registers (setmaxnreg); one
//     thread issues the TMA loads: Q once, then K and V tiles of 128 keys
//     through a ring of stages (three for dense_attn, two for the
//     column-sum variant), each stage with its own "full" mbarrier
//     for K and for V (Q K^T starts while V still lands) and an "empty"
//     mbarrier on which every consumer thread arrives when done with it.
//     The 3-D tensor maps (d, S, B H) take the head stride as their outer
//     stride, so keys cut at a valid length or the query rows of a dense
//     tail are read as views; rows past Sq and keys past Sk come in as
//     zeros, and keys past Sk are also masked with -1e30 in the scores.
//   - each consumer warpgroup (240 registers) owns 64 rows: S = Q K^T by
//     wgmma.m64n128k16 from shared memory, the online softmax in base 2
//     with tau folded into the exp2 argument (one FFMA a score) and the
//     exp2 on ex2.approx.ftz (exp2f wraps the same instruction in a
//     denormal-safe scaling that the softmax does not need), P packed
//     to bf16 in registers (as the TPU kernel casts p to V's dtype) and
//     used as the register A operand of O += P V, V the transposed
//     shared-memory B operand: P never touches shared memory.  In a key
//     step a warpgroup issues S(i) and P V(i - 1) together, waits for S,
//     computes the exponentials while P V runs, then waits for it,
//     rescales O and packs P.  The two warpgroups take turns issuing
//     ("ping-pong", two named barriers), so one's softmax runs under the
//     other's products.  The epilogue writes O / l as bf16 (l == 0
//     guarded to 1) and lse = m + log2 l straight from registers.
// Registers: 24 + 2 x 240 per 128 threads = 64,512 of 65,536 (the launch
// bound of 384 threads gives 168 each at entry; ptxas reports no spills).
// Shared memory: Q 32 KB + 3 stages x (K 32 KB + V 32 KB) = 224 KB, plus
// 1 KB for alignment and the barriers, of the 227 KB a block may have (a
// third stage measured faster than two at every shape of the path).  The
// grid runs query tiles fastest, so the CTAs resident at one time share a
// head and its K/V stays in the 50 MB L2 (a head's K+V at 540p is 34.6
// MB).  The video path's 384-row dense tail is 72 such CTAs over 24
// heads, on 132 SMs; a 64-row form of the same template (one consumer,
// 144 CTAs, a second partial wave) measured slower there.
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

constexpr int BM = 128;                          // query rows per CTA
constexpr int TILE = KT * HD * 2;                // bytes of a K or V tile
constexpr int SMEM_MAX = 232448;                 // opt-in limit per block
constexpr int BAR_BYTES = 256;
constexpr int HAND_BYTES = 2 * 8 * 2 * 32 * 4;    // colsum hand-off ring

template <int ST>
constexpr int ring_bytes() {
  return 1024 + BM * HD * 2 + 2 * ST * TILE + BAR_BYTES;
}

struct Params {
  __nv_bfloat16* o;
  float* lse;
  const float* prev_lse;   // colsum only
  float* cs;               // colsum only
  int Sq, Sk, score_block, nb;
  float tau;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int ST, bool CS>
__global__ void __launch_bounds__(384, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int Q_BOX = BM * BOX_ROW;            // bytes of one Q box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t sk = sq + 2 * Q_BOX, sv = sk + ST * TILE;
  const uint32_t sbar = sv + ST * TILE;
  // barriers: q_full, k_full[ST], v_full[ST], empty[ST]
  auto k_full = [&](int s) { return sbar + 8 * (1 + s); };
  auto v_full = [&](int s) { return sbar + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return sbar + 8 * (1 + 2 * ST + s); };
  // colsum: the hand-off ring [2][8 warps][2 halves][32 lanes] and the
  // group's row of column sums [nb]; cs_full/cs_empty per hand-off slot
  auto cs_full = [&](int r) { return sbar + 8 * (1 + 3 * ST + r); };
  auto cs_empty = [&](int r) { return sbar + 8 * (3 + 3 * ST + r); };
  float* hand = reinterpret_cast<float*>(smem_raw + (sbar - raw) + BAR_BYTES);
  float* sums = hand + HAND_BYTES / 4;

  const int n = (p.Sk + KT - 1) / KT;
  const int bh = blockIdx.y, row0 = blockIdx.x * BM;
  if (threadIdx.x == 0) {
    mbar_init(sbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 256);
    }
    for (int r = 0; r < 2; ++r) {
      mbar_init(cs_full(r), 256);
      mbar_init(cs_empty(r), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(sbar, 2 * Q_BOX);
      tma_load_tile(sq, &tq, sbar, row0, bh, Q_BOX);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
        mbar_expect_tx(k_full(s), TILE);
        tma_load_tile(sk + s * TILE, &tk, k_full(s), i * KT, bh,
                      KT * BOX_ROW);
        mbar_expect_tx(v_full(s), TILE);
        tma_load_tile(sv + s * TILE, &tv, v_full(s), i * KT, bh,
                      KT * BOX_ROW);
      }
    } else if (CS && threadIdx.x / 32 == 1) {
      // The column-sum reducer: for each key tile, the 8 consumer warps'
      // per-lane partials of both 64-key halves, summed in a fixed order
      // (lane by lane across the warps, then across the lanes), into the
      // group's row; only this warp touches the row, then writes it out.
      const int lane = threadIdx.x & 31;
      for (int b = lane; b < p.nb; b += 32) sums[b] = 0.f;
      __syncwarp();
      for (int i = 0; i < n; ++i) {
        const int r = i & 1;
        mbar_wait(cs_full(r), (i >> 1) & 1);
        const float* h = hand + r * 512;
        float v0 = 0.f, v1 = 0.f;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          v0 += h[w * 64 + lane];
          v1 += h[w * 64 + 32 + lane];
        }
        v0 = warp_sum(v0);
        v1 = warp_sum(v1);
        if (lane == 0) {
          mbar_arrive(cs_empty(r));
          // a score block is a multiple of 64 keys: the second half lies
          // in the first half's block or the next
          const int key0 = i * KT, b0 = key0 / p.score_block;
          if (key0 + KT / 2 >= p.Sk ||
              (key0 + KT / 2) / p.score_block == b0) {
            sums[b0] += v0 + v1;
          } else {
            sums[b0] += v0;
            sums[b0 + 1] += v1;
          }
        }
      }
      __syncwarp();
      float* cs_row = p.cs + ((size_t)bh * gridDim.x + blockIdx.x) * p.nb;
      for (int b = lane; b < p.nb; b += 32) cs_row[b] = sums[b];
    }
  } else {
    // ------------------------------------------------------- consumers
    reg_alloc<240>();
    const int c = wg - 1;
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = row0 + 64 * c + 16 * warp + g;   // rows r0 and r0 + 8
    const float tau = p.tau;
    float o[64], s[64];
    uint32_t pf[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f, al0 = 1.f, al1 = 1.f;

    float pl0 = 0.f, pl1 = 0.f, cp0 = 0.f, cp1 = 0.f;
    if (CS) {
      pl0 = p.prev_lse[(size_t)bh * p.Sq + r0];
      pl1 = p.prev_lse[(size_t)bh * p.Sq + r0 + 8];
    }

    // Turns of the two consumers: each waits on its own named barrier
    // (1 + c) and, having issued, lets the other go; consumer 0 starts.
    // Consumer 1 skips its last pass, so every barrier phase completes.
    auto my_turn = [&]() { bar_sync(1 + c, 256); };
    auto pass_turn = [&](bool last) {
      if (!(c == 1 && last)) bar_arrive(2 - c, 256);
    };
    if (c == 1) bar_arrive(1, 256);

    // Exponentials of key tile i into s (f32), row sums into l, and the
    // column-sum partials; the O rescale and the bf16 packing follow once
    // the previous P V has finished.
    auto softmax = [&](int i) {
      const int key0 = i * KT;
      if (key0 + KT > p.Sk) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * j + 2 * t + (e & 1) >= p.Sk) s[4 * j + e] = NEG_INF;
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0) * tau);
      const float mn1 = fmaxf(m1, quad_max(mx1) * tau);
      al0 = ex2(m0 - mn0);
      al1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs00 = 0.f, rs01 = 0.f, rs10 = 0.f, rs11 = 0.f;   // [row][half]
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], tau, -mn0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], tau, -mn0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], tau, -mn1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], tau, -mn1));
        if (j < 8) {
          rs00 += s[4 * j] + s[4 * j + 1];
          rs10 += s[4 * j + 2] + s[4 * j + 3];
        } else {
          rs01 += s[4 * j] + s[4 * j + 1];
          rs11 += s[4 * j + 2] + s[4 * j + 3];
        }
      }
      l0 = l0 * al0 + (rs00 + rs01);
      l1 = l1 * al1 + (rs10 + rs11);
      if (CS) {
        const float f0 = ex2(mn0 - pl0), f1 = ex2(mn1 - pl1);
        cp0 = rs00 * f0 + rs10 * f1;
        cp1 = rs01 * f0 + rs11 * f1;
      }
    };
    // hand tile i's column-sum partials of both halves to the reducer
    auto colsum_hand = [&](int i) {
      if (!CS) return;
      const int r = i & 1;
      if (i >= 2) mbar_wait(cs_empty(r), ((i >> 1) - 1) & 1);
      float* h = hand + r * 512 + (4 * c + warp) * 64;
      h[lane] = cp0;
      h[32 + lane] = cp1;
      mbar_arrive(cs_full(r));
    };
    auto rescale_pack = [&]() {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= al0;
        o[4 * j + 1] *= al0;
        o[4 * j + 2] *= al1;
        o[4 * j + 3] *= al1;
      }
      // A fragment of key step kk: words (g, 2t), (g+8, 2t), (g, 2t+8),
      // (g+8, 2t+8) = chunks 2kk and 2kk+1 of the S accumulator
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pf[4 * kk] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pf[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pf[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pf[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };

    const uint32_t qa = sq + c * 64 * BOX_ROW;
    mbar_wait(sbar, 0);
    // key step 0: S(0) alone
    my_turn();
    mbar_wait(k_full(0), 0);
    wgmma_fence();
    issue_qk(s, qa, Q_BOX, sk);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<0>();
    fence_acc(s);
    softmax(0);
    rescale_pack();
    colsum_hand(0);
    // key step i: S(i) with P V(i - 1)
    for (int i = 1; i < n; ++i) {
      const int ps = (i - 1) % ST, st = i % ST;
      my_turn();
      mbar_wait(k_full(st), (i / ST) & 1);
      mbar_wait(v_full(ps), ((i - 1) / ST) & 1);
      wgmma_fence();
      issue_qk(s, qa, Q_BOX, sk + st * TILE);
      wgmma_commit();
      issue_pv(o, pf, sv + ps * TILE);
      wgmma_commit();
      pass_turn(false);
      wgmma_wait<1>();
      fence_acc(s);
      softmax(i);
      wgmma_wait<0>();
      fence_acc(o);
      mbar_arrive(empty(ps));
      rescale_pack();
      colsum_hand(i);
    }
    // last: P V(n - 1)
    my_turn();
    mbar_wait(v_full((n - 1) % ST), ((n - 1) / ST) & 1);
    wgmma_fence();
    issue_pv(o, pf, sv + ((n - 1) % ST) * TILE);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    fence_acc(o);

    // epilogue: O / l as bf16, lse = m + log2 l; rows past Sq not written
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      float l = quad_sum(h ? l1 : l0);
      l = l == 0.f ? 1.f : l;
      if (r < p.Sq) {
        __nv_bfloat16* orow = p.o + ((size_t)bh * p.Sq + r) * HD;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
              pack_bf16(o[4 * j + 2 * h] / l, o[4 * j + 2 * h + 1] / l);
        if (t == 0) p.lse[(size_t)bh * p.Sq + r] = (h ? m1 : m0) + log2f(l);
      }
    }
  }
}

template <int ST, bool CS>
int launch(const void* q, const void* k, const void* v, const Params& p,
           int BH, int q_hs, int kv_hs, cudaStream_t stream) {
  const int smem = ring_bytes<ST>() + (CS ? HAND_BYTES + 4 * p.nb : 0);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static const int attr = (int)cudaFuncSetAttribute(
      flash_sm90_kernel<ST, CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_MAX);
  if (attr != 0) return attr;
  CUtensorMap tq, tk, tv;
  int err = make_head_map(&tq, q, BH, p.Sq, q_hs, BM);
  if (err == 0) err = make_head_map(&tk, k, BH, p.Sk, kv_hs, KT);
  if (err == 0) err = make_head_map(&tv, v, BH, p.Sk, kv_hs, KT);
  if (err != 0) return err;
  dim3 grid((p.Sq + BM - 1) / BM, BH);
  flash_sm90_kernel<ST, CS><<<grid, 384, smem, stream>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
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
