// Tile machinery of the int8/bf16 probe (int8_probe.cu): mma.sync fed by
// ldmatrix from shared memory, 256 threads as 8 warps in 2 (rows) x 4
// (cols).
//
// bf16 tiles: 128 x 128 outputs, k tiles of 32, each warp a 64 x 32 patch.
// s8 tiles (the int8 probe): (32 MT) x (32 NTW) outputs, k tiles of 64
// bytes, each warp a (16 MT) x (8 NTW) patch.  A (k contiguous) is copied
// as it is; the [k][n] bytes of B have no ldmatrix.trans for bytes, so
// they are staged through registers and transposed in 4x4 byte blocks
// (prmt) into a [n][k] tile whose 16-byte chunks are XOR-swizzled: the
// ldmatrix reads of that tile are free of bank conflicts, the stores
// conflict at most 2-way.
#pragma once

#include "common.cuh"

namespace chipmunk {
namespace tile {

constexpr int NT = 256, STAGES = 3;

// ------------------------------------------------------------------ bf16
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8;    // [row][k] tiles: ldmatrix rows hit distinct banks
constexpr int LDB = BN + 8;    // [k][col] tiles

struct Stage2 {                // A rows [row][k], B rows [k][col]
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

// Each warp owns a 64 x 32 output patch.  A fragments come from a
// [row][k] tile; B fragments from a [col][k] tile (b_kmajor) or from a
// [k][col] tile through ldmatrix.trans.  With ``scale`` (16 bf16 pairs,
// one per two k of the tile) each A fragment is multiplied by the scale
// of its k in bf16 before the product.
template <bool b_kmajor>
__device__ __forceinline__ void mma_stage(float acc[4][4][4],
                                          const __nv_bfloat16* sa,
                                          const __nv_bfloat16* sb,
                                          const __nv_bfloat162* scale = nullptr) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldsm_x4(a[mt], sa + (wm * 64 + mt * 16 + (lane & 15)) * LDA + kk * 16 +
                         (lane >> 4) * 8);
    if (scale != nullptr) {    // reg0/1: k 2t, 2t+1; reg2/3: k 2t+8, 2t+9
      const __nv_bfloat162 s0 = scale[kk * 8 + (lane & 3)];
      const __nv_bfloat162 s1 = scale[kk * 8 + 4 + (lane & 3)];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&a[mt][r]);
          v = __hmul2(v, r < 2 ? s0 : s1);
          a[mt][r] = *reinterpret_cast<uint32_t*>(&v);
        }
    }
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

// Visit the C fragment of a bf16 tile: fn(mt, nt, h, row_in_tile,
// col_in_tile) for the element pair (acc[mt][nt][2h], acc[mt][nt][2h+1])
// at cols col, col+1.
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

// ------------------------------------------------------------------- s8
constexpr int BK8 = 64;          // bytes of k per tile
constexpr int LDA8 = BK8 + 16;   // padded [row][k] byte rows
constexpr int BN8 = 128;         // columns of a swizzled [n][k] B tile

template <int ROWS_A>
struct StageS8T {                // A [row][k] padded, B swizzled [n][k]
  uint8_t a[ROWS_A * LDA8];
  uint8_t b[BN8 * BK8];
};

// A [ROWS x 64 bytes] tile with k contiguous, 16-byte cp.async chunks
template <int ROWS>
__device__ __forceinline__ void issue_rows8(uint8_t* dst, const int8_t* src,
                                            size_t ld) {
#pragma unroll
  for (int u = 0; u < ROWS * 4 / NT; ++u) {
    const int id = threadIdx.x + NT * u, row = id >> 2, c = (id & 3) * 16;
    cp_async16(dst + row * LDA8 + c, src + row * ld + c, true);
  }
}

// byte offset of 16-byte chunk c (of 4) of row n in a swizzled tile
__device__ __forceinline__ int swz_off(int n, int c) {
  return n * BK8 + ((c ^ (((n >> 1) ^ (n >> 3)) & 3)) << 4);
}

// 4x4 byte transpose: r[i] holds row i (bytes = cols 0..3); o[j] gets
// column j (bytes = rows 0..3)
__device__ __forceinline__ void transpose4x4_b8(const uint32_t r[4],
                                                uint32_t o[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);  // r2.0 r3.0 r2.1 r3.1
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// The 512 (4 k x 4 n) byte blocks of a [64 k][128 n] tile, 2 a thread:
// block (kw, cq) covers k 4kw..4kw+3, n 4cq..4cq+3.  A warp takes 8
// consecutive cq and 4 consecutive kw: global rows read in 32-byte runs.
__device__ __forceinline__ void kn8_block(int u, int& kw, int& cq) {
  const int item = threadIdx.x + NT * u, lane = item & 31, wi = item >> 5;
  cq = (wi & 3) * 8 + (lane & 7);
  kw = (wi >> 2) * 4 + (lane >> 3);
}

// global [64 k][128 n] bytes (row stride ld) -> registers
__device__ __forceinline__ void load_kn8(uint32_t r[2][4], const int8_t* src,
                                         size_t ld) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    int kw, cq;
    kn8_block(u, kw, cq);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[u][i] = *reinterpret_cast<const uint32_t*>(
          src + (size_t)(4 * kw + i) * ld + 4 * cq);
  }
}

// registers -> swizzled [n][k] tile
__device__ __forceinline__ void store_kn8(const uint32_t r[2][4], uint8_t* sb) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    int kw, cq;
    kn8_block(u, kw, cq);
    uint32_t o[4];
    transpose4x4_b8(r[u], o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(sb + swz_off(4 * cq + i, kw >> 2) +
                                   (kw & 3) * 4) = o[i];
  }
}

// One 64-byte k tile of s8 products: warp patch (16 MT) x (8 NTW).  A from
// a padded [row][k] tile; B from a swizzled [n][k] tile.  Fragment
// addressing as in the bf16 mma_stage with one 16-byte chunk where bf16
// has 8 elements.
template <int MT, int NTW>
__device__ __forceinline__ void mma_stage_s8(int acc[MT][NTW][4],
                                             const uint8_t* sa,
                                             const uint8_t* sb) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK8 / 32; ++kk) {
    uint32_t a[MT][4], b[NTW][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(a[mt], sa + (wm * 16 * MT + mt * 16 + (lane & 15)) * LDA8 +
                         (2 * kk + (lane >> 4)) * 16);
#pragma unroll
    for (int np = 0; np < NTW / 2; ++np) {
      uint32_t r[4];
      const int n = wn * 8 * NTW + np * 16 + (mi >> 1) * 8 + (lane & 7);
      const int c = 2 * kk + (mi & 1);
      ldsm_x4(r, sb + swz_off(n, c));
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
        mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// Visit the C fragment of an s8 tile, as for_each_pair
template <int MT, int NTW, typename F>
__device__ __forceinline__ void for_each_pair_s8(F fn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        fn(mt, nt, h, wm * 16 * MT + mt * 16 + g + 8 * h,
           wn * 8 * NTW + nt * 8 + 2 * t);
}

// ------------------------------------------------------------- k loops
// The k loop over n_k tiles through a STAGES-deep cp.async ring:
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

// The k loop with B staged through registers (converted or transposed on
// the way), double-buffered: tile kt+1's A copies and B loads are in
// flight while tile kt is computed, then B kt+1 is stored.  after(kt)
// runs right after this thread's products of tile kt (on its registers).
template <typename Stage, typename IssueA, typename LoadB, typename StoreB,
          typename Compute, typename After>
__device__ __forceinline__ void k_loop_staged(Stage* buf, int n_k,
                                              IssueA issue_a, LoadB load_b,
                                              StoreB store_b,
                                              Compute compute, After after) {
  if (n_k <= 0) return;
  issue_a(0, buf[0]);
  cp_async_commit();
  load_b(0);
  store_b(buf[0]);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<0>();
    __syncthreads();   // tile kt in place; nobody reads buffer (kt+1)&1
    const bool more = kt + 1 < n_k;
    if (more) {
      issue_a(kt + 1, buf[(kt + 1) & 1]);
      cp_async_commit();
      load_b(kt + 1);
    }
    compute(buf[kt & 1]);
    if (more) store_b(buf[(kt + 1) & 1]);
    after(kt);
  }
}

}  // namespace tile
}  // namespace chipmunk
