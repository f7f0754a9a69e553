// Column-sparse attention: each 128-row query group attends, with an exact
// softmax in log2 domain, only over the counts[g] kv_block-key blocks
// listed in inds[g].  One kernel, two places where a block's keys lie.
//
// Replaces (TPU reference, Pallas):
//   csp_attn (mode 'vmem') <- chipmunk_tpu/kernels/csp_attention.py:102
//                             (_csp_vmem_kernel): K and V read in place
//   csp_attn_hbm           <- chipmunk_tpu/kernels/csp_attention.py:193
//                             (_csp_hbm_packed_kernel): K and V packed per
//                             block, [B*H, nb, 2*kv_block, D]
//
// Bound on the H100: operations, 4 * 128 * kv_block * D FLOP per selected
// (group, block) -- 8.4 MFLOP at kv_block 128 -- at 989 TFLOP/s.  At the
// HunyuanVideo 540p shape (24 heads x 528 groups, ~34 selected blocks per
// group) a call is ~3.6 TFLOP, ~3.6 ms, while q, o and the K/V blocks some
// group selects are ~1.7 GB read or written once, ~0.5 ms at 3.35 TB/s.
// At FLUX (24 heads x 34 groups, 1-6 blocks each) the ~24 GFLOP take
// ~0.024 ms and the ~100 MB of q, o and K/V ~0.031 ms, so bytes bound
// there.  The gather re-reads each block once per group that selects it
// (64 KB of K+V for 8.4 MFLOP, 128 FLOP/byte), so it must come from L2 for
// the tensor cores to set the pace: a head's K+V is 34.6 MB at 540p and
// fits the 50 MB L2; at 720p it is 61 MB and part of the gather comes
// from device memory.
//
// Design: attn_sm90_kernel (attn_sm90.cuh) -- TMA, mbarriers, a producer
// warpgroup and two consumer warpgroups that take turns at wgmma, the
// softmax of one tile under the other's products -- with the key source
// CspKeys below.  The TPU kernels gather a group's jmax blocks into one
// VMEM scratch for an exact softmax over the whole row; a group's gather
// at 540p (jmax 44) is 2.8 MB, far beyond a block's 227 KB here, so one
// CTA owns one (query group, b h), reads its own count and index row, and
// streams the selected blocks through the ring with an online softmax.
// Tile i holds positions 128 i .. 128 i + 127 of the group's gathered
// keys (the concatenation of its count selected blocks, count clamped to
// [1, jmax]), loaded as 128 / RB boxes of RB = gcd(kv_block, 128) rows:
// kv_block 128 is one block per tile, a multiple of 128 several tiles per
// block, 64, 32, 16 and 8 two to sixteen blocks per tile (an 8-row box of
// 64 bf16 columns is 1024 bytes, one 128-byte swizzle atom).  In place,
// block b's rows start at row b * kv_block of the (d, Sk, B H) maps of K
// and V over their head-strided views; packed, at row b * 2 * kv_block of
// one (d, nb * 2 * kv_block, B H) map over kv, its V rows kv_block further
// on.  kv_block 1, 2 and 4 would need boxes below the atom: for them the
// packed layout gives each block a 16-row slot (pack_kv: K in rows 0 ..
// kv_block - 1, V in rows 8 .. 8 + kv_block - 1, zeros elsewhere), and
// CspKeys<8, true> loads one 8-row box per selected block, of which the
// first kv_block rows are valid: 16 blocks a tile (both modes; the
// wrapper packs for 'vmem' too).  Positions past counts[g] are never
// visited.  With each tile the producer leaves, beside the barriers, the
// number of valid leading rows of each box: 0 past the count, fewer
// than RB where the box crosses kv_valid (keys lie in ascending order
// inside a box, so the valid ones lead, as in the reference's
// _partial_block_mask); the consumers mask the rest to -inf.
// The ragged last tile: its slots past count * kv_block are filled with
// the group's last valid box (as pad_block_indices pads with the last
// valid block) and masked by position, so every row of every stage is
// written by TMA before it is read -- no stale shared memory, no 0 * NaN
// in P V -- and no block that the group did not select is read.
// Registers: 24 + 2 x 240, as for the dense kernels.  Shared memory: Q 32
// KB + 3 stages x (K 32 KB + V 32 KB) + 1 KB alignment + 512 bytes of
// barriers and records = 230,912 of the 232,448 bytes a block may have.
// The grid runs groups fastest, so the CTAs resident at one time share a
// head and its blocks stay in L2.  The output is fresh (the module adds
// the delta cache); no lse is written.
// Query groups of qg rows other than 128 (any divisor of Sq) take
// Grouped<CspKeys<...>>: ceil(qg / 128) CTAs a group, each reading the
// group's index row; rows past the group's end are computed against its
// blocks and not stored.  qg = 128 keeps CspKeys alone, the code of the
// main paths.
#include <type_traits>

#include "attn_sm90.cuh"

using namespace chipmunk;
using namespace chipmunk::sm90;

namespace chipmunk {
namespace sm90 {

// A group's selected blocks, in boxes of RB rows (RB divides kv_block and
// 128).  Record of a stage: valid leading rows per box, then a flag that
// some box has fewer than RB.  SLOT: each block fills one box whatever
// its size (kv_block 1, 2 or 4 in 8-row slots), its first kv_block rows
// valid; positions then count box rows, RB per block.
template <int RB, bool SLOT = false>
struct CspKeys {
  static constexpr bool GROUPED = false;
  static constexpr int CS_P = 0;
  static constexpr int BOXES = KT / RB;
  static_assert(BOXES < REC_INTS, "record");
  static_assert(!SLOT || RB == 8, "slots of one atom");
  const int* row;      // the group's index row
  int n_pos;           // count * kv_block (SLOT: count * RB)
  int kv_block, kv_valid, kstride, voff;

  __device__ CspKeys(const Params& p, int bh, int grp)
      : kv_block(p.kv_block), kv_valid(p.kv_valid), kstride(p.kstride),
        voff(p.voff) {
    const size_t gi = (size_t)bh * gridDim.x + grp;
    row = p.inds + gi * p.jmax;
    n_pos = min(max(p.counts[gi], 1), p.jmax) * (SLOT ? RB : kv_block);
  }

  // group gi of all B H G groups
  __device__ CspKeys(const Params& p, size_t gi)
      : kv_block(p.kv_block), kv_valid(p.kv_valid), kstride(p.kstride),
        voff(p.voff) {
    row = p.inds + gi * p.jmax;
    n_pos = min(max(p.counts[gi], 1), p.jmax) * (SLOT ? RB : kv_block);
  }

  __device__ int tiles() const { return (n_pos + KT - 1) / KT; }

  // Box b of tile i: its first map row, and in lim its valid leading
  // rows.  Recomputed in each loop of load, and the loops are not
  // unrolled: 16 boxes' rows and index loads at once would not fit the
  // producer's 24 registers.
  __device__ int box(int i, int b, int& lim) const {
    const int span = SLOT ? RB : kv_block;  // positions per block
    int pos = i * KT + b * RB;
    const bool live = pos < n_pos;
    if (!live) pos = n_pos - RB;           // the last valid box
    const int blk = row[pos / span], off = pos % span;
    lim = live ? min(max(kv_valid - (blk * kv_block + off), 0),
                     SLOT ? kv_block : RB)
               : 0;
    return blk * kstride + off;
  }

  __device__ void load(const CUtensorMap* tk, const CUtensorMap* tv,
                       uint32_t sk, uint32_t sv, uint32_t k_full,
                       uint32_t v_full, int* rec, int i, int bh) const {
    int partial = 0, lim;
#pragma unroll 1
    for (int b = 0; b < BOXES; ++b) {
      box(i, b, lim);
      rec[b] = lim;
      partial |= lim < RB;
    }
    rec[BOXES] = partial;
    mbar_expect_tx(k_full, TILE);
#pragma unroll 1
    for (int b = 0; b < BOXES; ++b)
      tma_load_tile(sk + b * RB * BOX_ROW, tk, k_full, box(i, b, lim), bh,
                    KT * BOX_ROW);
    mbar_expect_tx(v_full, TILE);
#pragma unroll 1
    for (int b = 0; b < BOXES; ++b)
      tma_load_tile(sv + b * RB * BOX_ROW, tv, v_full,
                    box(i, b, lim) + voff, bh, KT * BOX_ROW);
  }

  // Columns 8 j .. 8 j + 7 lie in box 8 j / RB (RB is a multiple of 8).
  __device__ void mask(const int* rec, int, float (&s)[64], int t) const {
    if (!rec[BOXES]) return;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int lim = rec[8 * j / RB], off = 8 * j % RB + 2 * t;
      if (off >= lim) s[4 * j] = s[4 * j + 2] = neg_inf();
      if (off + 1 >= lim) s[4 * j + 1] = s[4 * j + 3] = neg_inf();
    }
  }
};

// Groups of p.qg rows, p.cpg CTAs each (attn_sm90.cuh: GROUPED).
template <class K>
struct Grouped : K {
  static constexpr bool GROUPED = true;
  __device__ Grouped(const Params& p, int bh, int grp)
      : K(p, (size_t)bh * (p.Sq / p.qg) + grp) {}
};

}  // namespace sm90
}  // namespace chipmunk

namespace {

constexpr int ST = 3;   // ring stages

// k and v: maps of k_rows rows per head, kv_hs elements apart.
// Grid: groups of 128 rows, or (GR) Sq / qg groups of cpg CTAs.
template <int RB, bool SLOT, bool GR>
int launch(const void* q, const void* k, const void* v, int k_rows,
           const Params& p, int BH, int q_hs, long long kv_hs,
           cudaStream_t stream) {
  using Keys = std::conditional_t<GR, Grouped<CspKeys<RB, SLOT>>,
                                  CspKeys<RB, SLOT>>;
  CUtensorMap tq, tk, tv;
  int err = make_head_map(&tq, q, BH, p.Sq, q_hs, BM);
  if (err == 0) err = make_head_map(&tk, k, BH, k_rows, kv_hs, RB);
  if (err == 0) err = make_head_map(&tv, v, BH, k_rows, kv_hs, RB);
  if (err != 0) return err;
  return launch_attn<ST, false, Keys>(
      tq, tk, tv, p, GR ? p.Sq / p.qg * p.cpg : p.Sq / BM, BH,
      ring_bytes<ST>(), stream);
}

template <bool GR>
int dispatch_rb(const void* q, const void* k, const void* v, int k_rows,
                const Params& p, int BH, int q_hs, long long kv_hs,
                cudaStream_t stream) {
  if (p.kv_block < 8)                      // 8-row slots (packed only)
    return launch<8, true, GR>(q, k, v, k_rows, p, BH, q_hs, kv_hs, stream);
  if (p.kv_block % 128 == 0)
    return launch<128, false, GR>(q, k, v, k_rows, p, BH, q_hs, kv_hs,
                                  stream);
  if (p.kv_block % 64 == 0)
    return launch<64, false, GR>(q, k, v, k_rows, p, BH, q_hs, kv_hs,
                                 stream);
  if (p.kv_block == 32)
    return launch<32, false, GR>(q, k, v, k_rows, p, BH, q_hs, kv_hs,
                                 stream);
  if (p.kv_block == 16)
    return launch<16, false, GR>(q, k, v, k_rows, p, BH, q_hs, kv_hs,
                                 stream);
  if (p.kv_block == 8)
    return launch<8, false, GR>(q, k, v, k_rows, p, BH, q_hs, kv_hs, stream);
  return (int)cudaErrorInvalidValue;
}

int dispatch(const void* q, const void* k, const void* v, int k_rows,
             Params p, int BH, int q_hs, long long kv_hs,
             cudaStream_t stream) {
  if (p.Sq < 1 || p.qg < 1 || p.Sq % p.qg || p.jmax < 1 || p.kv_valid < 0)
    return (int)cudaErrorInvalidValue;
  if (p.qg == BM)
    return dispatch_rb<false>(q, k, v, k_rows, p, BH, q_hs, kv_hs, stream);
  p.cpg = (p.qg + BM - 1) / BM;
  return dispatch_rb<true>(q, k, v, k_rows, p, BH, q_hs, kv_hs, stream);
}

Params csp_params(void* o, const void* inds, const void* counts, int Sq,
                  int Sk, int qg, int jmax, int kv_block, int kv_valid,
                  float tau) {
  Params p{};
  p.qg = qg;
  p.o = (__nv_bfloat16*)o;
  p.Sq = Sq;
  p.Sk = Sk;
  p.tau = tau;
  p.inds = (const int*)inds;
  p.counts = (const int*)counts;
  p.jmax = jmax;
  p.kv_block = kv_block;
  p.kv_valid = kv_valid;
  return p;
}

}  // namespace

// In place: q [BH][Sq][128] and k, v [BH][Sk][128], rows contiguous, heads
// q_hs and kv_hs elements apart; Sk a multiple of kv_block; inds and
// counts of Sq / qg groups.
extern "C" int chipmunk_csp_attn(const void* q, const void* k, const void* v,
                                 const void* inds, const void* counts, void* o,
                                 int BH, int Sq, int Sk, int q_hs, int kv_hs,
                                 int qg, int jmax, int kv_block, int kv_valid,
                                 float tau, void* stream) {
  if (kv_block < 8 || Sk % kv_block) return (int)cudaErrorInvalidValue;
  Params p = csp_params(o, inds, counts, Sq, Sk, qg, jmax, kv_block, kv_valid,
                        tau);
  p.kstride = kv_block;
  p.voff = 0;
  return dispatch(q, k, v, Sk, p, BH, q_hs, kv_hs, (cudaStream_t)stream);
}

// Packed: q [BH][Sq][128] contiguous, kv [BH][nb][2 kv_block][128], or
// for kv_block 1, 2 and 4 [BH][nb][16][128] (K rows 0.., V rows 8..).
extern "C" int chipmunk_csp_hbm_attn(const void* q, const void* kv,
                                     const void* inds, const void* counts,
                                     void* o, int BH, int Sq, int nb, int qg,
                                     int jmax, int kv_block, int kv_valid,
                                     float tau, void* stream) {
  if (kv_block < 1 || kv_block > 128 || 128 % kv_block)
    return (int)cudaErrorInvalidValue;
  const int slot = kv_block < 8 ? 8 : kv_block;   // rows of K, then of V
  const int rows = nb * 2 * slot;
  Params p = csp_params(o, inds, counts, Sq, nb * kv_block, qg, jmax,
                        kv_block, kv_valid, tau);
  p.kstride = 2 * slot;
  p.voff = slot;
  return dispatch(q, kv, kv, rows, p, BH, Sq * HD, (long long)rows * HD,
                  (cudaStream_t)stream);
}
