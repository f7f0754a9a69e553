// Hopper attention kernels: TMA tensor maps and loads, mbarriers, named
// barriers, register reallocation, the two warpgroup products of a
// 64 x 128 x 128 attention step, and the one kernel template that every
// attention kernel of the port instantiates (attn_sm90_kernel, below):
// dense_attn and dense_colsum_attn (flash_attention.cu, keys in order)
// and both column-sparse kernels (csp_attention.cu, keys gathered by
// block index).  Head dim 128, bf16 operands, f32 accumulators.
//
// Shared-memory tiles are laid out as TMA writes them with 128-byte
// swizzle: a [rows][128] bf16 tile is two boxes of [rows][64] (128-byte
// rows), d 0-63 then d 64-127; inside a box the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8), in atoms of 8 rows (1024 bytes).  Every tile
// starts on a 1024-byte boundary, so the wgmma descriptors take a base
// offset of 0 and the hardware undoes the swizzle from the address bits.
// A tile may also be filled by several boxes of fewer rows (8 to 64,
// multiples of the 8-row atom): each lands at its own 1024-byte-aligned
// offset, so the layout is the same.  A box of fewer than 8 rows would be
// smaller than the atom and is not used.
//
//   S = Q K^T   wgmma.m64n128k16, A (Q) and B (K) from shared memory, both
//               K-major (d contiguous): SBO 1024 bytes (8 rows), LBO unused;
//               k-step kk reads box kk / 4 at byte offset 32 (kk % 4).
//   O += P V    A = P from registers (the S accumulator's layout is the A
//               fragment's), B = V from shared memory MN-major (d
//               contiguous, keys along K) with the transpose flag: LBO =
//               the stride between the two 64-wide d boxes, SBO 1024 bytes
//               (8 keys); k-step kk starts 16 keys (2048 bytes) further.
//
// Accumulator of m64nNk16 in a warpgroup (warp w, lane = 4 g + t): d[4j +
// e] holds row 16 w + g + 8 (e / 2), column 8 j + 2 t + (e % 2) -- per
// 8-column chunk the C fragment of the warp-level m16n8k16 product.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace chipmunk {
namespace sm90 {

constexpr int HD = 128;          // head dim
constexpr int KT = 128;          // keys per tile
constexpr int BOX_ROW = 128;     // bytes per row of a 64-wide box

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Allow a kernel dynamic shared memory above the 48 KB default; returns
// the cudaError_t of the attribute call.
template <typename K>
inline int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------- TMA
// A 3-D map over a [BH][S][128] bf16 tensor whose rows are contiguous and
// whose heads lie head_stride elements apart; box [1][rows][64], 128-byte
// swizzle.  Rows at or past S read as zeros.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a CUDA driver API call, looked up once through
// the runtime (no link against libcuda); nullptr where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// 0 on success, else a cudaError_t to return to the caller.
inline int make_head_map(CUtensorMap* map, const void* base, int BH, int S,
                         long long head_stride, int box_rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)head_stride * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                   const_cast<void*>(base), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Box (d0, row, head) of the map into shared memory at dst; completion
// is counted in bytes on the mbarrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0),
         "r"(row), "r"(head)
      : "memory");
}

// Both 64-wide boxes of a [rows][128] tile (box_bytes apart).
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int row, int head,
                                              int box_bytes) {
  tma_load(dst, map, bar, 0, row, head);
  tma_load(dst + box_bytes, map, bar, 64, row, head);
}

// ----------------------------------------------------------- mbarriers
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ------------------------------------------- named barriers, registers
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// 2^x on the multi-function unit: ex2.approx.ftz, ~2 ulp; results below
// 2^-126 flush to 0 (exp2f adds a denormal-safe scaling around the same
// instruction).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin an accumulator in place around the asynchronous products, so the
// compiler neither reads it before wgmma_wait nor moves writes past an
// issue.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define CHIPMUNK_ACC64                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),   \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),            \
  "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),            \
  "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),            \
  "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),            \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),            \
  "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),            \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),            \
  "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),            \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),            \
  "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),            \
  "+f"(d[62]), "+f"(d[63])

#define CHIPMUNK_D64                                                          \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,"   \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,"  \
  "%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,"  \
  "%56,%57,%58,%59,%60,%61,%62,%63}"

// d (+)= A B, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " CHIPMUNK_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : CHIPMUNK_ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64 x 16 bf16) from registers, B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[64], const uint32_t a[4],
                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " CHIPMUNK_D64
      ", {%64,%65,%66,%67}, %68, 1, 1, 1, 1;\n"
      : CHIPMUNK_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

#undef CHIPMUNK_ACC64
#undef CHIPMUNK_D64

// S (+)= Q K^T over d = 128: eight k-steps.  q: this warpgroup's 64 rows
// of box 0 (box 1 lies q_box bytes further); k: a key tile (box 1 at
// KT * BOX_ROW bytes).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q,
                                         int q_box, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(s,
             gmma_desc(q + (kk / 4) * q_box + off, 16, 1024),
             gmma_desc(k + (kk / 4) * (KT * BOX_ROW) + off, 16, 1024),
             kk > 0);
  }
}

// O += P V over the tile's 128 keys: eight k-steps of 16 keys; p holds
// the bf16 P fragments, four words per step.
__device__ __forceinline__ void issue_pv(float (&o)[64], const uint32_t (&p)[32],
                                         uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_rs_t(o, &p[4 * kk],
               gmma_desc(v + kk * 16 * BOX_ROW, KT * BOX_ROW, 1024));
}

// ------------------------------------------------------ the kernel
// One CTA covers 128 query rows of one (batch, head) in three warpgroups:
//   - warpgroup 0, the producer, drops to 24 registers (setmaxnreg); one
//     thread issues the TMA loads: Q once, then the K and V tiles of 128
//     keys that the key source names, through a ring of ST stages, each
//     with its own "full" mbarrier for K and for V (Q K^T starts while V
//     still lands) and an "empty" mbarrier on which every consumer thread
//     arrives when done with it.
//   - each consumer warpgroup (240 registers) owns 64 rows: S = Q K^T by
//     wgmma.m64n128k16 from shared memory, the key source's mask, the
//     online softmax in base 2 with tau folded into the exp2 argument (one
//     FFMA a score) on ex2.approx.ftz, P packed to bf16 in registers (as
//     the TPU kernels cast p to V's dtype) and used as the register A
//     operand of O += P V: P never touches shared memory.  In a key step a
//     warpgroup issues S(i) and P V(i - 1) together, waits for S, computes
//     the exponentials while P V runs, then waits for it, rescales O and
//     packs P.  The two warpgroups take turns issuing ("ping-pong", two
//     named barriers), so one's softmax runs under the other's products.
//     The epilogue writes O / l as bf16 (l == 0 guarded to 1, so a row
//     with no unmasked key gives 0) and, where asked, lse = m + log2 l.
// Masked scores are -inf in registers: they add exactly 0 to l and O even
// in a row whose keys so far were all masked (a finite -1e30 would give
// p = 1 there, 2^(-1e30 tau + 1e30 tau)).
// Registers: 24 + 2 x 240 per 128 threads = 64,512 of 65,536 (the launch
// bound of 384 threads gives 168 each at entry).  Shared memory: Q 32 KB
// + ST x (K 32 KB + V 32 KB), 1 KB for alignment, 512 bytes for the
// barriers and the key source's per-stage records, and for the column
// sums their hand-off ring and row.
//
// A key source (Keys) is built by every thread from (p, bh, group) and
// gives: tiles(), the CTA's number of 128-key tiles; load(...), run by the
// producer thread, which arms the stage's two mbarriers and issues the
// TMA loads of tile i (it may leave up to 24 ints per stage in rec, which
// the consumers read after the K barrier); mask(rec, i, s, t), which sets
// the masked scores of tile i in a consumer thread's accumulator to -inf.
// It also names GROUPED and CS_P.  GROUPED false: a CTA is one 128-row
// query group (group blockIdx.x, rows blockIdx.x * 128 ..).  GROUPED true:
// groups of p.qg rows (any qg that divides Sq), p.cpg = ceil(qg / 128)
// CTAs a group, each of 128 rows from its group's row grp * qg + 128 k;
// rows at or past the group's end are computed against the group's keys
// but neither stored nor summed (their column-sum factor is 0, their
// prev_lse is not read).  CS_P: the column-sum form (below).
//
// Column sums.  CS_P 0 (score blocks of 64 keys or more): per 64-key half
// tile each consumer thread hands over one partial, its two rows' sums
// times their factors; one reducer warp sums the 8 warps' partials and
// the lanes, and adds them into shared-memory slots of the CTA's row of
// nb sums.  CS_P 4, 8, 16, 32 (score blocks of 32, 16, 2-8 and 1 key): a
// thread's 32 columns of a tile, 8 j + 2 t + {0, 1} for j = 0..15, fall
// in CS_P blocks of its own (4 j a block at 32 keys, 2 at 16, one j at 8,
// one j's pair at 4 and 2, one column at 1), so it hands over CS_P
// partials a tile (its two rows' probabilities times their factors,
// summed over the block's columns) to a two-slot ring [8 warps][CS_P][4
// t][8 g]; the producer's warps 1-3 (the reducers) give each (q, t) pair
// to one thread, which sums its 64 partials (8 warps x 8 g) from float4
// reads, and where a block spans a quad's threads (score blocks of 4 and
// up) the quad adds its pairs (shfl_xor 1, 2).  A score block of 32
// keys or fewer lies in one 128-key tile, so each block's sum is complete
// there and is stored once into the CTA's row in global memory: no slots,
// and no limit on nb.  The consumers' extra work is one FMA a column and
// CS_P shared-memory stores a tile; every reduction runs on the reducers.

constexpr int BM = 128;                   // query rows per CTA
constexpr int TILE = KT * HD * 2;         // bytes of a K or V tile
constexpr int SMEM_MAX = 232448;          // opt-in limit per block
constexpr int BAR_BYTES = 512;            // barriers, then records at +128
constexpr int REC_INTS = 24;              // a stage's record
constexpr int HAND_BYTES = 2 * 8 * 2 * 32 * 4;    // colsum hand-off ring

template <int ST>
constexpr int ring_bytes() {
  return 1024 + BM * HD * 2 + 2 * ST * TILE + BAR_BYTES;
}

// bytes of the column-sum hand-off ring for CS_P partials a thread
// (0: the two half-tile partials)
template <int P>
__host__ __device__ constexpr int hand_bytes() {
  return P ? 2 * 256 * P * 4 : HAND_BYTES;
}

struct Params {
  __nv_bfloat16* o;
  float* lse;              // nullptr: not written
  const float* prev_lse;   // colsum only
  float* cs;               // colsum only
  int Sq, Sk, score_block, nb;
  float tau;
  // the column-sparse key source
  const int* inds;         // [BH][G][jmax]
  const int* counts;       // [BH][G]
  int jmax, kv_block, kv_valid;
  int kstride, voff;       // map rows per block; V rows after K rows
  int qg, cpg;             // GROUPED key sources: rows a group, CTAs a group
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float neg_inf() {
  return __uint_as_float(0xff800000u);
}

template <int ST, bool CS, class Keys>
__global__ void __launch_bounds__(384, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const Params p) {
  static_assert(8 * (5 + 3 * ST) <= 128 &&
                128 + 4 * REC_INTS * ST <= BAR_BYTES, "barrier area");
  constexpr int Q_BOX = BM * BOX_ROW;            // bytes of one Q box
  constexpr bool GR = Keys::GROUPED;
  constexpr int CSP = Keys::CS_P;                // column-sum partials
  constexpr int NRW = CSP ? 3 : 1;               // reducer warps
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
  int* recs = reinterpret_cast<int*>(smem_raw + (sbar - raw) + 128);
  float* hand = reinterpret_cast<float*>(smem_raw + (sbar - raw) + BAR_BYTES);
  float* sums = hand + hand_bytes<CSP>() / 4;

  // the CTA's query group, its first row and the group's end
  const int bh = blockIdx.y, grp = GR ? blockIdx.x / p.cpg : blockIdx.x;
  const int row0 = GR ? grp * p.qg + (blockIdx.x % p.cpg) * BM
                      : blockIdx.x * BM;
  const int rend = GR ? (grp + 1) * p.qg : p.Sq;
  const Keys keys(p, bh, grp);
  const int n = keys.tiles();
  if (threadIdx.x == 0) {
    mbar_init(sbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 256);
    }
    for (int r = 0; r < 2; ++r) {
      mbar_init(cs_full(r), 256);
      mbar_init(cs_empty(r), NRW);
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
        keys.load(&tk, &tv, sk + s * TILE, sv + s * TILE, k_full(s),
                  v_full(s), recs + REC_INTS * s, i, bh);
      }
    } else if (CS && CSP == 0 && threadIdx.x / 32 == 1) {
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
    } else if (CS && CSP > 0 && threadIdx.x >= 32) {
      // The reducers of score blocks of 32 keys or fewer (above): reducer
      // thread u (0-95) takes the pairs (q, t) = (u / 4, u % 4), u + 96,
      // ... of the tile's 4 CS_P and sums the 8 warps x 8 g partials of
      // the pair (float4 reads of [w][q][t][g], two chains); the quad
      // then sums the t of one block, and its first thread stores it.
      // Fixed orders throughout.
      const int u = threadIdx.x - 32, lane = threadIdx.x & 31;
      for (int i = 0; i < n; ++i) {
        const int r = i & 1;
        mbar_wait(cs_full(r), (i >> 1) & 1);
        const float* hb = hand + r * (256 * CSP);
        for (int pi = u; pi - lane < 4 * CSP; pi += 96) {   // warp-uniform
          const int q = pi >> 2, t = pi & 3;
          float a0 = 0.f, a1 = 0.f;
          if (pi < 4 * CSP) {
#pragma unroll 1
            for (int w = 0; w < 8; ++w) {
              const float4* x = reinterpret_cast<const float4*>(
                  hb + ((w * CSP + q) * 4 + t) * 8);
              const float4 x0 = x[0];
              a0 += (x0.x + x0.y) + (x0.z + x0.w);
              const float4 x1 = x[1];
              a1 += (x1.x + x1.y) + (x1.z + x1.w);
            }
          }
          float v = a0 + a1;
          const int sb = p.score_block;
          const int tg = sb >= 8 ? 4 : sb == 4 ? 2 : 1;   // threads a block
          if (tg >= 2) v += __shfl_xor_sync(0xffffffffu, v, 1);
          if (tg >= 4) v += __shfl_xor_sync(0xffffffffu, v, 2);
          // the first column of the pair in the tile
          const int col = CSP == 32 ? 8 * (q >> 1) + 2 * t + (q & 1)
                                    : (KT / (CSP ? CSP : 1)) * q + 2 * t;
          const int b = (i * KT + col) / sb;
          if (pi < 4 * CSP && t % tg == 0 && b < p.nb)
            p.cs[((size_t)bh * gridDim.x + blockIdx.x) * p.nb + b] = v;
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(cs_empty(r));
      }
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
    if (CS && GR) {
      // rows past the group: factor 2^(m - inf) = 0
      const float inf = __uint_as_float(0x7f800000u);
      pl0 = r0 < rend ? p.prev_lse[(size_t)bh * p.Sq + r0] : inf;
      pl1 = r0 + 8 < rend ? p.prev_lse[(size_t)bh * p.Sq + r0 + 8] : inf;
    } else if (CS) {
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
      keys.mask(recs + REC_INTS * (i % ST), i, s, t);
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
        if (CSP) {            // the factors; colsum_hand forms the partials
          cp0 = f0;
          cp1 = f1;
        } else {
          cp0 = rs00 * f0 + rs10 * f1;
          cp1 = rs01 * f0 + rs11 * f1;
        }
      }
    };
    // hand tile i's column-sum partials of both halves to the reducer
    auto colsum_hand = [&](int i) {
      if (!CS) return;
      const int r = i & 1;
      if (i >= 2) mbar_wait(cs_empty(r), ((i >> 1) - 1) & 1);
      if (CSP == 0) {
        float* h = hand + r * 512 + (4 * c + warp) * 64;
        h[lane] = cp0;
        h[32 + lane] = cp1;
      } else {
        // partial q: columns 8 j + 2 t + e of j = q JQ .. q JQ + JQ - 1
        // (CSP 32: j = q / 2, e = q % 2 alone), both rows
        constexpr int JQ = CSP >= 16 ? 1 : 16 / (CSP ? CSP : 16);
        float* h = hand + r * (256 * CSP) + (4 * c + warp) * (32 * CSP) +
                   8 * t + g;                       // [w][q][t][g]
#pragma unroll
        for (int q = 0; q < CSP; ++q) {
          float x;
          if (CSP == 32) {
            const int j = q / 2, e = q % 2;
            x = s[4 * j + e] * cp0 + s[4 * j + 2 + e] * cp1;
          } else {
            float x0 = 0.f, x1 = 0.f;
#pragma unroll
            for (int jj = 0; jj < JQ; ++jj) {
              const int j = q * JQ + jj;
              x0 += s[4 * j] + s[4 * j + 1];
              x1 += s[4 * j + 2] + s[4 * j + 3];
            }
            x = x0 * cp0 + x1 * cp1;
          }
          h[32 * q] = x;
        }
      }
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
    if (CSP) colsum_hand(0);     // P's partials before it is packed
    rescale_pack();
    if (!CSP) colsum_hand(0);
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
      if (CSP) colsum_hand(i);
      rescale_pack();
      if (!CSP) colsum_hand(i);
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
      if (r < rend) {
        __nv_bfloat16* orow = p.o + ((size_t)bh * p.Sq + r) * HD;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t) =
              pack_bf16(o[4 * j + 2 * h] / l, o[4 * j + 2 * h + 1] / l);
        if (p.lse != nullptr && t == 0)
          p.lse[(size_t)bh * p.Sq + r] = (h ? m1 : m0) + log2f(l);
      }
    }
  }
}

// Launch over G query groups x BH heads (groups fastest, so the CTAs
// resident at one time share a head and its K/V stays in L2) with smem
// bytes of dynamic shared memory; returns a cudaError_t.
template <int ST, bool CS, class Keys>
int launch_attn(const CUtensorMap& tq, const CUtensorMap& tk,
                const CUtensorMap& tv, const Params& p, int G, int BH,
                int smem, cudaStream_t stream) {
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static const int attr = allow_smem(attn_sm90_kernel<ST, CS, Keys>, SMEM_MAX);
  if (attr != 0) return attr;
  attn_sm90_kernel<ST, CS, Keys><<<dim3(G, BH), 384, smem, stream>>>(
      tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace chipmunk
