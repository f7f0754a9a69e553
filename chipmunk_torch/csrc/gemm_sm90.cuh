// Hopper gathered GEMM: TMA loads of row-gathered tiles into a ring of
// stages, wgmma from shared memory, warp-specialised.  One kernel template,
// gemm_sm90_kernel<T, Op>: the operand type T is a template parameter (s8:
// the int8-activation sparse-MLP pairs of csp_mlp.cu; bf16: the
// bf16-activation pairs), and the work and the epilogue come from Op.
//
// A CTA computes a [128 rows] x [Op::BN columns] tile, D = A B, from an
// A map (rows of A, k contiguous: K-major) and a B map.  Stage i holds
// the 128-byte k slice Op::coords names (128 s8 or 64 bf16 values of k)
// of 128 A rows and of BN B columns, each box with 128-byte swizzle at a
// 1024-byte boundary.  A, and B where Op::B_MN is false, are K-major
// boxes [rows][128 bytes of k]: the descriptors are those of
// attn_sm90.cuh's Q K^T (SBO 1024 bytes, k-step kk at byte offset 32 kk).
// s8 wgmma takes only that layout.  Where Op::B_MN is true (bf16 only) B
// is read MN-major, as it lies in a [k][n] row-major array: BN / 64 boxes
// of [64 k rows][64 n = 128 bytes], 8 KB apart, read with wgmma's
// transpose-B flag: LBO = 8 KB (the next 64 columns), SBO = 1024 bytes
// (the next 8 k rows), k-step kk (16 k rows) at byte offset 2048 kk -- as
// attn_sm90.cuh's V in P V.  The gather is only the box's row (or k)
// coordinate: a selected neuron block is a run of rows.
//
//   - warpgroup 0, the producer, drops to 24 registers; one thread waits
//     for a stage to be empty, arms its "full" mbarrier with the stage's
//     bytes and issues its TMA loads;
//   - each consumer warpgroup (240 registers) owns 64 of the 128 rows:
//     per stage four wgmma k-steps of 32 bytes (m64nBNk32 s8 -> s32, or
//     m64nBNk16 bf16 -> f32), with one group in flight: stage i's products
//     are issued before stage i - 1's are waited for, and that stage is
//     handed back on its "empty" mbarrier (all 256 consumer threads
//     arrive).  Where Op::flush(i) says so, the consumer waits for all its
//     products and hands the sum to Op::after (a per-block scale into an
//     f32 sum); Op::restart(i) starts a new sum with scale-d 0 (no zeroing
//     pass).
//
// Accumulator of m64nNk32 (s32) or m64nNk16 (f32) in a warpgroup (warp w,
// lane = 4 g + t): d[4 j + e] holds row 16 w + g + 8 (e / 2), column 8 j +
// 2 t + (e % 2).  So a row lies in one quad of one warp: a row reduction
// is thread-local plus two shfl_xor.  Its type is Mma<T, BN>::Acc.
//
// Op (built by every thread from the params and blockIdx):
//   BN, ST: columns of the tile, ring stages; B_MN: B's layout, as above;
//   live(): false for a CTA with nothing to multiply; idle() then runs on
//     all threads and the CTA ends (before any barrier);
//   tiles(): the number of k stages (at least 1);
//   coords(i, ka, ra, kb, rb): stage i's A box at (k ka, row ra) and B
//     box at (kb, rb): K-major (k kb, row rb); MN-major (column kb, k row
//     rb), the later boxes at columns kb + 64, kb + 128, ...;
//   restart(i), flush(i): as above; after(i, acc, c): the flushed sum;
//   issued(i, c): right after stage i's products are issued (to load
//     what after() needs while they run);
//   begin(acc, c, extra, bar): before the k loop in consumer c, with the
//     zeroed accumulator (an Op that never restarts may load a sum into
//     it, e.g. from the extra space once bar's phase 0 completes);
//   EXTRA, side_load(extra, bar): shared memory past the ring (at a
//     1024-byte boundary) and the loads into it that the producer thread
//     issues before the first stage's, on the mbarrier bar (phase 0);
//   end(acc, c, ring, extra, bar): after the k loop (every product done;
//     the ring is free once both consumers are past it), with generic
//     pointers to the ring and the extra space.
//
// A from registers (an Op with RAW, see Conv: the quantized-weight pairs
// of csp_mlp.cu, int8 or int4 weights with bf16 x (wq, w4) and int4 with
// int8 x (a8w4)).  The codes are the A operand: their bytes arrive by TMA
// in a ring of RS raw boxes of RAW bytes past the stages, one box every
// EVERY stages (raw_load(dst, map, bar, q) issues box q from the first
// map, ta), and each consumer
// warpgroup builds its A fragments of a stage from the box in registers
// (a_frag(i, c, box, af): MT m64 tiles x 4 k-steps x 4 registers, bf16
// pairs of the m64k16 fragment or four s8 of the m64k32 one) and runs
// wgmma with A in registers.  A stage is then only the B tile of Op::BN
// rows (BN 64, 128 or 256: the accumulator's columns), from the
// second map.  With CONVERT, warps 1-3 of the producer warpgroup rewrite
// each B tile in place once it is in (convert(i, thread of 96, tile,
// carry), after convert_begin(thread, carry); Op::Carry is what a thread
// carries from one stage to the next, e.g. the next stage's operands
// loaded under this one), then fence.proxy.async and an arrival on the
// stage's "converted" mbarrier, which the consumers wait on after
// "full".  The consumers hand a raw box back on its "free" mbarrier once
// they have read it.  With MT = 1 their fragments alternate between two
// register sets, so that one stage's products run while the next
// stage's fragments are built; with MT = 2 (32 registers a set) each
// stage's products are waited for before the next stage's fragments, and
// there (only) issued(i, c) runs right after they are issued and
// after(i, acc, c) where flush(i) says so, as on the path above.
// Register split 56 / 224 / 224 with CONVERT, else 24 / 240 / 240 (the
// sum of the three warpgroups' is that of 168 a thread).
#pragma once

#include <type_traits>

#include "attn_sm90.cuh"

namespace chipmunk {
namespace sm90 {

constexpr int GM = 128;          // rows of a CTA tile (two warpgroups)
constexpr int GK = 128;          // bytes of k per stage (one swizzled box)

// A 2-D map over a row-major [rows][row_bytes] array of bytes, as 3-D with
// one head for tma_load; box [box_rows][128 bytes], 128-byte swizzle.
// 0 on success, else a cudaError_t.
// With elem 2 the elements are 16-bit (a bf16 cache): the box is then 64
// elements wide, still 128 bytes.
inline int make_byte_map(CUtensorMap* map, const void* base, long long rows,
                         long long row_bytes, int box_rows, int elem = 1) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[3] = {(cuuint64_t)(row_bytes / elem),
                              (cuuint64_t)rows, 1};
  const cuuint64_t strides[2] = {(cuuint64_t)row_bytes,
                                 (cuuint64_t)(rows * row_bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)(GK / elem), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t estr[3] = {1, 1, 1};
  CUresult r = enc(map, elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                  : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                   const_cast<void*>(base), dims, strides, box, estr,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The accumulator operands of a 32-wide (ACC32), 64-wide (ACC64) or
// 128-wide (ACC128) register fragment, each as R(d[i]) (R: "+r" for s32,
// "+f" for f32), and their places in the instruction (D32, D64, D128).
#define CHIPMUNK_ACC32(R) \
  R(d[0]), R(d[1]), R(d[2]), R(d[3]), R(d[4]), R(d[5]), R(d[6]), R(d[7]),  \
  R(d[8]), R(d[9]), R(d[10]), R(d[11]), R(d[12]), R(d[13]), R(d[14]),  \
  R(d[15]), R(d[16]), R(d[17]), R(d[18]), R(d[19]), R(d[20]), R(d[21]),  \
  R(d[22]), R(d[23]), R(d[24]), R(d[25]), R(d[26]), R(d[27]), R(d[28]),  \
  R(d[29]), R(d[30]), R(d[31])

#define CHIPMUNK_ACC64(R) \
  R(d[0]), R(d[1]), R(d[2]), R(d[3]), R(d[4]), R(d[5]), R(d[6]), R(d[7]),  \
  R(d[8]), R(d[9]), R(d[10]), R(d[11]), R(d[12]), R(d[13]), R(d[14]),  \
  R(d[15]), R(d[16]), R(d[17]), R(d[18]), R(d[19]), R(d[20]), R(d[21]),  \
  R(d[22]), R(d[23]), R(d[24]), R(d[25]), R(d[26]), R(d[27]), R(d[28]),  \
  R(d[29]), R(d[30]), R(d[31]), R(d[32]), R(d[33]), R(d[34]), R(d[35]),  \
  R(d[36]), R(d[37]), R(d[38]), R(d[39]), R(d[40]), R(d[41]), R(d[42]),  \
  R(d[43]), R(d[44]), R(d[45]), R(d[46]), R(d[47]), R(d[48]), R(d[49]),  \
  R(d[50]), R(d[51]), R(d[52]), R(d[53]), R(d[54]), R(d[55]), R(d[56]),  \
  R(d[57]), R(d[58]), R(d[59]), R(d[60]), R(d[61]), R(d[62]), R(d[63])

#define CHIPMUNK_ACC128(R) \
  R(d[0]), R(d[1]), R(d[2]), R(d[3]), R(d[4]), R(d[5]), R(d[6]), R(d[7]),  \
  R(d[8]), R(d[9]), R(d[10]), R(d[11]), R(d[12]), R(d[13]), R(d[14]),  \
  R(d[15]), R(d[16]), R(d[17]), R(d[18]), R(d[19]), R(d[20]), R(d[21]),  \
  R(d[22]), R(d[23]), R(d[24]), R(d[25]), R(d[26]), R(d[27]), R(d[28]),  \
  R(d[29]), R(d[30]), R(d[31]), R(d[32]), R(d[33]), R(d[34]), R(d[35]),  \
  R(d[36]), R(d[37]), R(d[38]), R(d[39]), R(d[40]), R(d[41]), R(d[42]),  \
  R(d[43]), R(d[44]), R(d[45]), R(d[46]), R(d[47]), R(d[48]), R(d[49]),  \
  R(d[50]), R(d[51]), R(d[52]), R(d[53]), R(d[54]), R(d[55]), R(d[56]),  \
  R(d[57]), R(d[58]), R(d[59]), R(d[60]), R(d[61]), R(d[62]), R(d[63]),  \
  R(d[64]), R(d[65]), R(d[66]), R(d[67]), R(d[68]), R(d[69]), R(d[70]),  \
  R(d[71]), R(d[72]), R(d[73]), R(d[74]), R(d[75]), R(d[76]), R(d[77]),  \
  R(d[78]), R(d[79]), R(d[80]), R(d[81]), R(d[82]), R(d[83]), R(d[84]),  \
  R(d[85]), R(d[86]), R(d[87]), R(d[88]), R(d[89]), R(d[90]), R(d[91]),  \
  R(d[92]), R(d[93]), R(d[94]), R(d[95]), R(d[96]), R(d[97]), R(d[98]),  \
  R(d[99]), R(d[100]), R(d[101]), R(d[102]), R(d[103]), R(d[104]),  \
  R(d[105]), R(d[106]), R(d[107]), R(d[108]), R(d[109]), R(d[110]),  \
  R(d[111]), R(d[112]), R(d[113]), R(d[114]), R(d[115]), R(d[116]),  \
  R(d[117]), R(d[118]), R(d[119]), R(d[120]), R(d[121]), R(d[122]),  \
  R(d[123]), R(d[124]), R(d[125]), R(d[126]), R(d[127])

#define CHIPMUNK_D32 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18," \
  "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31}"

#define CHIPMUNK_D64 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18," \
  "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35," \
  "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52," \
  "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}"

#define CHIPMUNK_D128 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18," \
  "%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35," \
  "%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52," \
  "%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69," \
  "%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86," \
  "%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102," \
  "%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116," \
  "%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}"
#define CHIPMUNK_S32(x) "+r"(x)
#define CHIPMUNK_F32(x) "+f"(x)

// Box (x0, row) of a 3-D map with one head from shared memory at src
// (the async proxy's view: fence_async first); completion is tracked by
// bulk groups of the issuing thread.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int x0, int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(x0), "r"(row),
         "r"(0)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to
// the async proxy (a TMA store, a wgmma operand).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of byte x of row r in a [rows][128-byte] box as TMA lays it
// out with 128-byte swizzle (16-byte chunk x / 16 at (x / 16) ^ (r % 8)).
__device__ __forceinline__ uint32_t swz128(int r, int x) {
  return r * 128 + ((((x >> 4) ^ r) & 7) << 4) + (x & 15);
}

// One k-step (32 bytes of k) of a warpgroup's 64 x N product, both
// operands from shared memory; A K-major, B K-major or (TB, bf16 only)
// MN-major.  Acc: the accumulator's type, ACC: its registers a thread.
template <typename T, int N, bool TB = false>
struct Mma;

template <>
struct Mma<int8_t, 256> {
  using Acc = int;
  static constexpr int ACC = 128;
  static __device__ __forceinline__ void issue(int (&d)[128], uint64_t da,
                                               uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " CHIPMUNK_D128
        ", %128, %129, p;\n}\n"
        : CHIPMUNK_ACC128(CHIPMUNK_S32)
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // A from registers (the m64k32 s8 fragment: 4 k of a row a register),
  // B K-major
  static __device__ __forceinline__ void issue_rs(int (&d)[128],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " CHIPMUNK_D128
        ", {%128, %129, %130, %131}, %132, p;\n}\n"
        : CHIPMUNK_ACC128(CHIPMUNK_S32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <>
struct Mma<int8_t, 128> {
  using Acc = int;
  static constexpr int ACC = 64;
  static __device__ __forceinline__ void issue(int (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " CHIPMUNK_D64
        ", %64, %65, p;\n}\n"
        : CHIPMUNK_ACC64(CHIPMUNK_S32)
        : "l"(da), "l"(db), "r"(accumulate));
  }
  static __device__ __forceinline__ void issue_rs(int (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " CHIPMUNK_D64
        ", {%64, %65, %66, %67}, %68, p;\n}\n"
        : CHIPMUNK_ACC64(CHIPMUNK_S32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <>
struct Mma<int8_t, 64> {     // A from registers only (64-token a8w4 tiles)
  using Acc = int;
  static constexpr int ACC = 32;
  static __device__ __forceinline__ void issue_rs(int (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " CHIPMUNK_D32
        ", {%32, %33, %34, %35}, %36, p;\n}\n"
        : CHIPMUNK_ACC32(CHIPMUNK_S32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <bool TB>
struct Mma<__nv_bfloat16, 256, TB> {
  using Acc = float;
  static constexpr int ACC = 128;
  static __device__ __forceinline__ void issue(float (&d)[128], uint64_t da,
                                               uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        CHIPMUNK_D128 ", %128, %129, p, 1, 1, 0, %131;\n}\n"
        : CHIPMUNK_ACC128(CHIPMUNK_F32)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB ? 1 : 0));
  }
  // A from registers (bf16 pairs of the m64k16 fragment), B K-major
  static __device__ __forceinline__ void issue_rs(float (&d)[128],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        CHIPMUNK_D128 ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
        : CHIPMUNK_ACC128(CHIPMUNK_F32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

template <bool TB>
struct Mma<__nv_bfloat16, 128, TB> {
  using Acc = float;
  static constexpr int ACC = 64;
  static __device__ __forceinline__ void issue(float (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        CHIPMUNK_D64 ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : CHIPMUNK_ACC64(CHIPMUNK_F32)
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB ? 1 : 0));
  }
  static __device__ __forceinline__ void issue_rs(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db,
                                                  int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        CHIPMUNK_D64 ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : CHIPMUNK_ACC64(CHIPMUNK_F32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(accumulate));
  }
};

#undef CHIPMUNK_ACC32
#undef CHIPMUNK_ACC64
#undef CHIPMUNK_ACC128
#undef CHIPMUNK_D32
#undef CHIPMUNK_D64
#undef CHIPMUNK_D128
#undef CHIPMUNK_S32
#undef CHIPMUNK_F32

// Pin an accumulator in place (as fence_acc), s32 or f32.
template <int N>
__device__ __forceinline__ void fence_iacc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_iacc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// An Op whose A is built in registers names RAW (bytes of a raw box), RS
// (raw boxes in their ring), EVERY (stages one box feeds), MT (m64 tiles
// a consumer warpgroup computes) and CONVERT (producer warps rewrite each
// B tile; they then hold 56 registers a thread and the consumers 224).
// Every other Op takes the defaults: A in shared memory, 24 / 240.
template <class Op, class = void>
struct Conv {
  static constexpr int RAW = 0, RS = 0, EVERY = 1, MT = 1, BAR = 128;
  static constexpr bool CONVERT = false;
  static constexpr int PRODUCER = 24, CONSUMER = 240;
};

template <class Op>
struct Conv<Op, std::void_t<decltype(Op::RAW)>> {
  static constexpr int RAW = Op::RAW, RS = Op::RS, EVERY = Op::EVERY;
  static constexpr int MT = Op::MT, BAR = 256;
  static constexpr bool CONVERT = Op::CONVERT;
  static constexpr int PRODUCER = CONVERT ? 56 : 24;
  static constexpr int CONSUMER = CONVERT ? 224 : 240;
};

template <class Op>
constexpr int gemm_smem() {
  return 1024 + Op::ST * ((Conv<Op>::RAW ? 0 : GM) + Op::BN) * GK +
         Conv<Op>::RS * Conv<Op>::RAW + Op::EXTRA + Conv<Op>::BAR;
}

template <typename T, class Op>
__global__ void __launch_bounds__(384, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ typename Op::Params p) {
  using CV = Conv<Op>;
  constexpr int ST = Op::ST, A_TILE = CV::RAW ? 0 : GM * GK;
  constexpr int STAGE = A_TILE + Op::BN * GK;
  using M = Mma<T, Op::BN, Op::B_MN>;
  static_assert(8 * (2 * ST + 1 + (CV::RAW ? ST + 2 * CV::RS : 0)) <= CV::BAR,
                "barrier area");
  Op op(p);
  if (!op.live()) {
    op.idle();
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t raw = ring + ST * STAGE, extra = raw + CV::RS * CV::RAW;
  const uint32_t sbar = extra + Op::EXTRA;
  auto full = [&](int s) { return sbar + 8 * s; };
  auto empty = [&](int s) { return sbar + 8 * (ST + s); };
  const uint32_t side = sbar + 16 * ST;
  // A in registers: stage s converted; raw box r loaded, and read
  auto conv = [&](int s) { return side + 8 + 8 * s; };
  auto rfull = [&](int r) { return side + 8 + 8 * (ST + r); };
  auto rfree = [&](int r) { return side + 8 + 8 * (ST + CV::RS + r); };
  const int n = op.tiles();
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    mbar_init(side, 1);
    if constexpr (CV::RAW > 0) {
      for (int s = 0; s < ST; ++s) mbar_init(conv(s), 96);
      for (int r = 0; r < CV::RS; ++r) {
        mbar_init(rfull(r), 1);
        mbar_init(rfree(r), 256);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    reg_dealloc<CV::PRODUCER>();
    if (threadIdx.x == 0) {
      op.side_load(extra, side);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
        int ka, ra, kb, rb;
        op.coords(i, ka, ra, kb, rb);
        if constexpr (CV::RAW > 0) {
          // the B tile; A's raw box, once every EVERY stages
          mbar_expect_tx(full(s), STAGE);
          tma_load(ring + s * STAGE, &tb, full(s), kb, rb, 0);
          if (i % CV::EVERY == 0) {
            const int q = i / CV::EVERY, r = q % CV::RS;
            if (q >= CV::RS) mbar_wait(rfree(r), ((q / CV::RS) - 1) & 1);
            mbar_expect_tx(rfull(r), CV::RAW);
            op.raw_load(raw + r * CV::RAW, &ta, rfull(r), q);
          }
        } else {
          mbar_expect_tx(full(s), STAGE);
          tma_load(ring + s * STAGE, &ta, full(s), ka, ra, 0);
          const uint32_t bs = ring + s * STAGE + A_TILE;
          if (Op::B_MN) {
#pragma unroll
            for (int b = 0; b < Op::BN / 64; ++b)
              tma_load(bs + b * 64 * GK, &tb, full(s), kb + 64 * b, rb, 0);
          } else {
            tma_load(bs, &tb, full(s), kb, rb, 0);
          }
        }
      }
    } else if constexpr (CV::CONVERT) {
      // warps 1-3 rewrite each B tile in place once it is in
      if (threadIdx.x >= 32) {
        unsigned char* gring = smem_raw + (ring - smem_u32(smem_raw));
        typename Op::Carry carry;            // carried from stage to stage
        op.convert_begin(threadIdx.x - 32, carry);
        for (int i = 0; i < n; ++i) {
          const int s = i % ST;
          mbar_wait(full(s), (i / ST) & 1);
          op.convert(i, threadIdx.x - 32, gring + s * STAGE, carry);
          fence_async();
          mbar_arrive(conv(s));
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    reg_alloc<CV::CONSUMER>();
    const int c = threadIdx.x / 128 - 1;
    const uint32_t a_off = c * 64 * GK;       // this warpgroup's 64 rows
    typename M::Acc acc[M::ACC * CV::MT];
#pragma unroll
    for (int i = 0; i < M::ACC * CV::MT; ++i) acc[i] = 0;
    op.begin(acc, c, smem_raw + (extra - smem_u32(smem_raw)), side);
    if constexpr (CV::RAW > 0) {
      // A in registers: stage i's fragments from its raw box, then its
      // products.  With one m64 tile a warpgroup (16 registers a set) the
      // fragments alternate between two sets and stage i - 1's products
      // are waited for after stage i's are issued; with more, one set,
      // and each stage's products are waited for before the next.
      constexpr bool TWO = CV::MT == 1;
      const unsigned char* graw = smem_raw + (raw - smem_u32(smem_raw));
      auto stage = [&](int i, uint32_t (&af)[CV::MT][4][4]) {
        const int s = i % ST, q = i / CV::EVERY, r = q % CV::RS;
        if (i % CV::EVERY == 0) mbar_wait(rfull(r), (q / CV::RS) & 1);
        op.a_frag(i, c, graw + r * CV::RAW, af);
        if (i % CV::EVERY == CV::EVERY - 1) mbar_arrive(rfree(r));
        mbar_wait(full(s), (i / ST) & 1);
        if constexpr (CV::CONVERT) mbar_wait(conv(s), (i / ST) & 1);
        const uint32_t b = ring + s * STAGE;
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < CV::MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < GK / 32; ++kk)
            M::issue_rs(*reinterpret_cast<typename M::Acc(*)[M::ACC]>(
                            acc + mt * M::ACC),
                        af[mt][kk], gmma_desc(b + 32 * kk, 16, 1024),
                        kk > 0 || !op.restart(i));
        wgmma_commit();
        if constexpr (TWO) {
          wgmma_wait<1>();
          if (i > 0) mbar_arrive(empty((i - 1) % ST));
        } else {
          op.issued(i, c);
          wgmma_wait<0>();
          if (op.flush(i)) {
            fence_iacc(acc);
            op.after(i, acc, c);
          }
          mbar_arrive(empty(s));
        }
      };
      uint32_t af0[CV::MT][4][4], af1[CV::MT][4][4];
      if constexpr (TWO) {
        int i = 0;
        for (; i + 1 < n; i += 2) {
          stage(i, af0);
          stage(i + 1, af1);
        }
        if (i < n) stage(i, af0);      // one set only while its products fly
      } else {
        for (int i = 0; i < n; ++i) stage(i, af0);
      }
      wgmma_wait<0>();
      fence_iacc(acc);
      if (TWO) mbar_arrive(empty((n - 1) % ST));
    } else {
      int pend = -1;                            // stage whose products fly
      for (int i = 0; i < n; ++i) {
        const int s = i % ST;
        mbar_wait(full(s), (i / ST) & 1);
        const uint32_t a = ring + s * STAGE + a_off;
        const uint32_t b = ring + s * STAGE + A_TILE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < GK / 32; ++kk)
          M::issue(acc, gmma_desc(a + 32 * kk, 16, 1024),
                   Op::B_MN ? gmma_desc(b + 2048 * kk, 64 * GK, 1024)
                            : gmma_desc(b + 32 * kk, 16, 1024),
                   kk > 0 || !op.restart(i));
        wgmma_commit();
        op.issued(i, c);
        if (op.flush(i)) {
          wgmma_wait<0>();
          fence_iacc(acc);
          if (pend >= 0) mbar_arrive(empty(pend % ST));
          mbar_arrive(empty(s));
          pend = -1;
          op.after(i, acc, c);
        } else {
          wgmma_wait<1>();
          if (pend >= 0) mbar_arrive(empty(pend % ST));
          pend = i;
        }
      }
      wgmma_wait<0>();
      fence_iacc(acc);
      if (pend >= 0) mbar_arrive(empty(pend % ST));
    }
    op.end(acc, c, smem_raw + (ring - smem_u32(smem_raw)),
           smem_raw + (extra - smem_u32(smem_raw)), side);
  }
}

// Launch over grid with the ring's shared memory; returns a cudaError_t.
template <typename T, class Op>
int launch_gemm(const CUtensorMap& ta, const CUtensorMap& tb,
                const typename Op::Params& p, dim3 grid, cudaStream_t stream) {
  constexpr int SMEM = gemm_smem<Op>();
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static const int attr = allow_smem(gemm_sm90_kernel<T, Op>, SMEM);
  if (attr != 0) return attr;
  gemm_sm90_kernel<T, Op><<<grid, 384, SMEM, stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

}  // namespace sm90
}  // namespace chipmunk
