// Hopper gathered GEMM: TMA loads of row-gathered tiles into a ring of
// stages, wgmma from shared memory, warp-specialised.  One kernel template,
// gemm_sm90_kernel<T, Op>: the operand type T is a template parameter (s8
// now: the int8-activation sparse-MLP pair of csp_mlp.cu), and the work
// and the epilogue come from Op.
//
// A CTA computes a [128 rows] x [Op::BN columns] tile, D = A B^T, from an
// A map (rows of A, k contiguous) and a B map (rows of B, k contiguous):
// both operands K-major, the only layout s8 wgmma takes.  Stage i holds
// the 128-byte k slice Op::coords names of 128 A rows and BN B rows, each
// one TMA box with 128-byte swizzle at a 1024-byte boundary, so the
// descriptors are those of attn_sm90.cuh's Q K^T (SBO 1024 bytes, k-step
// kk at byte offset 32 kk).  The gather is only the box's row (or k)
// coordinate: a selected neuron block is a run of rows.
//
//   - warpgroup 0, the producer, drops to 24 registers; one thread waits
//     for a stage to be empty, arms its "full" mbarrier with the stage's
//     bytes and issues its two TMA loads;
//   - each consumer warpgroup (240 registers) owns 64 of the 128 rows:
//     per stage four wgmma.m64nBNk32 (s8 in, s32 accumulate), with one
//     group in flight: stage i's products are issued before stage i - 1's
//     are waited for, and that stage is handed back on its "empty"
//     mbarrier (all 256 consumer threads arrive).  Where Op::flush(i) says
//     so, the consumer waits for all its products and hands the s32 sum to
//     Op::after (a per-block scale into an f32 sum); Op::restart(i) starts
//     a new sum with scale-d 0 (no zeroing pass).
//
// Accumulator of m64nNk32 (s32) in a warpgroup, as for f32 (warp w, lane
// = 4 g + t): d[4 j + e] holds row 16 w + g + 8 (e / 2), column 8 j + 2 t
// + (e % 2).  So a row lies in one quad of one warp: a row reduction is
// thread-local plus two shfl_xor.
//
// Op (built by every thread from the params and blockIdx):
//   BN, ST: columns of the tile, ring stages;
//   live(): false for a CTA with nothing to multiply; idle() then runs on
//     all threads and the CTA ends (before any barrier);
//   tiles(): the number of k stages (at least 1);
//   coords(i, ka, ra, kb, rb): stage i's A box at (k byte ka, row ra) and
//     B box at (kb, rb);
//   restart(i), flush(i): as above; after(i, acc, c): the flushed sum;
//   issued(i, c): right after stage i's products are issued (to load
//     what after() needs while they run);
//   begin(c): before the k loop in consumer c;
//   EXTRA, side_load(extra, bar): shared memory past the ring (at a
//     1024-byte boundary) and the loads into it that the producer thread
//     issues before the first stage's, on the mbarrier bar (phase 0);
//   end(acc, c, ring, extra, bar): after the k loop (every product done;
//     the ring is free once both consumers are past it), with generic
//     pointers to the ring and the extra space.
#pragma once

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

#define CHIPMUNK_S32_ACC64 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),  \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),  \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),  \
  "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),  \
  "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),  \
  "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),  \
  "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),  \
  "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),  \
  "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),  \
  "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),  \
  "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),  \
  "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),  \
  "+r"(d[62]), "+r"(d[63])

#define CHIPMUNK_S32_D64 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37," \
  "%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55," \
  "%56,%57,%58,%59,%60,%61,%62,%63}"

#define CHIPMUNK_S32_ACC128 \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),  \
  "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),  \
  "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),  \
  "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]),  \
  "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]),  \
  "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),  \
  "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),  \
  "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),  \
  "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]),  \
  "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),  \
  "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]),  \
  "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),  \
  "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),  \
  "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),  \
  "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]),  \
  "+r"(d[77]), "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]),  \
  "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]),  \
  "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),  \
  "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),  \
  "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),  \
  "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]),  \
  "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),  \
  "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]),  \
  "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),  \
  "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),  \
  "+r"(d[127])

#define CHIPMUNK_S32_D128 \
  "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19," \
  "%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37," \
  "%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55," \
  "%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73," \
  "%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91," \
  "%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107," \
  "%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121," \
  "%122,%123,%124,%125,%126,%127}"

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
// operands from shared memory, K-major.
template <typename T, int N>
struct Mma;

template <>
struct Mma<int8_t, 256> {
  static constexpr int ACC = 128;
  static __device__ __forceinline__ void issue(int (&d)[128], uint64_t da,
                                               uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " CHIPMUNK_S32_D128
        ", %128, %129, p;\n}\n"
        : CHIPMUNK_S32_ACC128
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

template <>
struct Mma<int8_t, 128> {
  static constexpr int ACC = 64;
  static __device__ __forceinline__ void issue(int (&d)[64], uint64_t da,
                                               uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " CHIPMUNK_S32_D64
        ", %64, %65, p;\n}\n"
        : CHIPMUNK_S32_ACC64
        : "l"(da), "l"(db), "r"(accumulate));
  }
};

#undef CHIPMUNK_S32_ACC64
#undef CHIPMUNK_S32_D64
#undef CHIPMUNK_S32_ACC128
#undef CHIPMUNK_S32_D128

// Pin an s32 accumulator in place (as fence_acc for f32).
template <int N>
__device__ __forceinline__ void fence_iacc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

template <class Op>
constexpr int gemm_smem() {
  return 1024 + Op::ST * (GM + Op::BN) * GK + Op::EXTRA + 128;
}

template <typename T, class Op>
__global__ void __launch_bounds__(384, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb,
                 const __grid_constant__ typename Op::Params p) {
  constexpr int ST = Op::ST, A_TILE = GM * GK, STAGE = (GM + Op::BN) * GK;
  using M = Mma<T, Op::BN>;
  static_assert(8 * (2 * ST + 1) <= 128, "barrier area");
  Op op(p);
  if (!op.live()) {
    op.idle();
    return;
  }
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t extra = ring + ST * STAGE, sbar = extra + Op::EXTRA;
  auto full = [&](int s) { return sbar + 8 * s; };
  auto empty = [&](int s) { return sbar + 8 * (ST + s); };
  const uint32_t side = sbar + 16 * ST;
  const int n = op.tiles();
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 256);
    }
    mbar_init(side, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    reg_dealloc<24>();
    if (threadIdx.x == 0) {
      op.side_load(extra, side);
      for (int i = 0; i < n; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(empty(s), ((i / ST) - 1) & 1);
        int ka, ra, kb, rb;
        op.coords(i, ka, ra, kb, rb);
        mbar_expect_tx(full(s), STAGE);
        tma_load(ring + s * STAGE, &ta, full(s), ka, ra, 0);
        tma_load(ring + s * STAGE + A_TILE, &tb, full(s), kb, rb, 0);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    reg_alloc<240>();
    const int c = threadIdx.x / 128 - 1;
    const uint32_t a_off = c * 64 * GK;       // this warpgroup's 64 rows
    int acc[M::ACC];
#pragma unroll
    for (int i = 0; i < M::ACC; ++i) acc[i] = 0;
    op.begin(c);
    int pend = -1;                            // stage whose products fly
    for (int i = 0; i < n; ++i) {
      const int s = i % ST;
      mbar_wait(full(s), (i / ST) & 1);
      const uint32_t a = ring + s * STAGE + a_off, b = ring + s * STAGE + A_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GK / 32; ++kk)
        M::issue(acc, gmma_desc(a + 32 * kk, 16, 1024),
                 gmma_desc(b + 32 * kk, 16, 1024), kk > 0 || !op.restart(i));
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
