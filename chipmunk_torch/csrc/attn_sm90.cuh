// Hopper building blocks of the dense flash-attention kernels
// (flash_attention.cu): TMA tensor maps and loads, mbarriers, named
// barriers, register reallocation, and the two warpgroup products of a
// 64 x 128 x 128 attention step.  Head dim 128, bf16 operands, f32
// accumulators.
//
// Shared-memory tiles are laid out as TMA writes them with 128-byte
// swizzle: a [rows][128] bf16 tile is two boxes of [rows][64] (128-byte
// rows), d 0-63 then d 64-127; inside a box the 16-byte chunk c of row r
// sits at chunk c ^ (r % 8), in atoms of 8 rows (1024 bytes).  Every tile
// starts on a 1024-byte boundary, so the wgmma descriptors take a base
// offset of 0 and the hardware undoes the swizzle from the address bits.
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
// 8-column chunk the C fragment of mma.sync.m16n8k16.
#pragma once

#include <cuda.h>

#include "attn_tile.cuh"   // HD, quad_max, quad_sum, common.cuh

namespace chipmunk {
namespace sm90 {

constexpr int KT = 128;          // keys per tile
constexpr int BOX_ROW = 128;     // bytes per row of a 64-wide box

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

}  // namespace sm90
}  // namespace chipmunk
