// Dense GEMM probe: C = A @ B with A [M, K] and B [K, N] row-major,
// int8 x int8 -> int32 and bf16 x bf16 -> f32.
//
// Replaces (TPU reference, Pallas): scripts/bench_int8_mxu.py:48 (_pk,
// one 512 x 512 output block per grid step), which asked whether the v5e
// matrix unit runs int8 at twice the bf16 rate before the int8-activation
// MLP was built.  Here it asks the same of wgmma on Hopper, through the
// template every sparse-MLP kernel of the port runs on (gemm_sm90.cuh:
// TMA ring, warp-specialised, 24 / 240 / 240 registers).
//
// Bound on the H100: operations.  At 4096 x 3072 x 4096 it is 103 GOP:
// 0.052 ms at 1979 TOP/s (int8), 0.104 ms at 989 TFLOP/s (bf16), against
// 25-117 MB of operands and result (~0.01-0.04 ms).
//
// bf16 (ProbeBf16): a CTA computes 128 rows x 256 columns of C; A's rows
// are K-major boxes, B is read where it lies, MN-major (B_MN: four boxes
// of [64 k rows][64 columns] a stage, wgmma's transpose-B flag), as the
// bf16 mm2 reads w2.  64 k a stage, four stages.
//
// s8 (ProbeS8): s8 wgmma reads its shared-memory operand K-major only,
// and a row-major [K, N] B is not.  So the product is taken transposed,
// C^T = B^T A^T: A's rows are the K-major B operand (a stage: 256 rows of
// A x 128 k), and B's bytes, in raw TMA boxes of [128 k rows][128
// columns], become the register A operand.  The s8 m64k32 fragment wants
// 4 consecutive k of one column in a register; one ldmatrix.trans a
// k-step gives each thread two k pairs of two neighbouring columns, which
// PRMT merges (the route of Mm2A8W4 in csp_mlp.cu, without its nibble
// planes): fragment rows g and g + 8 of a warp are its columns 2 g and
// 2 g + 1.  A CTA computes 128 columns x 256 rows of C, two fragment sets
// alternating, and stores C^T's accumulator transposed back into C's rows
// (each thread two neighbouring columns a row: one 8-byte store).
//
// Rows past M, columns past N and k past K come in as TMA's zeros and are
// not stored, so M and N need only be multiples of 128 (the wrapper's
// check) and K of 16 bytes.
#include "gemm_sm90.cuh"

using namespace chipmunk;
using namespace chipmunk::sm90;

namespace {

struct ProbeBf16 {
  static constexpr int BN = 256, ST = 4, EXTRA = 0;
  static constexpr bool B_MN = true;
  struct Params {
    float* c;
    int M, N, K;
  };
  const Params& p;
  int m0, n0;

  __device__ ProbeBf16(const Params& p_) : p(p_) {
    m0 = blockIdx.x * GM;
    n0 = blockIdx.y * BN;
  }
  __device__ bool live() const { return true; }
  __device__ void idle() const {}
  __device__ int tiles() const { return (p.K + 63) / 64; }
  __device__ void side_load(uint32_t, uint32_t) const {}
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    ka = 64 * i;
    ra = m0;
    kb = n0;
    rb = 64 * i;
  }
  __device__ bool restart(int) const { return false; }
  __device__ bool flush(int) const { return false; }
  __device__ void issued(int, int) {}
  template <int A>
  __device__ void after(int, float (&)[A], int) {}
  template <int A>
  __device__ void begin(float (&)[A], int, unsigned char*, uint32_t) {}
  // acc[4 j + 2 h + e]: row 64 c + 16 warp + g + 8 h, column 8 j + 2 t + e
  template <int A>
  __device__ void end(float (&acc)[A], int c, unsigned char*, unsigned char*,
                      uint32_t) {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int col = n0 + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + 64 * c + 16 * warp + (lane >> 2) + 8 * h;
      if (m >= p.M) continue;
      float* row = p.c + (size_t)m * p.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (col + 8 * j < p.N)
          *reinterpret_cast<float2*>(row + col + 8 * j) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
};

struct ProbeS8 {
  static constexpr int BN = 256;                // rows of A: wgmma's N
  static constexpr int RAW = 128 * 128, EVERY = 1, MT = 1, ST = 4, RS = 4;
  static constexpr int EXTRA = 0;
  static constexpr bool B_MN = false, CONVERT = false;
  struct Params {
    int* c;
    int M, N, K;
  };
  const Params& p;
  int n0, m0;

  __device__ ProbeS8(const Params& p_) : p(p_) {
    n0 = blockIdx.x * 128;
    m0 = blockIdx.y * BN;
  }
  __device__ bool live() const { return true; }
  __device__ void idle() const {}
  __device__ int tiles() const { return (p.K + GK - 1) / GK; }
  __device__ void side_load(uint32_t, uint32_t) const {}
  __device__ void coords(int i, int& ka, int& ra, int& kb, int& rb) const {
    kb = i * GK;
    rb = m0;
    ka = ra = 0;
  }
  // B's k rows [128 i, 128 i + 128), columns [n0, n0 + 128)
  __device__ void raw_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                           int i) const {
    tma_load(dst, map, bar, n0, i * GK, 0);
  }
  // lane 8 mi + 2 u + b addresses k row 16 (mi / 2) + 4 u + 2 s + b, s =
  // (mi % 2) ^ (u >= 2), of the warp's 16 columns; thread (g, t) then
  // holds in v[2 h], v[2 h + 1] the k pairs (4 t, 4 t + 1) and (4 t + 2,
  // 4 t + 3) of k half h (swapped for t >= 2) of columns 16 warp + 2 g
  // (low byte of each pair) and + 1, which PRMT sorts into the fragment
  // words of rows g (column 2 g) and g + 8 (column 2 g + 1)
  __device__ void a_frag(int, int c, const unsigned char* raw,
                         uint32_t (&af)[1][4][4]) const {
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
        af[0][kk][2 * h] = __byte_perm(v[2 * h], v[2 * h + 1], sel_e);
        af[0][kk][2 * h + 1] = __byte_perm(v[2 * h], v[2 * h + 1], sel_o);
      }
    }
  }
  __device__ bool restart(int) const { return false; }
  __device__ bool flush(int) const { return false; }
  __device__ void issued(int, int) {}
  template <int A>
  __device__ void after(int, int (&)[A], int) {}
  template <int A>
  __device__ void begin(int (&)[A], int, unsigned char*, uint32_t) {}
  // acc[4 j + 2 h + e]: C^T row (column of C) n0 + 64 c + 16 warp + 2 g +
  // h, C^T column (row of C) m0 + 8 j + 2 t + e
  template <int A>
  __device__ void end(int (&acc)[A], int c, unsigned char*, unsigned char*,
                      uint32_t) {
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int col = n0 + 64 * c + 16 * warp + 2 * (lane >> 2);
    const int mb = m0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = mb + 8 * j + e;
        if (m < p.M)
          *reinterpret_cast<int2*>(p.c + (size_t)m * p.N + col) =
              make_int2(acc[4 * j + e], acc[4 * j + 2 + e]);
      }
  }
};

}  // namespace

extern "C" int chipmunk_int8_probe_s8(const void* a, const void* b, void* c,
                                      int M, int K, int N, void* stream) {
  if (M < 1 || N < 1 || K < 1 || M % 128 || N % 128 || K % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = make_byte_map(&ta, b, K, N, 128);         // raw boxes of B
  if (err == 0) err = make_byte_map(&tb, a, M, K, ProbeS8::BN);
  if (err != 0) return err;
  const ProbeS8::Params p{(int*)c, M, N, K};
  return launch_gemm<int8_t, ProbeS8>(
      ta, tb, p, dim3(N / 128, (M + ProbeS8::BN - 1) / ProbeS8::BN),
      (cudaStream_t)stream);
}

extern "C" int chipmunk_int8_probe_bf16(const void* a, const void* b, void* c,
                                        int M, int K, int N, void* stream) {
  if (M < 1 || N < 1 || K < 1 || M % 128 || N % 128 || K % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  int err = make_byte_map(&ta, a, M, 2LL * K, GM, 2);
  if (err == 0) err = make_byte_map(&tb, b, K, 2LL * N, 64, 2);
  if (err != 0) return err;
  const ProbeBf16::Params p{(float*)c, M, N, K};
  return launch_gemm<__nv_bfloat16, ProbeBf16>(
      ta, tb, p, dim3(M / GM, (N + ProbeBf16::BN - 1) / ProbeBf16::BN),
      (cudaStream_t)stream);
}
