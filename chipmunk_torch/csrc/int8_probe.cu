// Dense tile GEMM probe: C = A @ B with A [M, K] and B [K, N] row-major,
// int8 x int8 -> int32 and bf16 x bf16 -> f32.
//
// Replaces (TPU reference, Pallas): scripts/bench_int8_mxu.py:48 (_pk,
// one 512 x 512 output block per grid step), which asked whether the v5e
// matrix unit runs int8 at twice the bf16 rate before the int8-activation
// MLP was built.  Here it asks the same of mma.sync on Hopper: the s8 probe
// runs the s8 tile code of gemm_tile.cuh (ldmatrix of k-contiguous rows,
// B staged through registers and byte-transposed), the bf16 probe the
// bf16 tile code (ldmatrix.trans of B).
//
// Bound on the H100: operations.  At 4096 x 3072 x 4096 it is 103 GOP:
// 0.052 ms at 1979 TOP/s (int8), 0.104 ms at 989 TFLOP/s (bf16), against
// 25-117 MB of operands and result (~0.01-0.04 ms).
#include "gemm_tile.cuh"

using namespace chipmunk;
using namespace chipmunk::tile;

namespace {

// grid (M / 128, N / 128); each warp a 64 x 32 patch of int32
__global__ void __launch_bounds__(NT)
probe_s8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                int* __restrict__ c, int K, int N) {
  using Stage = StageS8T<128>;
  const int r0 = blockIdx.x * 128, c0 = blockIdx.y * BN8;
  __shared__ __align__(16) Stage buf[2];
  uint32_t breg[2][4];
  int acc[4][4][4] = {};
  k_loop_staged(
      buf, K / BK8,
      [&](int kt, Stage& st) {
        issue_rows8<128>(st.a, a + (size_t)r0 * K + kt * BK8, K);
      },
      [&](int kt) { load_kn8(breg, b + (size_t)kt * BK8 * N + c0, N); },
      [&](Stage& st) { store_kn8(breg, st.b); },
      [&](const Stage& st) { mma_stage_s8<4, 4>(acc, st.a, st.b); },
      [](int) {});
  for_each_pair_s8<4, 4>([&](int mt, int nt, int h, int row, int col) {
    *reinterpret_cast<int2*>(c + (size_t)(r0 + row) * N + c0 + col) =
        make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  });
}

// grid (M / 128, N / 128)
__global__ void __launch_bounds__(NT)
probe_bf16_kernel(const __nv_bfloat16* __restrict__ a,
                  const __nv_bfloat16* __restrict__ b, float* __restrict__ c,
                  int K, int N) {
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  extern __shared__ __align__(16) unsigned char smem[];
  float acc[4][4][4] = {};
  k_loop(reinterpret_cast<Stage2*>(smem), K / BK,
         [&](int kt, Stage2& st) {
           issue_rows(st.a, a + (size_t)r0 * K + kt * BK, K);
           issue_krows(st.b, b + (size_t)kt * BK * N + c0, N);
         },
         [&](const Stage2& st) { mma_stage<false>(acc, st.a, st.b); });
  for_each_pair([&](int mt, int nt, int h, int row, int col) {
    *reinterpret_cast<float2*>(c + (size_t)(r0 + row) * N + c0 + col) =
        make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  });
}

}  // namespace

extern "C" int chipmunk_int8_probe_s8(const void* a, const void* b, void* c,
                                      int M, int K, int N, void* stream) {
  dim3 grid(M / 128, N / BN8);
  probe_s8_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const int8_t*)a, (const int8_t*)b, (int*)c, K, N);
  return (int)cudaGetLastError();
}

extern "C" int chipmunk_int8_probe_bf16(const void* a, const void* b, void* c,
                                        int M, int K, int N, void* stream) {
  constexpr int SMEM = STAGES * (int)sizeof(Stage2);
  static const int attr = (int)cudaFuncSetAttribute(
      probe_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != 0) return attr;
  dim3 grid(M / BM, N / BN);
  probe_bf16_kernel<<<grid, NT, SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)c, K, N);
  return (int)cudaGetLastError();
}
