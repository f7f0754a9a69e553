// Column-sparse attention: each 128-row query group attends, with an exact
// softmax, only over its selected kv_block-token KV blocks.
//
// Replaces (TPU reference, Pallas):
//   csp_attn (mode 'vmem') <- chipmunk_tpu/kernels/csp_attention.py:102
//                             (_csp_vmem_kernel)
//
// Bound on the H100: operations for the FLUX shape.  A group reads
// counts[g] * kv_block keys (6 blocks of 128 at top_keys = 0.165), so a
// call is 4 * 128 * sum(counts * kv_block) * D * H FLOP (~41 GFLOP when
// every group takes jmax = 6 blocks) while the inputs are the same ~107 MB
// as dense attention; the floor is ~0.04 ms either way, and the gather
// re-reads K/V blocks from L2 rather than HBM (all of a head's K/V,
// 2.2 MB, fits the 50 MB L2 many times over).
//
// Design: the TPU kernel stages a whole K/V head in VMEM and gathers
// blocks with local DMAs; there is no such room here, so one block owns
// one (head, query group), reads its own index row (no scalar prefetch
// on this card), and streams the selected blocks through the two-stage
// cp.async ring of attn_tile.cuh in 64- (or 32-) key tiles, with its
// online softmax.
// Positions past counts[g] are never visited; keys at or past kv_valid
// are masked.  The output is fresh; the module adds the delta cache.
#include "attn_tile.cuh"

using namespace chipmunk;

namespace {

struct NoHook {
  __device__ void operator()(int, float (*)[4]) const {}
};

template <int KT>
__global__ void __launch_bounds__(256)
csp_attn_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const int* __restrict__ inds, const int* __restrict__ counts,
                __nv_bfloat16* __restrict__ o, int Sq, int Sk, int jmax,
                int kv_block, int kv_valid, float tau) {
  constexpr int NW = 8;
  extern __shared__ __align__(16) unsigned char smem[];
  KVStage<KT>* ring = reinterpret_cast<KVStage<KT>*>(smem);
  const int bh = blockIdx.y, grp = blockIdx.x, G = gridDim.x;
  const int row0 = grp * NW * 16 + (threadIdx.x >> 5) * 16;
  q += (size_t)bh * Sq * HD;
  k += (size_t)bh * Sk * HD;
  v += (size_t)bh * Sk * HD;
  const int* row_inds = inds + ((size_t)bh * G + grp) * jmax;
  const int per_block = kv_block / KT;
  const int n_tiles = counts[(size_t)bh * G + grp] * per_block;
  WarpRows w;
  init_rows(w, q, row0, Sq);
  attend<KT, NW * 32>(
      w, ring, k, v, Sk, n_tiles,
      [&](int i) {
        return row_inds[i / per_block] * kv_block + (i % per_block) * KT;
      },
      kv_valid, tau, NoHook());
  finish_rows(w, o + (size_t)bh * Sq * HD, nullptr, row0, Sq);
}

template <int KT>
int launch(const void* q, const void* k, const void* v, const void* inds,
           const void* counts, void* o, int BH, int Sq, int Sk, int jmax,
           int kv_block, int kv_valid, float tau, cudaStream_t st) {
  constexpr int SMEM = kv_ring_bytes<KT>();
  static const int attr = allow_smem(csp_attn_kernel<KT>, SMEM);
  if (attr != 0) return attr;
  csp_attn_kernel<KT><<<dim3(Sq / 128, BH), 256, SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const int*)inds, (const int*)counts,
      (__nv_bfloat16*)o, Sq, Sk, jmax, kv_block, kv_valid, tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chipmunk_csp_attn(const void* q, const void* k, const void* v,
                                 const void* inds, const void* counts, void* o,
                                 int BH, int Sq, int Sk, int jmax, int kv_block,
                                 int kv_valid, float tau, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (kv_block % 64 == 0)
    return launch<64>(q, k, v, inds, counts, o, BH, Sq, Sk, jmax, kv_block,
                      kv_valid, tau, st);
  if (kv_block == 32)
    return launch<32>(q, k, v, inds, counts, o, BH, Sq, Sk, jmax, kv_block,
                      kv_valid, tau, st);
  return (int)cudaErrorInvalidValue;
}
