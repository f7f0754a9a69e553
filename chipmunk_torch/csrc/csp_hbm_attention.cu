// Column-sparse attention over packed K+V blocks gathered from device
// memory: each 128-row query group attends, with its softmax in log2
// domain, only over the counts[g] key blocks listed in inds[g].
//
// Replaces (TPU reference, Pallas):
//   csp_attn (mode 'hbm') <- chipmunk_tpu/kernels/csp_attention.py:193
//                            (_csp_hbm_packed_kernel)
//
// Layout: kv is [B*H, nb, 2*kv_block, D]: the kv_block K rows of a block,
// then its kv_block V rows (the reference's pack, one copy outside the
// kernel).  So a selected block is one contiguous 2*kv_block*D run --
// 64 KB at kv_block 128 -- and arrives in one commit group of 16-byte
// cp.async copies into one stage of a two-stage shared-memory ring.
//
// Bound on the H100: operations.  A (group, block) pair is
// 4 * 128 * kv_block * D FLOP (8.4 MFLOP at kv_block 128); at the
// HunyuanVideo 540p shape (24 heads x 528 groups, ~34 selected blocks per
// group) a call is ~3.6 TFLOP, ~3.7 ms at 989 TFLOP/s, while q, the
// packed K+V and o are ~1.7 GB read or written once, ~0.5 ms at
// 3.35 TB/s.  The gather itself re-reads each block once per group that
// selects it (64 KB for 8.4 MFLOP, 128 FLOP/byte), so it must come from
// L2 (a head's K+V is 34.6 MB) for the tensor cores to set the pace.
//
// Design: the TPU kernel gathers a group's jmax blocks into a VMEM
// scratch and takes an exact softmax over the whole row; a group's gather
// at 540p (jmax 44) is 2.8 MB, far beyond a block's 227 KB here.  So one
// CTA owns one (query group, head), the group index fastest, so that the
// CTAs resident at one time share a head and its blocks stay in L2; it
// reads its own index row, streams the selected blocks through the ring
// (block i + 1 in flight while block i is in the tensor cores), and keeps
// an online softmax in registers (attn_tile.cuh: mma.sync bf16, ldmatrix,
// 64- or 32-key sub-tiles with padded rows).  Positions past counts[g] are
// never visited; keys at or past kv_valid are masked; a row with no valid
// key returns 0.  The output is fresh; the module adds the delta cache.
// Later work: cp.async.bulk/TMA with an mbarrier and wgmma.
#include "attn_tile.cuh"

using namespace chipmunk;

namespace {

// One kv_block = KT * SUBS keys, held as SUBS sub-tiles of KT keys.
template <int KT, int SUBS>
struct BlockStage {
  KVStage<KT> sub[SUBS];
};

// Start copying one packed block into a stage: K row r goes to
// sub[r / KT].k, V row r to sub[r / KT].v.
template <int KT, int SUBS, int NT>
__device__ __forceinline__ void issue_block(BlockStage<KT, SUBS>& st,
                                            const __nv_bfloat16* blk) {
  constexpr int KB = KT * SUBS, CH = HD / 8;
  for (int i = threadIdx.x; i < 2 * KB * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const int kr = r % KB;
    KVStage<KT>& sub = st.sub[kr / KT];
    __nv_bfloat16* dst = (r < KB ? sub.k : sub.v) + (kr % KT) * LDK + c;
    cp_async16(dst, blk + (size_t)r * HD + c, true);
  }
}

template <int KT, int SUBS>
__global__ void __launch_bounds__(256)
csp_hbm_attn_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kv,
                    const int* __restrict__ inds,
                    const int* __restrict__ counts,
                    __nv_bfloat16* __restrict__ o, int Sq, int nb, int jmax,
                    int kv_valid, float tau) {
  constexpr int NW = 8, NT = NW * 32, KB = KT * SUBS;
  constexpr size_t BLK = (size_t)2 * KB * HD;   // elements of a packed block
  extern __shared__ __align__(16) unsigned char smem[];
  BlockStage<KT, SUBS>* ring = reinterpret_cast<BlockStage<KT, SUBS>*>(smem);
  const int bh = blockIdx.y, grp = blockIdx.x, G = gridDim.x;
  const int row0 = grp * NW * 16 + (threadIdx.x >> 5) * 16;
  q += (size_t)bh * Sq * HD;
  kv += (size_t)bh * nb * BLK;
  const int* row_inds = inds + ((size_t)bh * G + grp) * jmax;
  const int n = counts[(size_t)bh * G + grp];
  WarpRows w;
  init_rows(w, q, row0, Sq);
  if (n > 0) issue_block<KT, SUBS, NT>(ring[0], kv + row_inds[0] * BLK);
  cp_async_commit();
  for (int i = 0; i < n; ++i) {
    if (i + 1 < n)
      issue_block<KT, SUBS, NT>(ring[(i + 1) & 1],
                                kv + row_inds[i + 1] * BLK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int key0 = row_inds[i] * KB;
#pragma unroll
    for (int t = 0; t < SUBS; ++t) {
      float s[KT / 8][4];
      tile_scores<KT>(s, w, ring[i & 1].sub[t], tau, key0 + t * KT, kv_valid);
      tile_update<KT>(w, s, ring[i & 1].sub[t]);
    }
    __syncthreads();   // the stage is refilled two blocks later
  }
  finish_rows(w, o + (size_t)bh * Sq * HD, nullptr, row0, Sq);
}

template <int KT, int SUBS>
int launch(const void* q, const void* kv, const void* inds, const void* counts,
           void* o, int BH, int Sq, int nb, int jmax, int kv_valid, float tau,
           cudaStream_t st) {
  constexpr int SMEM = 2 * (int)sizeof(BlockStage<KT, SUBS>);
  static const int attr = allow_smem(csp_hbm_attn_kernel<KT, SUBS>, SMEM);
  if (attr != 0) return attr;
  csp_hbm_attn_kernel<KT, SUBS><<<dim3(Sq / 128, BH), 256, SMEM, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)kv, (const int*)inds,
      (const int*)counts, (__nv_bfloat16*)o, Sq, nb, jmax, kv_valid, tau);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chipmunk_csp_hbm_attn(const void* q, const void* kv,
                                     const void* inds, const void* counts,
                                     void* o, int BH, int Sq, int nb,
                                     int jmax, int kv_block, int kv_valid,
                                     float tau, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (kv_block) {
    case 128:
      return launch<64, 2>(q, kv, inds, counts, o, BH, Sq, nb, jmax,
                           kv_valid, tau, st);
    case 64:
      return launch<64, 1>(q, kv, inds, counts, o, BH, Sq, nb, jmax,
                           kv_valid, tau, st);
    case 32:
      return launch<32, 1>(q, kv, inds, counts, o, BH, Sq, nb, jmax,
                           kv_valid, tau, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
