// The attention inputs of a FLUX-architecture block in one pass: the qkv
// bias, the head split, the per-head RMSNorm of q and k, their interleaved
// RoPE and the write of each stream into the joint sequence.
//
// Replaces no TPU kernel: the reference leaves this chain to XLA, which
// fuses it.  Eager PyTorch runs it as ~30 launches a stream, most of them
// on strided views in float32 (models/layers.py rmsnorm, apply_rope), so
// it was added to move the chain's bytes once.
//
//   streams i = 0, 1 (in joint order; a single block passes one):
//     y_i [B, S_i, 3, H, D] bf16, the qkv GEMM's output without its bias;
//     bias_i [3 H D] bf16 or null; qs_i, ks_i [D] bf16 the norm scales
//   cos, sin [Bc, 1, S, D/2] f32 (Bc = 1 or B), S = S_0 + S_1
//   q, k, v [B, H, S, D] bf16: stream i's token t goes to joint row
//     off_i + t (off_0 = 0, off_1 = S_0)
//
// Numerics: the plain version's rounding points (qkv_prologue_plain),
// every product and sum rounded on its own (the _rn intrinsics keep nvcc
// from contracting them into FMAs, as PyTorch's separate elementwise
// kernels never do):
//   a    = bf16(y + bias)                               (v stops here)
//   r    = rsqrt(float(mean(a * a)) + 1e-6)             per head of q, k
//   t    = bf16(bf16(a * r) * scale)
//   out  = bf16(t0 * cos - t1 * sin), bf16(t0 * sin + t1 * cos)
//          for each interleaved pair (t0, t1) = (t[2p], t[2p+1])
// The one difference left is the order of the D-term sum of squares.
//
// Bound on the H100: bytes.  A token reads its 3 H D values and writes
// them once: 6 H D bytes each way, 160 MB a block at FLUX (H 24, D 128,
// 4352 tokens), 48 us at 3.35 TB/s; the bias, scales and cos/sin come
// from L2.
//
// Design: three warps a token (row-parallel), each a third of its 3H
// heads (q, k or v at H even); 16 lanes a head of 128, each lane 8 values
// (one 16-byte load and store), so a warp instruction covers two heads.
// The token's cos/sin (4 pairs a lane) and the stream's scales stay in
// registers across the warp's heads; the sum of squares is a butterfly
// over the head's lanes.  U head groups are loaded before any is used:
// splitting a token over three warps keeps each warp's chain of dependent
// load rounds short (one warp a token chains nine), and a small U keeps
// the registers low enough for many warps an SM, so that more tokens'
// loads are in flight than one warp's deep unroll would give.
// No shared memory, no synchronisation, no allocation; y is read once,
// with the streaming hint; the launch goes on the caller's stream (a
// CUDA-graph capture takes it).
#include "common.cuh"

using namespace chipmunk;

namespace {

struct Stream {
  const __nv_bfloat16* y;      // [B, S, 3 H D]
  const __nv_bfloat16* bias;   // [3 H D] or null
  const __nv_bfloat16* qs;     // [D]
  const __nv_bfloat16* ks;     // [D]
  int S;
};

constexpr int D = 128;         // head dim (the attention kernels' own)
constexpr int WARPS = 4;       // tokens a CTA
constexpr int P = 3;           // warps a token, each a third of its heads
constexpr int U = 4;           // head groups loaded ahead

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// eight bf16 (low half first) as floats, exactly, by shifts: no address
// of a register is taken
__device__ __forceinline__ void unpack8(const uint4& u, float f[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                    pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
}

__global__ void __launch_bounds__(WARPS * 32)
qkv_norm_rope_kernel(Stream s0, Stream s1, const float* __restrict__ cos,
                     const float* __restrict__ sin, int cos_b,
                     __nv_bfloat16* __restrict__ q,
                     __nv_bfloat16* __restrict__ k,
                     __nv_bfloat16* __restrict__ v, int B, int H) {
  constexpr int LPH = D / 8;          // lanes a head
  constexpr int HPW = 32 / LPH;       // heads a warp instruction
  const int S = s0.S + s1.S;
  const int warp = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int row = warp / P, part = warp % P;
  if (row >= B * S) return;           // whole warps
  const int lane = threadIdx.x & 31, sub = lane % LPH, hw = lane / LPH;
  const int b = row / S, j = row % S;
  // the token's stream, field by field (a reference to either parameter
  // would put both in local memory)
  const bool first = j < s0.S;
  const int t = first ? j : j - s0.S, St = first ? s0.S : s1.S;
  const __nv_bfloat16* y = first ? s0.y : s1.y;
  const __nv_bfloat16* bias = first ? s0.bias : s1.bias;
  const int W = 3 * H * D, NH = 3 * H, NG = (NH + HPW - 1) / HPW;
  const int gb = part * NG / P, ge = (part + 1) * NG / P;   // its groups
  const __nv_bfloat16* yr = y + ((size_t)b * St + t) * W + sub * 8;
  const __nv_bfloat16* br = bias ? bias + sub * 8 : nullptr;

  const size_t cr = ((size_t)b * cos_b * S + j) * (D / 2) + sub * 4;
  const float4 c4 = *reinterpret_cast<const float4*>(cos + cr);
  const float4 s4 = *reinterpret_cast<const float4*>(sin + cr);
  const float cs[4] = {c4.x, c4.y, c4.z, c4.w};
  const float sn[4] = {s4.x, s4.y, s4.z, s4.w};
  const uint4 qsu = __ldg(reinterpret_cast<const uint4*>(
      (first ? s0.qs : s1.qs) + sub * 8));
  const uint4 ksu = __ldg(reinterpret_cast<const uint4*>(
      (first ? s0.ks : s1.ks) + sub * 8));

  for (int g0 = gb; g0 < ge; g0 += U) {
    uint4 raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int head = (g0 + u) * HPW + hw;
      raw[u] = g0 + u < ge && head < NH
                   ? __ldcs(reinterpret_cast<const uint4*>(yr + head * D))
                   : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (g0 + u >= ge) break;        // the same for the whole warp
      const int head = (g0 + u) * HPW + hw;
      float a[8];
      unpack8(raw[u], a);
      if (br && head < NH) {         // the bias: every token's, from L1
        float c[8];
        unpack8(__ldg(reinterpret_cast<const uint4*>(br + head * D)), c);
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = bf16r(__fadd_rn(a[i], c[i]));
      }
      float ss = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) ss = __fadd_rn(ss, __fmul_rn(a[i], a[i]));
#pragma unroll
      for (int o = LPH / 2; o; o >>= 1)
        ss = __fadd_rn(ss, __shfl_xor_sync(~0u, ss, o));
      if (head >= NH) continue;
      const int sec = head / H, h = head % H;     // q, k or v; its head
      const size_t out = (((size_t)b * H + h) * S + j) * D + sub * 8;
      if (sec == 2) {
        *reinterpret_cast<uint4*>(v + out) = pack8(a);
        continue;
      }
      const float r =
          rsqrtf(__fadd_rn(__fmul_rn(ss, 1.0f / (float)D), 1e-6f));
      float sc[8], o8[8];
      unpack8(sec == 0 ? qsu : ksu, sc);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float x0 = bf16r(__fmul_rn(bf16r(__fmul_rn(a[2 * p], r)),
                                         sc[2 * p]));
        const float x1 = bf16r(__fmul_rn(bf16r(__fmul_rn(a[2 * p + 1], r)),
                                         sc[2 * p + 1]));
        o8[2 * p] = __fsub_rn(__fmul_rn(x0, cs[p]), __fmul_rn(x1, sn[p]));
        o8[2 * p + 1] = __fadd_rn(__fmul_rn(x0, sn[p]), __fmul_rn(x1, cs[p]));
      }
      *reinterpret_cast<uint4*>((sec == 0 ? q : k) + out) = pack8(o8);
    }
  }
}

}  // namespace

// Streams whose S is 0 are never read.  The head dim is 128 and every
// pointer 16-byte aligned (the wrapper checks both).
extern "C" int chipmunk_qkv_prologue(
    const void* y0, const void* b0, const void* qs0, const void* ks0,
    const void* y1, const void* b1, const void* qs1, const void* ks1,
    const void* cos, const void* sin, void* q, void* k, void* v, int B,
    int S0, int S1, int H, int cos_b, void* stream) {
  using bf = const __nv_bfloat16*;
  const long warps = (long)B * (S0 + S1) * P;
  if (B < 0 || S0 < 0 || S1 < 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (warps == 0) return 0;
  qkv_norm_rope_kernel<<<(unsigned)((warps + WARPS - 1) / WARPS), WARPS * 32,
                         0, (cudaStream_t)stream>>>(
      Stream{(bf)y0, (bf)b0, (bf)qs0, (bf)ks0, S0},
      Stream{(bf)y1, (bf)b1, (bf)qs1, (bf)ks1, S1}, (const float*)cos,
      (const float*)sin, cos_b, (__nv_bfloat16*)q, (__nv_bfloat16*)k,
      (__nv_bfloat16*)v, B, H);
  return (int)cudaGetLastError();
}
