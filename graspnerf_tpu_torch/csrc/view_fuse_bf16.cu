// IBRNet-NeuS view fuse, forward, bfloat16, on the tensor cores (sm_90a).
//
// Replaces: graspnerf_tpu/ops/pallas/ibrnet_fuse.py `_kernel` (:115-184)
// with dtype=bfloat16, launched by `_view_fuse_pallas` (:187-228): bf16
// operands of every product (:132-136), the bf16 input tile (:190-192),
// bf16 x | vis (:221-227). Its plain version is ops/view_fuse.py
// `view_fuse_plain(..., torch.bfloat16)`. Per row n and view v (V = 6):
//   ray_dir_fc 4->16->35 residual on rgbf (rf); neuray_fc 32->8->1 sigmoid
//   times the mask-normalised weight (w0); two weighted mean/var passes over
//   the views (gf, 140 channels); base_fc 207->64->32 (x); vis_fc 32->32->33
//   (x += xv[:32], visibility logit); vis_fc2 32->32->1 (vis); renormalised
//   weights -> feat_const [N,65] (bf16), num_valid [N] (float32, exact),
//   x [V,N,32] and vis [V,N] (bf16).
//
// Bound: bytes. 71,120 multiply-adds a row (9.1 GFLOP at N = 64,000, ~0.01
// ms at the bf16 tensor-core rate) against 2 * (72 * 6 + 65 + 33 * 6) + 4
// bytes a row (89 MB, 0.027 ms at 3.35 TB/s). About 254 exponentials a
// row-view (ELU, sigmoid) take the special-function units ~0.026 ms.
//
// Design.
// - Every product is mma.sync.m16n8k16 (bf16 x bf16, float32 accumulate),
//   which is what the Pallas kernel's bf16 dot with float32 accumulation
//   computes, up to summation order. K is padded with zeros to 16, N to 8.
// - A warp owns a slab of R = 16 rows of one view; the six warps of a group
//   (one per view) share the slab's rows. The float32 C fragment of an
//   m16n8 product holds rows lane/4 and lane/4 + 8, columns 2(lane%4) and
//   +1; two adjacent n8 tiles of it are the A fragment of one k16 step of
//   the next product. So each per-view MLP chain (bias, ELU / sigmoid, the
//   per-row scales x * weight and x * vis1, the residuals, the rounding of
//   each operand to bf16) runs on the fragments in registers and never
//   touches shared memory.
// - Shared memory and a barrier of the group (bar.sync over its 6 warps,
//   one id per group) only where the views meet: (B0) the slab's inputs
//   arrived, from which each warp forms mask -> weight and num_valid for
//   its rows; (B1) rf and w0 of every view written -> (B2) gf (mean0 | var0
//   | mean1 | var1, float32, stored rounded to bf16) -> (B3) base_fc.0's gf
//   block, one m16 x n64 x k144 product per slab (not per view), split over
//   the warps by n tile, whose float32 result initialises each view's
//   base_fc.0 accumulators (the 207-wide sum split in two: only its order
//   changes) -> (B4) x and vis of every view written -> w2, feat_const and
//   the x rows, then (B5) the feat_const rows, staged, go out. Six group
//   barriers a slab of 16 rows; the other groups of the SM run while one
//   waits.
// - Weights: once per block in shared memory, bf16, in the order the B
//   fragments are read (one 8-byte load per fragment and lane, no bank
//   conflict); biases float32. The pack is ops/view_fuse.py
//   `pack_weights_bf16` (view_fuse_bf16_pack_elems() elements).
// - Tile I/O: each view's 16 rows of each input are one contiguous block,
//   copied with 16-byte cp.async into shared memory as bf16 (one buffer a
//   group: slab s + 1's copy is issued once slab s's chains have read their
//   inputs, and lands during its feat_const phase; kInBuffers = 2 double
//   buffers). Misaligned inputs or N % 8 != 0 take element loads into the
//   same layout. x [V,N,32] goes out in 16-byte chunks of a row-view,
//   feat_const [N,65] as the slab's whole 16-byte chunks then the ragged
//   rest, vis and num_valid an element at a time.
// - Occupancy: one 768-thread block per SM of four groups (24 warps), the
//   weights once (43.6 KB) and ~41 KB a group, 208.6 KB in all; 79
//   registers a thread, no spills.
// - Per-row weights and w2 multiply by a correctly rounded reciprocal
//   (__frcp_rn): IEEE divisions made it ~9 % slower; for a mask of 0 or 1
//   the weight is the division's bit for bit. ELU is exp(x) - 1 and sigmoid
//   1 / (1 + exp(-x)) on ex2.approx.ftz.
// What holds it back (tools/view_fuse_phases.py --bf16 --ablations on an
// H100 80GB HBM3 at 700 W: 0.111 ms at N = 64,000, 24 % of its bound): no
// single cost. Builds without the exponentials, without the tensor-core
// products or without the input reads are 5 %, 10 % and 6 % faster; the
// rest is instruction issue and the latency of each slab's serial phases
// (per-view chains ~38 % of a slab's cycles, rf / w0 ~17 %, feat_const
// ~18 %, gf and its block ~22 %). Two blocks of one group come within 4 %
// of four groups an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int V = 6;
constexpr int R = 16;                    // rows per slab: one m16 tile
constexpr int kGroups = 4;               // slab groups per block
constexpr int kBlocksPerSM = 1;          // resident blocks the launch asks for
// input buffers a group: 2, slab s + 1 loads while slab s computes; 1, it
// loads once slab s has read its inputs (after the chains)
constexpr int kInBuffers = 1;
constexpr int kGroupThreads = 32 * V;    // one warp per view
constexpr int kThreads = kGroupThreads * kGroups;
// each layer's A operand staged through shared memory (an ablation of
// tools/view_fuse_phases.py; off: the chains stay in registers)
constexpr bool kStageLayers = false;
// the weight pack copied into each block's shared memory, or read where it
// lies in device memory (through L1)
constexpr bool kWeightsInSmem = true;
constexpr int C_RGBF = 35, C_NEUR = 32, C_DIFF = 4, C_X = 32, C_OUT = 65;
constexpr unsigned kFull = 0xffffffffu;

// The pack's blocks of B fragments: the ten Linear layers in W_NAMES order,
// base_fc.0 split into its gf block (block 4, input channels 0..139) and
// its per-view block (block 5: rf channels 140..174 at k 0..34, neur
// 175..206 at k 48..79, zeros between). K x N padded.
constexpr int kNBlocks = 11;
__host__ __device__ constexpr int blk_k(int b) {
  return b == 0 || b == 1 || b == 3 ? 16 : b == 4 ? 144 : b == 5 ? 80
       : b == 6 ? 64 : 32;
}
__host__ __device__ constexpr int blk_n(int b) {
  return b == 0 ? 16 : b == 1 || b == 8 ? 40 : b == 2 || b == 3 || b == 10 ? 8
       : b == 4 || b == 5 ? 64 : 32;
}
// offset of block b in 8-byte fragments (one per lane, k16 step, n8 tile)
__host__ __device__ constexpr int frag_off(int b) {
  return b == 0 ? 0 : frag_off(b - 1) + blk_k(b - 1) / 16 * blk_n(b - 1) / 8 * 32;
}
constexpr int kWElems = 4 * frag_off(kNBlocks);   // bf16 weights
// float32 bias of Linear l (l = 0..9), N padded as its block's
__host__ __device__ constexpr int bias_n(int l) { return blk_n(l < 4 ? l : l + 1); }
__host__ __device__ constexpr int bias_off(int l) {
  return l == 0 ? 0 : bias_off(l - 1) + bias_n(l - 1);
}
constexpr int kBiasFloats = bias_off(10);
constexpr int kPackElems = kWElems + 2 * kBiasFloats;  // in bf16 elements
constexpr int kPackBytes = 2 * kPackElems;
static_assert(kPackBytes % 16 == 0 && kWElems % 8 == 0, "16-byte pack copy");

// Shared memory of a group, bytes from its base
constexpr int C_IN = C_RGBF + C_NEUR + C_DIFF + 1;      // 72
constexpr int kInRgbf = 0;                              // [V][R][35] bf16
constexpr int kInNeur = kInRgbf + 2 * V * R * C_RGBF;   // [V][R][32]
constexpr int kInDiff = kInNeur + 2 * V * R * C_NEUR;   // [V][R][4]
constexpr int kInMask = kInDiff + 2 * V * R * C_DIFF;   // [V][R]
constexpr int kInBytes = 2 * V * R * C_IN;              // one buffer
constexpr int XS = 20;       // row stride of the exchange's [V][C][XS] floats
constexpr int GS = 152;      // row stride of gf [R][GS] bf16 (k 140..151 zero)
constexpr int OS = 72;       // row stride of the gf block's [R][OS] floats
constexpr int kXch = kInBuffers * kInBytes;             // rf, then x, floats
constexpr int kVecs = kXch + 4 * V * C_RGBF * XS;       // w0 | wt | vis [V][R]
constexpr int kGf = kVecs + 4 * 3 * V * R;
constexpr int kGfo = kGf + 2 * R * GS;
constexpr int kStage = kGfo;     // feat_const [R][65] bf16, once gfo is read
constexpr int kLayerStage = kGfo + 4 * R * OS;          // [V][R][64] bf16
constexpr int kGroupBytes =
    (kLayerStage + (kStageLayers ? 2 * V * R * 64 : 0) + 15) / 16 * 16;
constexpr int kSmemBytes =
    (kWeightsInSmem ? kPackBytes : 0) + kGroups * kGroupBytes;
static_assert(kInNeur % 16 == 0 && kInDiff % 16 == 0 && kInMask % 16 == 0 &&
              kInBytes % 16 == 0 && kStage % 16 == 0, "16-byte copies");
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may take");
static_assert(kGroupThreads % R == 0 && V * R * 4 % kGroupThreads == 0,
              "feat_const and x rows: whole rows of threads");

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }
// two floats rounded to bf16 in one 32-bit word, the first in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// exp(x) as 2^(x log2 e) on the special-function unit, a denormal result
// flushed to zero (ex2.approx.ftz): where exp(x) would be denormal, ELU's
// exp(x) - 1 and sigmoid's 1 + exp(-x) round to the same float32 either
// way, and __expf's rescaling of such results costs ~4 instructions each
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.44269504f));
  return y;
}
__device__ __forceinline__ float elu(float x) {
  return x > 0.0f ? x : exp_ftz(x) - 1.0f;
}
__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.0f, 1.0f + exp_ftz(-x));
}

// d += a * b: m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The group's barrier: its 6 warps, id 1 + group (0 is __syncthreads')
__device__ __forceinline__ void bar_group(int gid) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + gid), "r"(kGroupThreads)
               : "memory");
}

// acc[j] (C fragments of n tile j) = the bias of Linear L at their columns
template <int L, int NT>
__device__ __forceinline__ void init_bias(const float* sB, float (&acc)[NT][4],
                                          int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b =
        *reinterpret_cast<const float2*>(sB + bias_off(L) + 8 * j + 2 * t);
    acc[j][0] = acc[j][2] = b.x;
    acc[j][1] = acc[j][3] = b.y;
  }
}

// acc += A (KT k16 steps) x block B of the pack
template <int B, int KT, int NT>
__device__ __forceinline__ void product(const uint2* sW,
                                        const uint32_t (&a)[KT][4],
                                        float (&acc)[NT][4], int lane) {
  static_assert(KT == blk_k(B) / 16 && NT == blk_n(B) / 8, "block shape");
  const uint2* w = sW + frag_off(B) + lane;
#pragma unroll
  for (int k = 0; k < KT; ++k)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(acc[j], a[k], w[(k * NT + j) * 32]);
}

template <int NT>
__device__ __forceinline__ void elu_all(float (&y)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) y[j][i] = elu(y[j][i]);
}

// C fragments (NT n8 tiles) times a per-row scale (s0 row lane/4, s1 row
// lane/4 + 8), rounded to bf16, as the A fragments of the next product:
// tiles 2k and 2k + 1 are its k16 step k (a missing odd tile is zero).
// kStageLayers routes them through the warp's shared memory instead.
template <int NT>
__device__ __forceinline__ void to_a(const float (&y)[NT][4],
                                     uint32_t (&a)[(NT + 1) / 2][4],
                                     bf16* stage, float s0 = 1.0f,
                                     float s1 = 1.0f) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    a[j / 2][2 * (j % 2)] = pack2(y[j][0] * s0, y[j][1] * s0);
    a[j / 2][2 * (j % 2) + 1] = pack2(y[j][2] * s1, y[j][3] * s1);
  }
  if constexpr (NT % 2) a[NT / 2][2] = a[NT / 2][3] = 0u;
  if constexpr (kStageLayers) {
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < (NT + 1) / 2; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i % 2), c = 16 * k + 8 * (i / 2) + 2 * t;
        *reinterpret_cast<uint32_t*>(stage + r * 64 + c) = a[k][i];
      }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < (NT + 1) / 2; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = g + 8 * (i % 2), c = 16 * k + 8 * (i / 2) + 2 * t;
        a[k][i] = ld32(stage + r * 64 + c);
      }
  }
}

// A fragments of k16 steps K0.. of a bf16 [R][ld] matrix in shared memory
template <int KT>
__device__ __forceinline__ void load_a(const bf16* m, int ld, int g, int t,
                                       uint32_t (&a)[KT][4], int k0 = 0) {
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const bf16* p = m + g * ld + 16 * (k0 + k) + 2 * t;
    a[k][0] = ld32(p);
    a[k][1] = ld32(p + 8 * ld);
    a[k][2] = ld32(p + 8);
    a[k][3] = ld32(p + 8 * ld + 8);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One slab's input of C channels into dst [V][R][C] (bf16): 16-byte
// cp.async chunks of each view's contiguous R rows (zero-filled past N),
// or element loads when `vec` is false.
template <int C>
__device__ __forceinline__ void load_input(bf16* dst, const bf16* src, int n0,
                                           int N, bool vec, int tid) {
  const int live = (N - n0 < R ? N - n0 : R) * C;
  if (vec) {
    constexpr int Q = R * C / 8;                 // chunks per view
#pragma unroll 2
    for (int i = tid; i < V * Q; i += kGroupThreads) {
      const int v = i / Q, e = 8 * (i % Q);
      const bool in = e < live;
      const bf16* s = in ? src + (static_cast<long long>(v) * N + n0) * C + e
                         : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_addr(dst + v * R * C + e)), "l"(s),
                      "r"(in ? 16 : 0) : "memory");
    }
  } else {
    for (int i = tid; i < V * R * C; i += kGroupThreads) {
      const int v = i / (R * C), e = i % (R * C);
      dst[i] = e < live ? src[(static_cast<long long>(v) * N + n0) * C + e]
                        : __float2bfloat16_rn(0.0f);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
view_fuse_bf16_kernel(const bf16* __restrict__ rgbf,
                      const bf16* __restrict__ neur,
                      const bf16* __restrict__ rdiff,
                      const bf16* __restrict__ mask,
                      const uint4* __restrict__ wpack,
                      bf16* __restrict__ feat_const,
                      float* __restrict__ num_valid, bf16* __restrict__ xout,
                      bf16* __restrict__ visout, int N, bool vec) {
  extern __shared__ uint4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const unsigned char* pack = kWeightsInSmem
      ? smem : reinterpret_cast<const unsigned char*>(wpack);
  const uint2* sW = reinterpret_cast<const uint2*>(pack);
  const float* sB = reinterpret_cast<const float*>(pack + 2 * kWElems);
  const int gid = threadIdx.x / kGroupThreads;
  const int tid = threadIdx.x % kGroupThreads;     // thread in the group
  const int v = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  unsigned char* gs =
      smem + (kWeightsInSmem ? kPackBytes : 0) + gid * kGroupBytes;
  float* xch = reinterpret_cast<float*>(gs + kXch);    // [V][C][XS]
  float* w0s = reinterpret_cast<float*>(gs + kVecs);   // [V][R]
  float* wts = w0s + V * R;
  float* viss = wts + V * R;
  bf16* gf = reinterpret_cast<bf16*>(gs + kGf);        // [R][GS]
  float* gfo = reinterpret_cast<float*>(gs + kGfo);    // [R][OS]
  bf16* stage = reinterpret_cast<bf16*>(gs + kStage);  // [R][65]
  bf16* lstage = reinterpret_cast<bf16*>(gs + kLayerStage) + v * R * 64;

  // the weights, once per block; gf's padding columns zero for good
  for (int i = threadIdx.x; kWeightsInSmem && i < kPackBytes / 16;
       i += kThreads)
    smem4[i] = wpack[i];
  for (int i = tid; i < R * GS; i += kGroupThreads)
    gf[i] = __float2bfloat16_rn(0.0f);
  __syncthreads();

  auto inputs = [&](int buf, int slab) {
    unsigned char* in = gs + buf * kInBytes;
    const int n0 = slab * R;
    load_input<C_RGBF>(reinterpret_cast<bf16*>(in + kInRgbf), rgbf, n0, N,
                       vec, tid);
    load_input<C_NEUR>(reinterpret_cast<bf16*>(in + kInNeur), neur, n0, N,
                       vec, tid);
    load_input<C_DIFF>(reinterpret_cast<bf16*>(in + kInDiff), rdiff, n0, N,
                       vec, tid);
    load_input<1>(reinterpret_cast<bf16*>(in + kInMask), mask, n0, N, vec,
                  tid);
  };

  const int nslabs = (N + R - 1) / R;
  const int step = gridDim.x * kGroups;
  int buf = 0;
  if (blockIdx.x * kGroups + gid < nslabs) inputs(0, blockIdx.x * kGroups + gid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int slab = blockIdx.x * kGroups + gid; slab < nslabs; slab += step) {
    const int n0 = slab * R;
    if (kInBuffers == 2 && slab + step < nslabs) inputs(buf ^ 1, slab + step);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kInBuffers - 1)
                 : "memory");
    bar_group(gid);
    const unsigned char* in = gs + buf * kInBytes;
    const bf16* i_rgbf = reinterpret_cast<const bf16*>(in + kInRgbf) + v * R * C_RGBF;
    const bf16* i_neur = reinterpret_cast<const bf16*>(in + kInNeur) + v * R * C_NEUR;
    const bf16* i_diff = reinterpret_cast<const bf16*>(in + kInDiff) + v * R * C_DIFF;
    const bf16* i_mask = reinterpret_cast<const bf16*>(in + kInMask);

    // mask -> num_valid (views in order 0..5, exact) and weight, for rows
    // g and g + 8
    float mk[2], wt[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      float nv = 0.0f;
#pragma unroll
      for (int u = 0; u < V; ++u) nv += bf(i_mask + u * R + r);
      mk[h] = bf(i_mask + v * R + r);
      wt[h] = mk[h] * __frcp_rn(nv + 1e-8f);   // = mk / (.) for mk 0 or 1
      if (v == 0 && t == 0 && n0 + r < N) num_valid[n0 + r] = nv;
    }
    // neuray_fc: 32 -> 8 -> 1, w0 = sigmoid(.) * weight; ray_dir_fc: 4 ->
    // 16 -> 35, rf = rgbf + elu(.). Both chains' operands are read before
    // anything is stored, so that the two interleave.
    float w0[2];
    {
      uint32_t a[2][4];
      load_a(i_neur, C_NEUR, g, t, a);
      float h8[1][4];
      init_bias<2>(sB, h8, t);
      product<2>(sW, a, h8, lane);
      elu_all(h8);
      uint32_t a8[1][4];
      to_a(h8, a8, lstage);
      float o[1][4];
      init_bias<3>(sB, o, t);
      product<3>(sW, a8, o, lane);
      w0[0] = sigm(o[0][0]) * wt[0];   // lanes t == 0: column 0
      w0[1] = sigm(o[0][2]) * wt[1];
    }
    uint32_t rf_a[3][4];
    {
      uint32_t a[1][4] = {{t < 2 ? ld32(i_diff + g * C_DIFF + 2 * t) : 0u,
                           t < 2 ? ld32(i_diff + (g + 8) * C_DIFF + 2 * t) : 0u,
                           0u, 0u}};
      float h16[2][4];
      init_bias<0>(sB, h16, t);
      product<0>(sW, a, h16, lane);
      elu_all(h16);
      to_a(h16, a, lstage);
      float rf[5][4];
      init_bias<1>(sB, rf, t);
      product<1>(sW, a, rf, lane);
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + 8 * (i / 2), c = 8 * j + 2 * t + i % 2;
          rf[j][i] = c < C_RGBF
              ? elu(rf[j][i]) + bf(i_rgbf + r * C_RGBF + c) : 0.0f;
        }
      to_a(rf, rf_a, lstage);
#pragma unroll
      for (int j = 0; j < 5; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = g + 8 * (i / 2), c = 8 * j + 2 * t + i % 2;
          if (c < C_RGBF) xch[(v * C_RGBF + c) * XS + r] = rf[j][i];
        }
    }
    if (t == 0) {
      w0s[v * R + g] = w0[0];
      w0s[v * R + g + 8] = w0[1];
      wts[v * R + g] = wt[0];
      wts[v * R + g + 8] = wt[1];
    }
    bar_group(gid);

    // gf = [mean0 | var0 | mean1 | var1] per row, stored bf16, [R][GS]
#pragma unroll
    for (int m = 0; m < cdiv(C_RGBF * R, kGroupThreads); ++m) {
      const int i = tid + m * kGroupThreads, c = i / R, r = i % R;
      if (i >= C_RGBF * R) break;
      float f[V];
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] = xch[(u * C_RGBF + c) * XS + r];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float* w = s == 0 ? w0s : wts;
        float mean = 0.0f, var = 0.0f;
#pragma unroll
        for (int u = 0; u < V; ++u) mean += f[u] * w[u * R + r];
#pragma unroll
        for (int u = 0; u < V; ++u)
          var += w[u * R + r] * ((f[u] - mean) * (f[u] - mean));
        gf[r * GS + 2 * s * C_RGBF + c] = __float2bfloat16_rn(mean);
        gf[r * GS + (2 * s + 1) * C_RGBF + c] = __float2bfloat16_rn(var);
      }
    }
    bar_group(gid);

    // base_fc.0's gf block (+ bias) once per slab: n tiles v and v + 6
    for (int j = v; j < 8; j += V) {
      float acc[4];
      const float2 b = *reinterpret_cast<const float2*>(sB + bias_off(4) +
                                                        8 * j + 2 * t);
      acc[0] = acc[2] = b.x;
      acc[1] = acc[3] = b.y;
      const uint2* w = sW + frag_off(4) + lane;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        uint32_t a[1][4];
        load_a<1>(gf, GS, g, t, a, k);
        mma(acc, a[0], w[(k * 8 + j) * 32]);
      }
      *reinterpret_cast<float2*>(gfo + g * OS + 8 * j + 2 * t) =
          make_float2(acc[0], acc[1]);
      *reinterpret_cast<float2*>(gfo + (g + 8) * OS + 8 * j + 2 * t) =
          make_float2(acc[2], acc[3]);
    }
    bar_group(gid);

    // base_fc.0's per-view block on [rf | 0 | neur], base_fc.2 -> x
    float x[4][4];
    {
      float h64[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 lo = *reinterpret_cast<const float2*>(gfo + g * OS + 8 * j + 2 * t);
        const float2 hi =
            *reinterpret_cast<const float2*>(gfo + (g + 8) * OS + 8 * j + 2 * t);
        h64[j][0] = lo.x; h64[j][1] = lo.y; h64[j][2] = hi.x; h64[j][3] = hi.y;
      }
      uint32_t a[5][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[k][i] = rf_a[k][i];
      uint32_t an[2][4];
      load_a(i_neur, C_NEUR, g, t, an);
#pragma unroll
      for (int i = 0; i < 4; ++i) a[3][i] = an[0][i], a[4][i] = an[1][i];
      product<5>(sW, a, h64, lane);
      elu_all(h64);
      uint32_t ah[4][4];
      to_a(h64, ah, lstage);
      init_bias<5>(sB, x, t);
      product<6>(sW, ah, x, lane);
      elu_all(x);
    }
    // vis_fc on x * weight: x += xv[:32]; vis1 = sigmoid(xv[32]) * mask
    float vis1[2];
    {
      uint32_t a[2][4];
      to_a(x, a, lstage, wt[0], wt[1]);
      float h[4][4];
      init_bias<6>(sB, h, t);
      product<7>(sW, a, h, lane);
      elu_all(h);
      to_a(h, a, lstage);
      float xv[5][4];
      init_bias<7>(sB, xv, t);
      product<8>(sW, a, xv, lane);
      elu_all(xv);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) x[j][i] += xv[j][i];
      // column 32 is lane 4g's first column of n tile 4
      vis1[0] = __shfl_sync(kFull, sigm(xv[4][0]) * mk[0], lane & ~3);
      vis1[1] = __shfl_sync(kFull, sigm(xv[4][2]) * mk[1], lane & ~3);
    }
    // vis_fc2 on x * vis1: vis = sigmoid(.) * mask
    {
      uint32_t a[2][4];
      to_a(x, a, lstage, vis1[0], vis1[1]);
      float h[4][4];
      init_bias<8>(sB, h, t);
      product<9>(sW, a, h, lane);
      elu_all(h);
      to_a(h, a, lstage);
      float o[1][4];
      init_bias<9>(sB, o, t);
      product<10>(sW, a, o, lane);
      if (t == 0) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = g + 8 * h2;
          const float vis = sigm(o[0][2 * h2]) * mk[h2];
          viss[v * R + r] = vis;
          if (n0 + r < N)
            visout[static_cast<long long>(v) * N + n0 + r] =
                __float2bfloat16_rn(vis);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xch[(v * C_X + 8 * j + 2 * t + i % 2) * XS + g + 8 * (i / 2)] = x[j][i];
    bar_group(gid);
    // nothing reads the inputs after the chains
    if (kInBuffers == 1 && slab + step < nslabs) inputs(0, slab + step);

    // w2 = vis renormalised over the views, once per thread for its row;
    // w2-weighted mean | var of x | mean of w2 -> feat_const rows [R][65]
    {
      const int r = tid % R;
      float w2[V], vsum = 0.0f;
#pragma unroll
      for (int u = 0; u < V; ++u) vsum += (w2[u] = viss[u * R + r]);
#pragma unroll
      for (int u = 0; u < V; ++u) w2[u] *= __frcp_rn(vsum + 1e-8f);
#pragma unroll
      for (int m = 0; m < cdiv(C_X + 1, kGroupThreads / R); ++m) {
        const int c = tid / R + m * (kGroupThreads / R);
        if (c > C_X) break;
        if (c == C_X) {
          float s = 0.0f;
#pragma unroll
          for (int u = 0; u < V; ++u) s += w2[u];
          stage[r * C_OUT + 2 * C_X] = __float2bfloat16_rn(s / V);
          continue;
        }
        float f[V], mean = 0.0f, var = 0.0f;
#pragma unroll
        for (int u = 0; u < V; ++u) f[u] = xch[(u * C_X + c) * XS + r];
#pragma unroll
        for (int u = 0; u < V; ++u) mean += f[u] * w2[u];
#pragma unroll
        for (int u = 0; u < V; ++u)
          var += w2[u] * ((f[u] - mean) * (f[u] - mean));
        stage[r * C_OUT + c] = __float2bfloat16_rn(mean);
        stage[r * C_OUT + C_X + c] = __float2bfloat16_rn(var);
      }
    }
    // x rows out, 16 bytes (8 channels of one row-view) at a time
#pragma unroll
    for (int m = 0; m < V * R * 4 / kGroupThreads; ++m) {
      const int i = tid + m * kGroupThreads;
      const int u = i / (4 * R), r = i / 4 % R, c = 8 * (i % 4);
      if (n0 + r >= N) continue;
      const float* s = xch + (u * C_X + c) * XS + r;
      *reinterpret_cast<uint4*>(
          xout + (static_cast<long long>(u) * N + n0 + r) * C_X + c) =
          make_uint4(pack2(s[0], s[XS]), pack2(s[2 * XS], s[3 * XS]),
                     pack2(s[4 * XS], s[5 * XS]), pack2(s[6 * XS], s[7 * XS]));
    }
    bar_group(gid);

    // feat_const rows out: the slab's whole 16-byte chunks, then the rest
    // (the next slab's barriers keep its writes behind these reads)
    const int total = (N - n0 < R ? N - n0 : R) * C_OUT;
    bf16* fo = feat_const + static_cast<long long>(n0) * C_OUT;  // 16 B aligned
    for (int i = tid; i < total / 8; i += kGroupThreads)
      reinterpret_cast<uint4*>(fo)[i] = reinterpret_cast<const uint4*>(stage)[i];
    for (int i = total / 8 * 8 + tid; i < total; i += kGroupThreads)
      fo[i] = stage[i];
    buf = (buf + 1) % kInBuffers;
  }
}

}  // namespace

// bf16 elements of the weight pack (ops/view_fuse.py PACK_BF16_ELEMS)
extern "C" int view_fuse_bf16_pack_elems() { return kPackElems; }

// Rows per slab: the kernel's ragged edge lies at multiples of it
extern "C" int view_fuse_bf16_slab_rows() { return R; }

// The kernel as built: out[0] registers a thread, out[1] local (spilled)
// bytes a thread, out[2] dynamic shared bytes a block, out[3] resident
// blocks per SM, out[4] threads a block
extern "C" int view_fuse_bf16_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      view_fuse_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, view_fuse_bf16_kernel);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, view_fuse_bf16_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = kSmemBytes;
  out[3] = per_sm;
  out[4] = kThreads;
  return 0;
}

// bf16 inputs, feat_const, x and vis; float32 num_valid; the pack of
// pack_weights_bf16
extern "C" int view_fuse_bf16_forward(const bf16* rgbf, const bf16* neur,
                                      const bf16* rdiff, const bf16* mask,
                                      const void* wpack, bf16* feat_const,
                                      float* num_valid, bf16* xout,
                                      bf16* visout, int N,
                                      cudaStream_t stream) {
  if (N == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      view_fuse_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, view_fuse_bf16_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm > kBlocksPerSM) per_sm = kBlocksPerSM;
  const int nslabs = (N + R - 1) / R;
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > (nslabs + kGroups - 1) / kGroups)
    blocks = (nslabs + kGroups - 1) / kGroups;
  const size_t addr = reinterpret_cast<size_t>(rgbf) |
                      reinterpret_cast<size_t>(neur) |
                      reinterpret_cast<size_t>(rdiff) |
                      reinterpret_cast<size_t>(mask);
  // 16-byte chunks: every view's block of each input starts 16-byte aligned
  const bool vec = N % 8 == 0 && addr % 16 == 0;
  view_fuse_bf16_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      rgbf, neur, rdiff, mask, reinterpret_cast<const uint4*>(wpack),
      feat_const, num_valid, xout, visout, N, vec);
  return static_cast<int>(cudaGetLastError());
}
