// IBRNet-NeuS view fuse, forward (sm_90a, float32).
//
// Replaces: graspnerf_tpu/ops/pallas/ibrnet_fuse.py `_kernel` (:115-184),
// launched by `_view_fuse_pallas` (:187-228) inside `view_fuse` (:231-253).
// Its plain version is ops/view_fuse.py `view_fuse_plain`, the port of
// `view_fuse_reference` (:52-98). Per row n and view v (V = 6):
//   ray_dir_fc 4->16->35 residual on rgbf; neuray_fc 32->8->1 sigmoid times
//   the mask-normalised weight; two weighted mean/var passes over the views
//   (140-channel global feature gf); base_fc 207->64->32; vis_fc 32->32->33
//   (residual + visibility logit); vis_fc2 32->32->1; renormalised weights ->
//   feat_const [N,65], num_valid [N,1] (exact), x [V,N,32], vis [V,N,1].
//
// Bound: operations. About 10.4k multiply-adds per (row, view) plus 9.0k per
// row for the gf part of base_fc.0, against 72 input and 33 output floats per
// (row, view): float32 FMA on the CUDA cores, far above the card's
// bytes-to-FLOP ratio.
// Design: a block owns tiles of R = 32 rows and all six views: warp v runs
// view v of those 32 rows, one thread per (row, view), so every warp executes
// the same layer at once. All weights (79 KB, transposed to [in][out4] and
// zero-padded to float4 columns) sit in dynamic shared memory for the life of
// the block: a warp reads each weight float4 as one broadcast and does four
// FMAs per read with the activation in a register. Activations stay in
// registers (fully unrolled layers); only the cross-view reductions go
// through shared memory, laid out [view][channel][row] so a warp's 32 rows
// are 32 consecutive words. The gf block of base_fc.0 is the same for all six
// views of a row, so it is computed once per row (its 64 outputs split over
// the six warps) instead of once per view. Blocks are persistent: the grid is
// what fits on the card, and each block walks tiles, loading the weights once.
// ELU is expm1f; sums over views run in view order 0..5 so num_valid is exact.
#include <cuda_runtime.h>

namespace {

constexpr int V = 6;
constexpr int R = 32;             // rows per tile
constexpr int kThreads = V * R;   // 192: warp v = view v
constexpr int C_RGBF = 35, C_NEUR = 32, C_DIFF = 4, C_X = 32, C_OUT = 65;
constexpr int C_GF = 4 * C_RGBF;  // 140

__host__ __device__ constexpr int pad4(int o) { return (o + 3) / 4 * 4; }

// Linear (in, out) in ops/view_fuse.py W_NAMES order
__host__ __device__ constexpr int layer_in(int l) {
  return l == 0 ? 4 : l == 1 ? 16 : l == 2 ? 32 : l == 3 ? 8 : l == 4 ? 207
       : l == 5 ? 64 : 32;
}
__host__ __device__ constexpr int layer_out(int l) {
  return l == 0 ? 16 : l == 1 ? 35 : l == 2 ? 8 : l == 3 ? 1 : l == 4 ? 64
       : l == 7 ? 33 : l == 9 ? 1 : 32;
}
__host__ __device__ constexpr int w_off(int l) {
  return l == 0 ? 0 : w_off(l - 1) + layer_in(l - 1) * pad4(layer_out(l - 1));
}
constexpr int kWTotal = w_off(10);
__host__ __device__ constexpr int b_off(int l) {
  return l == 0 ? kWTotal : b_off(l - 1) + pad4(layer_out(l - 1));
}
constexpr int kPackTotal = b_off(10);
static_assert(kPackTotal % 4 == 0, "weight pack must be float4 sized");
constexpr int kBase0W = w_off(4), kBase0B = b_off(4);   // base_fc.0

// shared memory (floats) after the weight pack
constexpr int kMbuf = kPackTotal;              // mask      [V][R]
constexpr int kW0buf = kMbuf + V * R;          // w0        [V][R]
constexpr int kWbuf = kW0buf + V * R;          // weight    [V][R]
constexpr int kVisbuf = kWbuf + V * R;         // vis       [V][R]
constexpr int kRfbuf = kVisbuf + V * R;        // rf [V][35][R], later x [V][32][R]
constexpr int kGf = kRfbuf + V * C_RGBF * R;   // gf        [140][R]
constexpr int kGfW = kGf + C_GF * R;           // gf part of base_fc.0 [64][R]
constexpr int kSmemFloats = kGfW + 64 * R;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;

__device__ __forceinline__ float elu(float x) { return x > 0.0f ? x : expm1f(x); }
__device__ __forceinline__ float sigm(float x) { return 1.0f / (1.0f + expf(-x)); }

// acc[0..O4) += in[0..I) @ W, W in shared memory as [I][O4]
template <int I, int O4, int NI>
__device__ __forceinline__ void dense(const float (&in)[NI], float (&acc)[O4],
                                      const float* __restrict__ W) {
  static_assert(I <= NI && O4 % 4 == 0, "bad layer shape");
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const float xi = in[i];
#pragma unroll
    for (int o = 0; o < O4; o += 4) {
      const float4 w = *reinterpret_cast<const float4*>(W + i * O4 + o);
      acc[o] = fmaf(w.x, xi, acc[o]);
      acc[o + 1] = fmaf(w.y, xi, acc[o + 1]);
      acc[o + 2] = fmaf(w.z, xi, acc[o + 2]);
      acc[o + 3] = fmaf(w.w, xi, acc[o + 3]);
    }
  }
}

// acc = bias of layer L, then acc += in @ W_L; optional ELU
template <int L, int NI>
__device__ __forceinline__ void layer(const float* sW, const float (&in)[NI],
                                      float (&acc)[pad4(layer_out(L))], bool act) {
  constexpr int O4 = pad4(layer_out(L));
  constexpr int kB = b_off(L), kW = w_off(L);
#pragma unroll
  for (int o = 0; o < O4; ++o) acc[o] = sW[kB + o];
  dense<layer_in(L), O4>(in, acc, sW + kW);
  if (act) {
#pragma unroll
    for (int o = 0; o < O4; ++o) acc[o] = elu(acc[o]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
view_fuse_kernel(const float* __restrict__ rgbf, const float* __restrict__ neur,
                 const float* __restrict__ rdiff, const float* __restrict__ mask,
                 const float* __restrict__ wpack,
                 float* __restrict__ feat_const, float* __restrict__ num_valid,
                 float* __restrict__ xout, float* __restrict__ visout, int N) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* sW = smem;
  float* mbuf = smem + kMbuf;
  float* w0buf = smem + kW0buf;
  float* wbuf = smem + kWbuf;
  float* visbuf = smem + kVisbuf;
  float* rfbuf = smem + kRfbuf;
  float* xbuf = smem + kRfbuf;   // reuses rfbuf once gf is built
  float* gf = smem + kGf;
  float* gfW = smem + kGfW;

  for (int i = threadIdx.x; i < kPackTotal / 4; i += kThreads)
    smem4[i] = reinterpret_cast<const float4*>(wpack)[i];
  __syncthreads();

  const int v = threadIdx.x / R;
  const int r = threadIdx.x % R;
  const int ntiles = (N + R - 1) / R;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n = tile * R + r;
    const bool live = n < N;
    const long long vn = static_cast<long long>(v) * N + n;

    // ---- phase 1: per-view ray-dir and neuray MLPs
    float rd[C_DIFF], rf[pad4(C_RGBF)], nr[C_NEUR];
    float m = 0.0f;
#pragma unroll
    for (int c = 0; c < C_DIFF; ++c) rd[c] = live ? rdiff[vn * C_DIFF + c] : 0.0f;
#pragma unroll
    for (int c = 0; c < C_NEUR; ++c) nr[c] = live ? neur[vn * C_NEUR + c] : 0.0f;
    if (live) m = mask[vn];

    float h16[16];
    layer<0>(sW, rd, h16, true);
    layer<1>(sW, h16, rf, true);   // df, then rf = rgbf + df
#pragma unroll
    for (int c = 0; c < C_RGBF; ++c) rf[c] += live ? rgbf[vn * C_RGBF + c] : 0.0f;
    rf[C_RGBF] = 0.0f;

    float h8[8], s4[4];
    layer<2>(sW, nr, h8, true);
    layer<3>(sW, h8, s4, false);
    mbuf[v * R + r] = m;
    __syncthreads();

    float nv = 0.0f;
#pragma unroll
    for (int u = 0; u < V; ++u) nv += mbuf[u * R + r];
    const float weight = m / (nv + 1e-8f);
    w0buf[v * R + r] = sigm(s4[0]) * weight;
    wbuf[v * R + r] = weight;
#pragma unroll
    for (int c = 0; c < C_RGBF; ++c) rfbuf[(v * C_RGBF + c) * R + r] = rf[c];
    __syncthreads();

    // ---- phase 2: gf = [mean0 | var0 | mean1 | var1], 140 stats per row
    // split over the six warps
    for (int k = v; k < C_GF; k += V) {
      const int which = k / C_RGBF;
      const int c = k % C_RGBF;
      const float* w = which < 2 ? w0buf : wbuf;
      float mean = 0.0f;
#pragma unroll
      for (int u = 0; u < V; ++u)
        mean += rfbuf[(u * C_RGBF + c) * R + r] * w[u * R + r];
      float out = mean;
      if (which & 1) {
        float var = 0.0f;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float d = rfbuf[(u * C_RGBF + c) * R + r] - mean;
          var += w[u * R + r] * (d * d);
        }
        out = var;
      }
      gf[k * R + r] = out;
    }
    __syncthreads();

    // ---- phase 3: gf block of base_fc.0 (+ its bias), once per row
    for (int o = v; o < 64; o += V) {
      float acc = sW[kBase0B + o];
      const float* W = sW + kBase0W + o;
      for (int i = 0; i < C_GF; ++i) acc = fmaf(W[i * 64], gf[i * R + r], acc);
      gfW[o * R + r] = acc;
    }
    __syncthreads();

    // ---- phase 4: rest of base_fc, vis_fc, vis_fc2 per view
    float h64[64];
#pragma unroll
    for (int o = 0; o < 64; ++o) h64[o] = gfW[o * R + r];
    dense<C_RGBF, 64>(rf, h64, sW + kBase0W + C_GF * 64);
    dense<C_NEUR, 64>(nr, h64, sW + kBase0W + (C_GF + C_RGBF) * 64);
#pragma unroll
    for (int o = 0; o < 64; ++o) h64[o] = elu(h64[o]);
    float x[C_X], t32[C_X], xv[pad4(C_X + 1)];
    layer<5>(sW, h64, x, true);
#pragma unroll
    for (int c = 0; c < C_X; ++c) t32[c] = x[c] * weight;
    float a32[C_X];
    layer<6>(sW, t32, a32, true);
    layer<7>(sW, a32, xv, true);
#pragma unroll
    for (int c = 0; c < C_X; ++c) x[c] += xv[c];
    const float vis1 = sigm(xv[C_X]) * m;
#pragma unroll
    for (int c = 0; c < C_X; ++c) t32[c] = x[c] * vis1;
    layer<8>(sW, t32, a32, true);
    layer<9>(sW, a32, s4, false);
    const float vis = sigm(s4[0]) * m;

    if (live) {
      float4* xo = reinterpret_cast<float4*>(xout + vn * C_X);
#pragma unroll
      for (int c = 0; c < C_X; c += 4)
        xo[c / 4] = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
      visout[vn] = vis;
    }
#pragma unroll
    for (int c = 0; c < C_X; ++c) xbuf[(v * C_X + c) * R + r] = x[c];
    visbuf[v * R + r] = vis;
    __syncthreads();

    // ---- phase 5: visibility-weighted mean/var of x -> feat_const
    float vsum = 0.0f;
#pragma unroll
    for (int u = 0; u < V; ++u) vsum += visbuf[u * R + r];
    float w2[V];
#pragma unroll
    for (int u = 0; u < V; ++u) w2[u] = visbuf[u * R + r] / (vsum + 1e-8f);
    for (int k = v; k < C_OUT; k += V) {
      float out = 0.0f;
      if (k == 2 * C_X) {   // mean over views of the weights
#pragma unroll
        for (int u = 0; u < V; ++u) out += w2[u];
        out = out / static_cast<float>(V);
      } else {
        const int c = k % C_X;
        float mean = 0.0f;
#pragma unroll
        for (int u = 0; u < V; ++u) mean += xbuf[(u * C_X + c) * R + r] * w2[u];
        out = mean;
        if (k >= C_X) {
          float var = 0.0f;
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const float d = xbuf[(u * C_X + c) * R + r] - mean;
            var += w2[u] * (d * d);
          }
          out = var;
        }
      }
      if (live) feat_const[static_cast<long long>(n) * C_OUT + k] = out;
    }
    if (v == 0 && live) num_valid[n] = nv;
    __syncthreads();   // the next tile overwrites the exchange buffers
  }
}

}  // namespace

extern "C" int view_fuse_forward(const float* rgbf, const float* neur,
                                 const float* rdiff, const float* mask,
                                 const float* wpack, float* feat_const,
                                 float* num_valid, float* xout, float* visout,
                                 int N, cudaStream_t stream) {
  if (N == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      view_fuse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, view_fuse_kernel, kThreads, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (N + R - 1) / R;
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > ntiles) blocks = ntiles;
  view_fuse_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      rgbf, neur, rdiff, mask, wpack, feat_const, num_valid, xout, visout, N);
  return static_cast<int>(cudaGetLastError());
}
