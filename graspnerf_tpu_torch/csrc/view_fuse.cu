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
// Design: as the Pallas kernel does, the six views are folded into the
// column axis, so each layer is one small matrix product over M = 6T
// row-views. A persistent block (one per SM, 12 warps) keeps the whole weight
// pack (79 KB, [in][out4]) in shared memory and walks tiles of T = 32 rows.
// Activations live in shared memory channel-major, [C][MP] with column
// m = v*T + r. Every layer, and the gf block (over M = T, split in two
// over its input channels so that more warps share it), goes through one
// routine, `tile_linear`: each thread accumulates a 4-column x 4- or
// 8-output register tile, fed per input channel by one float4 of
// activations and one or two float4s of weights, which the warp's lanes
// share four- and eight-fold; bias, ELU/sigmoid, a per-column scale and a
// residual add are fused into its epilogue. Cross-view reductions are
// elementwise passes over the tile, with sums over views in view order
// 0..5, so num_valid is exact. Tile I/O is coalesced: each view's T rows are
// one contiguous block in device memory, read as float4s by consecutive
// threads (all of a thread's reads in flight at once, the next tile's
// blocks prefetched into L2) and transposed through shared memory.
// What holds it back (tools/view_fuse_phases.py; PERF.md): shared memory
// allows one block, 12 warps, per SM, too few to hide latency, so the
// layers run at 27-57 % of the peak FMA rate; 13 barriers per tile, each
// phase costing ~1k cycles however small its work; the tile load (10 %).
// ELU is exp(x) - 1 and sigmoid 1 / (1 + exp(-x)) on the hardware exp.
#include <cuda_runtime.h>

namespace {

constexpr int V = 6;
constexpr int T = 32;                 // rows per tile
constexpr int M = V * T;              // row-views per tile, column m = v*T + r
constexpr int MP = M + 4;             // row stride of a [C][MP] activation
constexpr int kWarps = 12;
constexpr int kThreads = 32 * kWarps;
constexpr int C_RGBF = 35, C_NEUR = 32, C_DIFF = 4, C_X = 32, C_OUT = 65;
constexpr int C_GF = 4 * C_RGBF;      // 140
static_assert(T % 4 == 0, "a view's rows in a tile fill float4s");

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

// shared memory (floats) after the weight pack; every buffer float4 aligned.
constexpr int C_IN = C_RGBF + C_NEUR + C_DIFF + 1;   // 72
constexpr int kIn = kPackTotal;       // [72][MP] rf | neur | rd | mask
constexpr int kRH = kIn + C_IN * MP;  // [64][MP] h64 (first the gf block's
                                      // parts); later a32, then feat rows
constexpr int kRX = kRH + 64 * MP;    // [32][MP] h16 | h8, then gf [140][T];
                                      // later x
constexpr int kVec = kRX + 32 * MP;   // [5][MP] mask, weight, w0, vis1, vis
constexpr int kSmemFloats = kVec + 5 * MP;
constexpr size_t kSmemBytes = sizeof(float) * kSmemFloats;
static_assert(kSmemBytes <= 232448, "over the 227 KB a block may take");
static_assert(C_GF * T <= C_X * MP && T * C_OUT <= 64 * MP,
              "scratch too small");

enum { kNone, kElu, kSigm, kEluSigm };    // activation; kEluSigm = sigm(elu)
enum { kDstNone, kDstInit, kDstRes };     // out added before / after it

// The hardware exponential (ex2.approx, a few ulp): ELU's exp(x) - 1 then
// errs by ~1e-7 absolute, far inside the kernel's 1e-4 tolerance, at a
// fraction of expm1f's instructions (the epilogues hold ~250 of them per
// (row, view)).
__device__ __forceinline__ float elu(float x) {
  return x > 0.0f ? x : __expf(x) - 1.0f;
}
__device__ __forceinline__ float sigm(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack(const float4 t, float* r) {
  r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
}

// How tile_linear cuts an MC-column x O-output product: a thread holds 4
// columns x RO outputs, a warp (32/LO column lanes x LO output lanes) a
// 128/LO-column x LO*RO-output tile. RO = 8 halves the shared-memory reads
// per FMA where that still gives every warp a tile; RO = 1 for a single
// output. Else RO = 4, with the lane split that needs fewer warp tiles.
struct Shape {
  int ro, lo;
};
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int warp_tiles(int O, int MC, Shape s) {
  return cdiv(MC / 4, 32 / s.lo) * cdiv(cdiv(pad4(O), s.ro), s.lo);
}
__host__ __device__ constexpr Shape tile_shape(int O, int MC) {
  return O == 1 ? Shape{1, 1}
       : pad4(O) % 32 == 0 && warp_tiles(O, MC, Shape{8, 4}) >= kWarps
           ? Shape{8, 4}
       : MC / 4 % 16 == 0 &&
               warp_tiles(O, MC, Shape{4, 2}) < warp_tiles(O, MC, Shape{4, 4})
           ? Shape{4, 2}
           : Shape{4, 4};
}

// out[o][m] = epilogue(sum_i A[i][m] W[i][o]) for o < O, m < MC, by the
// block. A is [I][lda], out [O][ldo] (shared memory, float4 aligned), W
// I rows of LDW floats from the pack. Epilogue, in this order: times
// pre[m], plus bias[o], plus out[o][m] (kDstInit), activation, times
// post[m], plus out[o][m] (kDstRes); null pointers skip their step. Warp
// tiles are dealt out from warp `rot` on, so that independent calls can
// share a phase.
template <int I, int O, int MC, int ACT, int DST, int LDW = pad4(O)>
__device__ __forceinline__ void tile_linear(
    const float* __restrict__ A, int lda, const float* __restrict__ W,
    const float* bias, float* out, int ldo, const float* pre,
    const float* post, int rot = 0) {
  constexpr Shape S = tile_shape(O, MC);
  constexpr int RO = S.ro, LO = S.lo, LM = 32 / LO;
  constexpr int NM = MC / 4, NO = cdiv(pad4(O), RO);   // thread tiles
  constexpr int WM = cdiv(NM, LM), WO = cdiv(NO, LO);   // warp tiles
  static_assert(MC % 4 == 0 && LDW % 4 == 0, "float4 rows");
  const int lane = threadIdx.x % 32;
  const int first = (threadIdx.x / 32 + kWarps - rot) % kWarps;
  for (int wt = first; wt < WM * WO; wt += kWarps) {
    const int mq = (wt % WM) * LM + lane % LM;
    const int oq = (wt / WM) * LO + lane / LM;
    if (mq >= NM || oq >= NO) continue;
    const float* a = A + 4 * mq;
    const float* w = W + RO * oq;
    float acc[4][RO] = {};
#pragma unroll 8
    for (int i = 0; i < I; ++i) {
      float ar[4], wr[RO];
      unpack(ld4(a + i * lda), ar);
      if (RO == 1) {
        wr[0] = w[i * LDW];
      } else {
#pragma unroll
        for (int k = 0; k < RO; k += 4) unpack(ld4(w + i * LDW + k), wr + k);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int k = 0; k < RO; ++k) acc[j][k] = fmaf(ar[j], wr[k], acc[j][k]);
    }
    float p[4] = {1.0f, 1.0f, 1.0f, 1.0f}, q[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    if (pre) unpack(ld4(pre + 4 * mq), p);
    if (post) unpack(ld4(post + 4 * mq), q);
#pragma unroll
    for (int k = 0; k < RO; ++k) {
      const int o = RO * oq + k;
      if (o >= O) break;
      float* dst = out + o * ldo + 4 * mq;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (DST != kDstNone) unpack(ld4(dst), d);
      const float b = bias ? bias[o] : 0.0f;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[j][k];
        if (pre) s *= p[j];
        s += b;
        if (DST == kDstInit) s += d[j];
        if (ACT == kElu) s = elu(s);
        if (ACT == kSigm) s = sigm(s);
        if (ACT == kEluSigm) s = sigm(elu(s));
        if (post) s *= q[j];
        if (DST == kDstRes) s += d[j];
        y[j] = s;
      }
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// Layer L of the pack over all M row-views, [C][MP] in and out
template <int L, int ACT, int DST = kDstNone>
__device__ __forceinline__ void layer(const float* sW, const float* A,
                                      float* out, const float* pre,
                                      const float* post, int rot = 0) {
  tile_linear<layer_in(L), layer_out(L), M, ACT, DST>(
      A, MP, sW + w_off(L), sW + b_off(L), out, MP, pre, post, rot);
}

// Tile I/O of a [V,N,C] input: rows n0..n0+T-1 of every view are one
// contiguous block of Q = T*C/4 float4s. fetch() reads this thread's
// float4s of them (consecutive threads, consecutive float4s; zero past N;
// K per thread, all in flight at once), scatter() writes them
// channel-major, dst[c][v*T + r]. Needs 16-byte aligned inputs and
// N % 4 == 0, so that every block and the live part of the last one are
// whole, aligned float4s.
template <int C>
struct TileIn {
  static constexpr int Q = T * C / 4;
  static constexpr int K = (V * Q + kThreads - 1) / kThreads;
  float4 buf[K];

  __device__ __forceinline__ void fetch(const float* __restrict__ src, int n0,
                                        int N) {
    const int live = (N - n0 < T ? N - n0 : T) * C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int g = threadIdx.x + k * kThreads, v = g / Q, e = 4 * (g % Q);
      buf[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g < V * Q && e < live)
        buf[k] = __ldg(reinterpret_cast<const float4*>(
            src + (static_cast<long long>(v) * N + n0) * C + e));
    }
  }
  __device__ __forceinline__ void scatter(float* dst) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int g = threadIdx.x + k * kThreads, e = 4 * (g % Q);
      if (g >= V * Q) break;
      float f[4];
      unpack(buf[k], f);
      int r = e / C, c = e % C;
      float* d = dst + g / Q * T;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        d[c * MP + r] = f[j];
        if (++c == C) c = 0, ++r;
      }
    }
  }
};

// The same for any N, a float at a time
template <int C>
__device__ __forceinline__ void load_tile_scalar(const float* __restrict__ src,
                                                 float* dst, int n0, int N) {
  const int live = (N - n0 < T ? N - n0 : T) * C;
#pragma unroll 4
  for (int g = threadIdx.x; g < V * T * C; g += kThreads) {
    const int v = g / (T * C), e = g % (T * C);
    dst[e % C * MP + v * T + e / C] =
        e < live ? __ldg(src + (static_cast<long long>(v) * N + n0) * C + e)
                 : 0.0f;
  }
}

// A tile's four inputs: all their float4 reads in flight at once (fetch),
// then written into IN (scatter)
struct Inputs {
  TileIn<C_RGBF> a;
  TileIn<C_NEUR> b;
  TileIn<C_DIFF> c;
  TileIn<1> d;

  __device__ __forceinline__ void fetch(const float* rgbf, const float* neur,
                                        const float* rdiff, const float* mask,
                                        int tile, int N) {
    a.fetch(rgbf, tile * T, N);
    b.fetch(neur, tile * T, N);
    c.fetch(rdiff, tile * T, N);
    d.fetch(mask, tile * T, N);
  }
  __device__ __forceinline__ void scatter(float* in) const {
    a.scatter(in);
    b.scatter(in + C_RGBF * MP);
    c.scatter(in + (C_RGBF + C_NEUR) * MP);
    d.scatter(in + (C_IN - 1) * MP);
  }
};

// Tile `tile`'s inputs into IN, for any N
__device__ __forceinline__ void load_inputs_scalar(
    const float* rgbf, const float* neur, const float* rdiff,
    const float* mask, float* in, int tile, int N) {
  load_tile_scalar<C_RGBF>(rgbf, in, tile * T, N);
  load_tile_scalar<C_NEUR>(neur, in + C_RGBF * MP, tile * T, N);
  load_tile_scalar<C_DIFF>(rdiff, in + (C_RGBF + C_NEUR) * MP, tile * T, N);
  load_tile_scalar<1>(mask, in + (C_IN - 1) * MP, tile * T, N);
}

// Ask L2 for tile `tile`'s inputs (one bulk prefetch per array and view,
// its ends rounded down to 16 bytes, so never past the tensor), so that the
// tile's loads find them there
__device__ __forceinline__ void prefetch_inputs(
    const float* rgbf, const float* neur, const float* rdiff,
    const float* mask, int tile, int N) {
  if (threadIdx.x >= 4 * V) return;
  const int k = threadIdx.x / V, v = threadIdx.x % V;
  const float* src = k == 0 ? rgbf : k == 1 ? neur : k == 2 ? rdiff : mask;
  const int C = k == 0 ? C_RGBF : k == 1 ? C_NEUR : k == 2 ? C_DIFF : 1;
  const int n0 = tile * T, rows = N - n0 < T ? N - n0 : T;
  const long long first = (static_cast<long long>(v) * N + n0) * C;
  const size_t lo = reinterpret_cast<size_t>(src + first) & ~size_t{15};
  const size_t hi =
      reinterpret_cast<size_t>(src + first + rows * C) & ~size_t{15};
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                 :: "l"(lo), "r"(static_cast<unsigned>(hi - lo)) : "memory");
}

// x [32][MP] -> xout [V,N,32] and vis [MP] -> visout [V,N,1], rows n0..,
// rows past N skipped; x as float4s (4 channels of one row-view)
__device__ __forceinline__ void store_x_vis(const float* x, const float* vis,
                                            float* __restrict__ xout,
                                            float* __restrict__ visout,
                                            int n0, int N) {
  const int rows = N - n0 < T ? N - n0 : T;
  constexpr int Q = T * C_X / 4;
#pragma unroll 4
  for (int g = threadIdx.x; g < V * Q; g += kThreads) {
    const int v = g / Q, e = 4 * (g % Q), r = e / C_X, c = e % C_X;
    if (r >= rows) continue;
    const float* s = x + c * MP + v * T + r;
    float* d = xout + (static_cast<long long>(v) * N + n0) * C_X + e;
    *reinterpret_cast<float4*>(d) =
        make_float4(s[0], s[MP], s[2 * MP], s[3 * MP]);
  }
  for (int m = threadIdx.x; m < M; m += kThreads)
    if (m % T < rows)
      visout[static_cast<long long>(m / T) * N + n0 + m % T] = vis[m];
}

// base_fc.0's gf block over the T rows, split over its 140 input channels
// into kGfParts partial products (part p in columns p*T.. of h) so that
// more warps share it; the caller sums the parts in order.
constexpr int kGfParts = 2, kGfK = 70;
static_assert(kGfParts * kGfK >= C_GF && kGfParts <= V, "gf block split");
template <int P>
__device__ __forceinline__ void gf_block(const float* sW, const float* gf,
                                         float* h) {
  constexpr int K0 = P * kGfK, K = C_GF - K0 < kGfK ? C_GF - K0 : kGfK;
  tile_linear<K, 64, T, kNone, kDstNone>(
      gf + K0 * T, T, sW + kBase0W + K0 * 64, P == 0 ? sW + kBase0B : nullptr,
      h + P * T, MP, nullptr, nullptr, P * kWarps / kGfParts);
  if constexpr (P + 1 < kGfParts) gf_block<P + 1>(sW, gf, h);
}

__global__ void __launch_bounds__(kThreads, 1)
view_fuse_kernel(const float* __restrict__ rgbf, const float* __restrict__ neur,
                 const float* __restrict__ rdiff, const float* __restrict__ mask,
                 const float* __restrict__ wpack,
                 float* __restrict__ feat_const, float* __restrict__ num_valid,
                 float* __restrict__ xout, float* __restrict__ visout, int N,
                 bool vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* sW = smem;
  float* rf = smem + kIn;              // [35][MP], then neur [32][MP]
  float* nr = rf + C_RGBF * MP;
  float* rd = nr + C_NEUR * MP;        // [4][MP]
  const float* mk_in = rd + C_DIFF * MP;
  float* h = smem + kRH;               // h64 [64][MP]
  float* a32 = smem + kRH;             // [32][MP] once h64 is dead
  float* stage = smem + kRH;           // feat_const rows [T][65] at the end
  float* h16 = smem + kRX;             // [16][MP]
  float* h8 = h16 + 16 * MP;           // [8][MP]
  float* gf = smem + kRX;              // [140][T] once h16, h8 are dead
  float* x = smem + kRX;               // [32][MP] once gf is dead
  float* mk = smem + kVec;
  float* wt = mk + MP;
  float* w0 = wt + MP;
  float* vis1 = w0 + MP;
  float* vis = vis1 + MP;

  // the weights, once per block; the loop's first barrier publishes them
  for (int i = threadIdx.x; i < kPackTotal / 4; i += kThreads)
    smem4[i] = reinterpret_cast<const float4*>(wpack)[i];

  const int ntiles = (N + T - 1) / T;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int n0 = tile * T;
    // nothing reads IN after base_fc.0, so the copy needs no barrier first
    if (vec) {
      Inputs in;
      in.fetch(rgbf, neur, rdiff, mask, tile, N);
      in.scatter(rf);
    } else {
      load_inputs_scalar(rgbf, neur, rdiff, mask, rf, tile, N);
    }
    if (tile + gridDim.x < ntiles)
      prefetch_inputs(rgbf, neur, rdiff, mask, tile + gridDim.x, N);
    __syncthreads();

    // mask-normalised weight and num_valid; ray_dir_fc.0
    for (int m = threadIdx.x; m < M; m += kThreads) {
      const int r = m % T;
      float nv = 0.0f;
#pragma unroll
      for (int u = 0; u < V; ++u) nv += mk_in[u * T + r];
      mk[m] = mk_in[m];
      wt[m] = mk_in[m] * (1.0f / (nv + 1e-8f));
      if (m < T && n0 + m < N) num_valid[n0 + m] = nv;
    }
    layer<0, kElu>(sW, rd, h16, nullptr, nullptr);            // 6 warp tiles
    layer<2, kElu>(sW, nr, h8, nullptr, nullptr, kWarps / 2);  // 3
    __syncthreads();
    layer<1, kElu, kDstRes>(sW, h16, rf, nullptr, nullptr);   // rf = rgbf + df
    layer<3, kSigm>(sW, h8, w0, nullptr, wt, kWarps / 4);     // w0, weighted
    __syncthreads();

    // gf = [mean0 | var0 | mean1 | var1] per row, [140][T]
    for (int g = threadIdx.x; g < C_RGBF * T; g += kThreads) {
      const int c = g / T, r = g % T;
      float f[V];
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] = rf[c * MP + u * T + r];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float* w = s == 0 ? w0 : wt;
        float mean = 0.0f, var = 0.0f;
#pragma unroll
        for (int u = 0; u < V; ++u) mean += f[u] * w[u * T + r];
#pragma unroll
        for (int u = 0; u < V; ++u)
          var += w[u * T + r] * ((f[u] - mean) * (f[u] - mean));
        gf[(2 * s * C_RGBF + c) * T + r] = mean;
        gf[((2 * s + 1) * C_RGBF + c) * T + r] = var;
      }
    }
    __syncthreads();

    // base_fc.0: its gf block (+ bias) once per row, then the per-view
    // rf | neur block on top
    gf_block<0>(sW, gf, h);
    __syncthreads();
    for (int g = threadIdx.x; g < 64 * T; g += kThreads) {
      float* row = h + (g / T) * MP + g % T;   // this thread owns (o, r)
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < kGfParts; ++p) s += row[p * T];
#pragma unroll
      for (int v = 0; v < V; ++v) row[v * T] = s;
    }
    __syncthreads();
    tile_linear<C_RGBF + C_NEUR, 64, M, kElu, kDstInit>(
        rf, MP, sW + kBase0W + C_GF * 64, nullptr, h, MP, nullptr, nullptr);
    __syncthreads();

    layer<5, kElu>(sW, h, x, nullptr, nullptr);
    __syncthreads();
    layer<6, kElu>(sW, x, a32, wt, nullptr);      // vis_fc.0 on x * weight
    __syncthreads();
    // vis_fc.2 as its first 32 outputs (x += xv[:32]) and its last, the
    // visibility logit: vis1 = sigmoid(elu(.)) * mask
    tile_linear<C_X, C_X, M, kElu, kDstRes, pad4(C_X + 1)>(
        a32, MP, sW + w_off(7), sW + b_off(7), x, MP, nullptr, nullptr);
    tile_linear<C_X, 1, M, kEluSigm, kDstNone, pad4(C_X + 1)>(
        a32, MP, sW + w_off(7) + C_X, sW + b_off(7) + C_X, vis1, MP, nullptr,
        mk, kWarps - 2);
    __syncthreads();
    layer<8, kElu>(sW, x, a32, vis1, nullptr);     // vis_fc2.0 on x * vis1
    __syncthreads();
    layer<9, kSigm>(sW, a32, vis, nullptr, mk);    // vis = sigmoid(.) * mask
    __syncthreads();

    // x and vis out; visibility re-normalised over the views (w2);
    // w2-weighted mean | var of x | mean of w2 -> feat_const rows [T][65]
    store_x_vis(x, vis, xout, visout, n0, N);
    for (int g = threadIdx.x; g < (C_X + 1) * T; g += kThreads) {
      const int c = g / T, r = g % T;
      float vsum = 0.0f, w2[V];
#pragma unroll
      for (int u = 0; u < V; ++u) vsum += vis[u * T + r];
      const float inv = 1.0f / (vsum + 1e-8f);
#pragma unroll
      for (int u = 0; u < V; ++u) w2[u] = vis[u * T + r] * inv;
      if (c == C_X) {
        float s = 0.0f;
#pragma unroll
        for (int u = 0; u < V; ++u) s += w2[u];
        stage[r * C_OUT + 2 * C_X] = s * (1.0f / V);
        continue;
      }
      float f[V], mean = 0.0f, var = 0.0f;
#pragma unroll
      for (int u = 0; u < V; ++u) f[u] = x[c * MP + u * T + r];
#pragma unroll
      for (int u = 0; u < V; ++u) mean += f[u] * w2[u];
#pragma unroll
      for (int u = 0; u < V; ++u) var += w2[u] * ((f[u] - mean) * (f[u] - mean));
      stage[r * C_OUT + c] = mean;
      stage[r * C_OUT + C_X + c] = var;
    }
    __syncthreads();

    // the next iteration's barrier keeps its writes behind these reads
    const int total = (N - n0 < T ? N - n0 : T) * C_OUT;
    float* fo = feat_const + static_cast<long long>(n0) * C_OUT;   // 16 B aligned
    for (int g = threadIdx.x; g < total / 4; g += kThreads)
      *reinterpret_cast<float4*>(fo + 4 * g) = ld4(stage + 4 * g);
    for (int g = total / 4 * 4 + threadIdx.x; g < total; g += kThreads)
      fo[g] = stage[g];
  }
}

}  // namespace

// Floats in the weight pack the kernel reads (ops/view_fuse.py PACK_FLOATS)
extern "C" int view_fuse_pack_floats() { return kPackTotal; }

// Rows per tile: the kernel's ragged edge lies at multiples of it
extern "C" int view_fuse_tile_rows() { return T; }

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
  const int ntiles = (N + T - 1) / T;
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > ntiles) blocks = ntiles;
  const size_t addr = reinterpret_cast<size_t>(rgbf) |
                      reinterpret_cast<size_t>(neur) |
                      reinterpret_cast<size_t>(rdiff) |
                      reinterpret_cast<size_t>(mask);
  const bool vec = N % 4 == 0 && addr % 16 == 0;   // float4 tile loads
  view_fuse_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      rgbf, neur, rdiff, mask, wpack, feat_const, num_valid, xout, visout, N,
      vec);
  return static_cast<int>(cudaGetLastError());
}
