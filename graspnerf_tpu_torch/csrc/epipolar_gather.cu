// Epipolar feature gather, forward (sm_90a, float32).
//
// Replaces: graspnerf_tpu/ops/fused_gather.py `fused_epipolar_gather`
// (:232-252) with `pack_feature_maps` (:43-64), whose values equal three
// `interpolate_feature_map` calls (graspnerf_tpu/ops/interpolate.py:82-91).
// For every (view v, point p) it samples
//   * the full-res RGB imgs [V,H,W,3] with align_corners=True,
//   * img_feats and ray_feats [V,fh,fw,C] with align_corners=False,
// border-clamped, times valid[v,p], and writes
//   rgb_feats [V,P,3+C] = rgb | img_feats   (the aggregator's concatenation)
//   ray_feats [V,P,C].
//
// Bound: bytes. There is one multiply-add per tap and channel, while every
// output float is written once: at the volume shapes (V=6, P=64,000, C=32)
// about 103 MB of outputs against 25 MB of maps that stay in the 50 MB L2.
// Design: a block takes kPoints consecutive points of one view (the view on
// blockIdx.y, 32-bit indices inside it) in three phases.
//   1. Once per point, one thread computes the coordinates (two IEEE
//      divisions) and the quarter-res taps into shared memory; another
//      thread of the block computes the full-res taps there.
//   2. Eight lanes per point, each owning four channels of both maps, read
//      the taps as float4 (a warp serves four points, each tap row one
//      128-byte read), blend, write ray_feats rows straight out as float4
//      and the img_feats part of the rgb_feats rows into the stage. Six of
//      them read the RGB taps, two contiguous 6-float rows (one read each
//      where a thread per point needs twelve), and three blend them.
//   3. The block's rgb_feats rows (35 floats each, not 16-byte aligned) are
//      one contiguous slab of the output; the stage holds it at the same
//      offset from a 16-byte boundary, so it leaves as aligned float4 stores.
// On the planner's grid, consecutive points are a z-column whose taps
// overlap, so a block's tap reads hit in L1. Maps or ray_feats that are not
// 16-byte aligned, or C % 4 != 0, take float loads and stores in phase 2.
// The arithmetic is the plain version's, op for op (ops/interpolate.py); the
// library is built with -fmad=false so no a*b+c is contracted and the result
// is bit-equal to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPoints = 32;     // points of one view per block
constexpr int kThreads = 2 * kPoints;
constexpr int kLanes = 8;       // lanes per point in phase 2, 4 channels each
constexpr int kMaxRow = 35;     // 3 + C for C <= 32

// One point's taps on one map and its weights (32 bytes of shared memory).
struct __align__(16) Point {
  int o00, dx, dy;            // tap (x0,y0) in floats; steps to x1 and to y1
  float wx, owx, wy, owy, m;  // owx = 1 - wx, owy = 1 - wy, m = valid
};

// The border-clamped taps of pixel coords (px, py) on a [h, w, ch] map.
__device__ __forceinline__ Point make_point(float px, float py, int w, int h,
                                            int ch, float m) {
  const float fx = floorf(px);
  const float fy = floorf(py);
  // clamped to [-1, size-1] first, so that the +1 cannot overflow
  const int xi = min(max(static_cast<int>(fx), -1), w - 1);
  const int yi = min(max(static_cast<int>(fy), -1), h - 1);
  const int x0 = max(xi, 0), y0 = max(yi, 0);
  Point q;
  q.o00 = (y0 * w + x0) * ch;
  q.dx = (min(xi + 1, w - 1) - x0) * ch;
  q.dy = (min(yi + 1, h - 1) - y0) * w * ch;
  q.wx = px - fx;
  q.owx = 1.0f - q.wx;
  q.wy = py - fy;
  q.owy = 1.0f - q.wy;
  q.m = m;
  return q;
}

__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, const Point& q) {
  const float top = v00 * q.owx + v01 * q.wx;
  const float bot = v10 * q.owx + v11 * q.wx;
  return (top * q.owy + bot * q.wy) * q.m;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The four channels c..c+3 of a map at the point's taps, float4 reads.
__device__ __forceinline__ float4 sample4(const float* __restrict__ map,
                                          const Point& q, int c) {
  const float* t = map + q.o00 + c;
  const float4 a = ld4(t), b = ld4(t + q.dx), d = ld4(t + q.dy),
               e = ld4(t + q.dy + q.dx);
  return make_float4(blend(a.x, b.x, d.x, e.x, q), blend(a.y, b.y, d.y, e.y, q),
                     blend(a.z, b.z, d.z, e.z, q), blend(a.w, b.w, d.w, e.w, q));
}

__device__ __forceinline__ float sample1(const float* __restrict__ map,
                                         const Point& q, int c) {
  const float* t = map + q.o00 + c;
  return blend(__ldg(t), __ldg(t + q.dx), __ldg(t + q.dy),
               __ldg(t + q.dy + q.dx), q);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ imgs,
              const float* __restrict__ img_feats,
              const float* __restrict__ ray_feats,
              const float* __restrict__ xy,
              const unsigned char* __restrict__ valid,
              float* __restrict__ rgb_out, float* __restrict__ ray_out,
              int P, int H, int W, int fh, int fw, int C) {
  __shared__ Point pts[kPoints], rgbs[kPoints];
  __shared__ __align__(16) float stage[kPoints * kMaxRow + 4];
  const int R = 3 + C;
  const int p0 = blockIdx.x * kPoints;
  const int n = min(kPoints, P - p0);
  {   // this block's view
    const size_t v = blockIdx.y, vp = v * P;
    const size_t map = v * fh * fw * C;
    imgs += v * H * W * 3;
    img_feats += map;
    ray_feats += map;
    xy += 2 * vp;
    valid += vp;
    rgb_out += vp * R;
    ray_out += vp * C;
  }
  float* dst = rgb_out + p0 * R;   // the block's rows, n * R floats
  // the stage holds dst[k] at stage[a + k]: the same offset from 16 bytes
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(dst) / 4 % 4);
  const int t = threadIdx.x;

  // 1. per point, once: threads [0, kPoints) the quarter-res taps, the
  //    others the full-res ones
  const int i1 = t % kPoints;
  if (i1 < n) {
    const int p = p0 + i1;
    const float x = xy[2 * p];
    const float y = xy[2 * p + 1];
    const float m = valid[p] ? 1.0f : 0.0f;
    // normalise by the full-res extent, then de-normalise onto each map
    const float xn = x / static_cast<float>(W - 1) * 2.0f - 1.0f;
    const float yn = y / static_cast<float>(H - 1) * 2.0f - 1.0f;
    if (t < kPoints) {
      const float qx = ((xn + 1.0f) * static_cast<float>(fw) - 1.0f) * 0.5f;
      const float qy = ((yn + 1.0f) * static_cast<float>(fh) - 1.0f) * 0.5f;
      pts[i1] = make_point(qx, qy, fw, fh, C, m);
    } else {
      const float fx = (xn + 1.0f) * 0.5f * static_cast<float>(W - 1);
      const float fy = (yn + 1.0f) * 0.5f * static_cast<float>(H - 1);
      rgbs[i1] = make_point(fx, fy, W, H, 3, m);
    }
  }
  __syncthreads();

  // 2. kLanes lanes per point. RGB: a tap pair (x0, x1) of one image row
  //    is 6 floats, so lanes 0-5 read rows y0 and y1 and lane c < 3 blends
  //    channel c with lane c+3's values. Maps: four channels per lane.
  const int l = t % kLanes, c = 4 * l;
#pragma unroll
  for (int k = 0; k < kPoints * kLanes / kThreads; ++k) {
    const int i = t / kLanes + k * (kThreads / kLanes);
    const bool live = i < n;   // the same for all lanes of the point
    Point g;
    float r0 = 0.0f, r1 = 0.0f;
    if (live) {
      g = rgbs[i];
      if (l < 6) {
        const float* px = imgs + g.o00 + l % 3 + l / 3 * g.dx;
        r0 = __ldg(px);
        r1 = __ldg(px + g.dy);
      }
    }
    const float s0 = __shfl_down_sync(0xffffffffu, r0, 3, kLanes);
    const float s1 = __shfl_down_sync(0xffffffffu, r1, 3, kLanes);
    if (!live) continue;
    float* row = stage + a + i * R;
    if (l < 3) row[l] = blend(r0, s0, r1, s1, g);
    if (c >= C) continue;
    const Point q = pts[i];
    float* ray = ray_out + (p0 + i) * C;
    if constexpr (kVec) {
      const float4 f = sample4(img_feats, q, c);
      row[3 + c] = f.x;
      row[4 + c] = f.y;
      row[5 + c] = f.z;
      row[6 + c] = f.w;
      *reinterpret_cast<float4*>(ray + c) = sample4(ray_feats, q, c);
    } else {
      for (int j = c; j < min(c + 4, C); ++j) {
        row[3 + j] = sample1(img_feats, q, j);
        ray[j] = sample1(ray_feats, q, j);
      }
    }
  }
  __syncthreads();

  // 3. the staged rows out: stage[4s..4s+3] is dst[4s-a..4s-a+3], 16-byte
  //    aligned; the slab's partial first and last float4 go float by float
  const int end = a + n * R;
  for (int s = 4 * t; s < end; s += 4 * kThreads) {
    if (s >= a && s + 4 <= end) {
      *reinterpret_cast<float4*>(dst + s - a) =
          *reinterpret_cast<const float4*>(stage + s);
    } else {
      for (int j = max(s, a); j < min(s + 4, end); ++j) dst[j - a] = stage[j];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" int epipolar_gather_points_per_block() { return kPoints; }

// The caller guarantees that every index inside one view fits in 32 bits:
// P*(3+C), H*W*3 and fh*fw*C below 2^31 (ops/epipolar_gather.py checks).
extern "C" int epipolar_gather_forward(
    const float* imgs, const float* img_feats, const float* ray_feats,
    const float* xy, const unsigned char* valid, float* rgb_out,
    float* ray_out, int V, int P, int H, int W, int fh, int fw, int C,
    cudaStream_t stream) {
  if (V == 0 || P == 0) return 0;
  const dim3 grid((P + kPoints - 1) / kPoints, V);
  const bool vec = C % 4 == 0 && aligned16(img_feats) &&
                   aligned16(ray_feats) && aligned16(ray_out);
  if (vec)
    gather_kernel<true><<<grid, kThreads, 0, stream>>>(
        imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out, P, H, W, fh,
        fw, C);
  else
    gather_kernel<false><<<grid, kThreads, 0, stream>>>(
        imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out, P, H, W, fh,
        fw, C);
  return static_cast<int>(cudaGetLastError());
}
