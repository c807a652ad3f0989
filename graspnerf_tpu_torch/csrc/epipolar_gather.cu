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
// Design: one warp per (view, point). Lane c owns channel c of both feature
// maps, so each of the four taps is one 128-byte coalesced read per map and
// each output row is one coalesced write; lanes 0-2 also fetch the RGB taps.
// The coordinate arithmetic is redone by every lane in the plain version's
// order (ops/interpolate.py); the library is built with -fmad=false so no
// a*b+c is contracted and the result is bit-equal to the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

struct Taps {
  int x0, x1, y0, y1;   // clamped tap coords
  float wx, wy;         // fractional weights
};

__device__ __forceinline__ Taps make_taps(float px, float py, int w, int h) {
  const float fx = floorf(px);
  const float fy = floorf(py);
  Taps t;
  t.wx = px - fx;
  t.wy = py - fy;
  const int xi = static_cast<int>(fx);
  const int yi = static_cast<int>(fy);
  t.x0 = min(max(xi, 0), w - 1);
  t.x1 = min(max(xi + 1, 0), w - 1);
  t.y0 = min(max(yi, 0), h - 1);
  t.y1 = min(max(yi + 1, 0), h - 1);
  return t;
}

// map [h,w,C] channels-last; returns the bilinear sample of channel c
__device__ __forceinline__ float sample(const float* __restrict__ map,
                                        const Taps& t, int w, int C, int c) {
  const float v00 = __ldg(map + (t.y0 * w + t.x0) * C + c);
  const float v01 = __ldg(map + (t.y0 * w + t.x1) * C + c);
  const float v10 = __ldg(map + (t.y1 * w + t.x0) * C + c);
  const float v11 = __ldg(map + (t.y1 * w + t.x1) * C + c);
  const float top = v00 * (1.0f - t.wx) + v01 * t.wx;
  const float bot = v10 * (1.0f - t.wx) + v11 * t.wx;
  return top * (1.0f - t.wy) + bot * t.wy;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gather_kernel(const float* __restrict__ imgs,
              const float* __restrict__ img_feats,
              const float* __restrict__ ray_feats,
              const float* __restrict__ xy,
              const unsigned char* __restrict__ valid,
              float* __restrict__ rgb_out, float* __restrict__ ray_out,
              int V, int P, int H, int W, int fh, int fw, int C) {
  const long long vp = static_cast<long long>(blockIdx.x) * kWarpsPerBlock
                       + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (vp >= static_cast<long long>(V) * P) return;
  const int v = static_cast<int>(vp / P);

  const float x = xy[2 * vp];
  const float y = xy[2 * vp + 1];
  const float m = valid[vp] ? 1.0f : 0.0f;
  // normalise by the full-res extent, then de-normalise onto each map
  const float xn = x / static_cast<float>(W - 1) * 2.0f - 1.0f;
  const float yn = y / static_cast<float>(H - 1) * 2.0f - 1.0f;

  if (lane < C) {
    const float qx = ((xn + 1.0f) * static_cast<float>(fw) - 1.0f) * 0.5f;
    const float qy = ((yn + 1.0f) * static_cast<float>(fh) - 1.0f) * 0.5f;
    const Taps tq = make_taps(qx, qy, fw, fh);
    const long long map_off = static_cast<long long>(v) * fh * fw * C;
    rgb_out[vp * (3 + C) + 3 + lane] =
        sample(img_feats + map_off, tq, fw, C, lane) * m;
    ray_out[vp * C + lane] = sample(ray_feats + map_off, tq, fw, C, lane) * m;
  }
  if (lane < 3) {
    const float fx = (xn + 1.0f) * 0.5f * static_cast<float>(W - 1);
    const float fy = (yn + 1.0f) * 0.5f * static_cast<float>(H - 1);
    const Taps tf = make_taps(fx, fy, W, H);
    const float* img = imgs + static_cast<long long>(v) * H * W * 3;
    rgb_out[vp * (3 + C) + lane] = sample(img, tf, W, 3, lane) * m;
  }
}

}  // namespace

extern "C" int epipolar_gather_forward(
    const float* imgs, const float* img_feats, const float* ray_feats,
    const float* xy, const unsigned char* valid, float* rgb_out,
    float* ray_out, int V, int P, int H, int W, int fh, int fw, int C,
    cudaStream_t stream) {
  const long long rows = static_cast<long long>(V) * P;
  if (rows == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  gather_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out, V, P, H, W, fh,
      fw, C);
  return static_cast<int>(cudaGetLastError());
}
