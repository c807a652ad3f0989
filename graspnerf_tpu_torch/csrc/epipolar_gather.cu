// Epipolar feature gather, forward and backward (sm_90a, float32 and
// bfloat16).
//
// Forward. Replaces: graspnerf_tpu/ops/fused_gather.py `fused_epipolar_gather`
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
// bfloat16 instance (epipolar_gather_forward_bf16): the maps
// (`pack_feature_maps(dtype)`, fused_gather.py:43-64) are read in bfloat16,
// exactly widened to float32, weighed and blended as above; rgb_feats is
// written rounded to the nearest bfloat16, as the plain version rounds it,
// ray_feats in float32, the blend itself, as JAX's gather returns it
// (fused_gather.py:178-180). Its vector path reads 8 bytes (four channels)
// at a time.
//
// Backward. Replaces: `_feg_bwd` (graspnerf_tpu/ops/fused_gather.py:260-270)
// with `_splat_windows` (:183-229), the transpose of the forward with respect
// to the maps: for every (view, point, channel) the upstream gradient times
// the mask, times each of the four tap weights, summed at that tap's map
// cell (JAX sums with one-hot matmuls because XLA:TPU serialises
// scatter-add). The gradient with respect to xy is its own kernel, at the
// end of this file. Upstream: d_rgb_feats [V,P,3+C]
// (its channels 0..2 go to the RGB image, 3.. to img_feats) and d_ray_feats
// [V,P,C]; outputs d_img_feats, d_ray_feats [V,fh,fw,C], every cell written
// once (no zeroing), and, only when asked for, d_imgs [V,H,W,3].
// Bound: bytes: the upstream gradients read once and the two maps'
// gradients written once. A scatter adds 4 taps x 2 maps x C floats a point
// into L2 with atomics (24.6 M vector reductions at P = 64,000, whose rate
// set the time of the scatter this replaces) in an order that changes from
// run to run. This design adds nothing into global memory: it pulls.
//   1. Index (two launches after a memset of tickets and flags): each
//      point enters the list of every kTileY x kTileX tile of map cells
//      that its taps reach (`tile_keys`; its anchor cell and weights taken
//      as the forward's phase 1 takes them, and kept in the entry), by a
//      stable counting sort over chunks of kSpan points: a count pass with
//      per-warp histograms, whose last block per view scans them and cuts
//      the tiles' lists, longest first, into work items of at most kSplit
//      chunks, then a fill pass that ranks the same way.
//   2. Pull (one launch, a block per work item): latency, not bytes or
//      operations, bounded the block-synchronous pull this replaces (five
//      barrier-separated phases a chunk, rows copied through registers in
//      bfloat16, the longest list one block's). Each block is a producer
//      warp, which sorts the item's list kChunk entries at a time by
//      anchor cell up to kMetaStages chunks ahead, and 8 summing warps,
//      which copy each chunk's two gradient rows a point into shared
//      memory in their own dtype (16-byte cp.async of the blocks that hold
//      them, completion counted on an mbarrier) and sum. A summing warp
//      owns 2 x 4 cells, a lane one channel of both maps: it walks the 3 x
//      5 anchor cells whose taps can reach its cells and adds each entry,
//      in registers and in splat's order, to the cells its taps land on,
//      attributed by their computed targets (clamped borders put two taps
//      on one cell); every branch is the same for the whole warp. Then each
//      cell is written once, float4 stores where the maps' gradients are
//      16-byte aligned and C % 4 == 0, else a float a lane. A list longer
//      than kSplit chunks (a ray's 40 samples on one cell, points clamped
//      onto a border, the planner's dense tiles) is split: each range sums
//      on its own and writes float32 partials, and the range whose ticket
//      comes last adds them in range order, so no block holds the longest
//      list.
// Invalid points: their contribution g * 0 is zero (up to its sign) unless
// an upstream value g is not finite. The index leaves them out; the fill
// pass reads their upstream rows (while its ranks run) and flags a view
// where one holds inf or NaN, and there the pull sets NaN in every cell and
// channel that such a point's taps reach, as the plain version's sums are.
// (Projected points that miss a view pile onto its border cells: at the
// train pass's shape ~170 a cell, 92 % of them invalid.)
// Each cell's sum runs in a fixed order, so the result is deterministic. The
// upstream rows are read about 1.2 times (a point whose taps cross a tile
// edge is in two or four lists). d_imgs (no path asks for it) keeps scalar
// atomicAdds into a zeroed tensor, in the count pass.
// bfloat16 instance (epipolar_gather_backward_bf16): `_feg_bwd` on maps
// that `pack_feature_maps(..., bfloat16)` packed. The index is the same; d_rgb
// is read in bfloat16 and d_ray in float32 (the ray features' two consumers
// add their gradients in float32, as JAX's float32 gather output does); each
// point adds to a cell, once, its upstream value times the cell's folded
// tap weight rounded to bfloat16 (`pull_entry_bf16`), the cell sums those
// in float32 and is written once, rounded to bfloat16. A flagged view's NaNs
// cover each such point's whole 2 x 2 window, as JAX's zero weights times
// g * 0 do. d_imgs: `splat_bf16`, each contribution rounded before its
// float32 atomic add, the map rounded once by the wrapper.
#include <cuda_bf16.h>
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

// Full-res pixel coordinates normalised by the full-res extent.
__device__ __forceinline__ float2 normalised(float2 xy, int H, int W) {
  return make_float2(xy.x / static_cast<float>(W - 1) * 2.0f - 1.0f,
                     xy.y / static_cast<float>(H - 1) * 2.0f - 1.0f);
}
__device__ __forceinline__ float2 normalised(const float* __restrict__ xy,
                                             int p, int H, int W) {
  return normalised(make_float2(xy[2 * p], xy[2 * p + 1]), H, W);
}

// The taps of point p on a quarter-res [fh, fw, ch] map (align_corners=False)
// and on the full-res [H, W, 3] image (align_corners=True).
__device__ __forceinline__ Point quarter_point(float2 n, int fh, int fw,
                                               int ch, float m) {
  const float qx = ((n.x + 1.0f) * static_cast<float>(fw) - 1.0f) * 0.5f;
  const float qy = ((n.y + 1.0f) * static_cast<float>(fh) - 1.0f) * 0.5f;
  return make_point(qx, qy, fw, fh, ch, m);
}
__device__ __forceinline__ Point full_point(float2 n, int H, int W, float m) {
  const float fx = (n.x + 1.0f) * 0.5f * static_cast<float>(W - 1);
  const float fy = (n.y + 1.0f) * 0.5f * static_cast<float>(H - 1);
  return make_point(fx, fy, W, H, 3, m);
}

// Phase 1 of the forward: threads [0, kPoints) compute the quarter-res
// taps of the block's points, the others the full-res ones.
__device__ __forceinline__ void load_taps(const float* __restrict__ xy,
                                          const unsigned char* __restrict__ valid,
                                          int p0, int n, int H, int W, int fh,
                                          int fw, int C, Point* pts,
                                          Point* rgbs) {
  const int t = threadIdx.x;
  const int i1 = t % kPoints;
  if (i1 >= n) return;
  const int p = p0 + i1;
  const float m = valid[p] ? 1.0f : 0.0f;
  const float2 nxy = normalised(xy, p, H, W);
  if (t < kPoints)
    pts[i1] = quarter_point(nxy, fh, fw, C, m);
  else
    rgbs[i1] = full_point(nxy, H, W, m);
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

// Element access for the maps and outputs of both instances: float, or
// bf16 read exactly into float and written rounded to the nearest.
using bf16 = __nv_bfloat16;
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to the nearest bf16, as float
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// four consecutive elements, 16 (float) or 8 (bf16) bytes, aligned
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<unsigned*>(&lo), *reinterpret_cast<unsigned*>(&hi));
}

// The four channels c..c+3 of a map at the point's taps, vector reads.
template <typename T>
__device__ __forceinline__ float4 sample4(const T* __restrict__ map,
                                          const Point& q, int c) {
  const T* t = map + q.o00 + c;
  const float4 a = load4(t), b = load4(t + q.dx), d = load4(t + q.dy),
               e = load4(t + q.dy + q.dx);
  return make_float4(blend(a.x, b.x, d.x, e.x, q), blend(a.y, b.y, d.y, e.y, q),
                     blend(a.z, b.z, d.z, e.z, q), blend(a.w, b.w, d.w, e.w, q));
}

template <typename T>
__device__ __forceinline__ float sample1(const T* __restrict__ map,
                                         const Point& q, int c) {
  const T* t = map + q.o00 + c;
  return blend(to_f(__ldg(t)), to_f(__ldg(t + q.dx)), to_f(__ldg(t + q.dy)),
               to_f(__ldg(t + q.dy + q.dx)), q);
}

// T: float, or bf16 for the bfloat16 instance (maps and rgb_out in it; the
// coordinates, taps, weights and blends float32 all the same); ray_out
// float32 in both
template <bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ imgs,
              const T* __restrict__ img_feats,
              const T* __restrict__ ray_feats,
              const float* __restrict__ xy,
              const unsigned char* __restrict__ valid,
              T* __restrict__ rgb_out, float* __restrict__ ray_out,
              int P, int H, int W, int fh, int fw, int C) {
  constexpr int E = 16 / sizeof(T);   // elements per 16 bytes
  __shared__ Point pts[kPoints], rgbs[kPoints];
  __shared__ __align__(16) T stage[kPoints * kMaxRow + E];
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
  T* dst = rgb_out + p0 * R;   // the block's rows, n * R elements
  // the stage holds dst[k] at stage[a + k]: the same offset from 16 bytes
  const int a =
      static_cast<int>(reinterpret_cast<uintptr_t>(dst) / sizeof(T) % E);
  const int t = threadIdx.x;

  // 1. per point, once: the taps of both maps
  load_taps(xy, valid, p0, n, H, W, fh, fw, C, pts, rgbs);
  __syncthreads();

  // 2. kLanes lanes per point. RGB: a tap pair (x0, x1) of one image row
  //    is 6 elements, so lanes 0-5 read rows y0 and y1 and lane c < 3
  //    blends channel c with lane c+3's values. Maps: four channels per
  //    lane.
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
        const T* px = imgs + g.o00 + l % 3 + l / 3 * g.dx;
        r0 = to_f(__ldg(px));
        r1 = to_f(__ldg(px + g.dy));
      }
    }
    const float s0 = __shfl_down_sync(0xffffffffu, r0, 3, kLanes);
    const float s1 = __shfl_down_sync(0xffffffffu, r1, 3, kLanes);
    if (!live) continue;
    T* row = stage + a + i * R;
    if (l < 3) row[l] = from_f<T>(blend(r0, s0, r1, s1, g));
    if (c >= C) continue;
    const Point q = pts[i];
    float* ray = ray_out + (p0 + i) * C;
    if constexpr (kVec) {
      const float4 f = sample4(img_feats, q, c);
      row[3 + c] = from_f<T>(f.x);
      row[4 + c] = from_f<T>(f.y);
      row[5 + c] = from_f<T>(f.z);
      row[6 + c] = from_f<T>(f.w);
      store4(ray + c, sample4(ray_feats, q, c));
    } else {
      for (int j = c; j < min(c + 4, C); ++j) {
        row[3 + j] = from_f<T>(sample1(img_feats, q, j));
        ray[j] = sample1(ray_feats, q, j);
      }
    }
  }
  __syncthreads();

  // 3. the staged rows out: stage[Es..Es+E-1] is dst[Es-a..], 16-byte
  //    aligned; the slab's partial first and last chunk go element by
  //    element
  const int end = a + n * R;
  for (int s = E * t; s < end; s += E * kThreads) {
    if (s >= a && s + E <= end) {
      *reinterpret_cast<uint4*>(dst + s - a) =
          *reinterpret_cast<const uint4*>(stage + s);
    } else {
      for (int j = max(s, a); j < min(s + E, end); ++j) dst[j - a] = stage[j];
    }
  }
}

// ---------------------------------------------------------------- backward
// Sizes of the backward (see the note at the top).
constexpr int kTileY = 8, kTileX = 8;   // map cells a pull work item owns
// anchor cells whose points can reach a tile: the tile and its one-cell top
// and left halo, in the tile's region (row 0 and column 0 the halo)
constexpr int kKeys = (kTileY + 1) * (kTileX + 1);
// an invalid point adds g * 0, which is 0 unless g is not finite: the index
// leaves invalid points out, the fill pass flags the rare views where one
// has a non-finite upstream value, and those take the pull's NaN path
// (false: they are summed like the others, an ablation)
constexpr bool kDropInvalid = true;
constexpr int kKeysPerLane = (kKeys + 31) / 32;
constexpr int kWarpY = 2, kWarpX = 4;   // cells a summing warp owns
constexpr int kSumWarps = kTileY / kWarpY * (kTileX / kWarpX);
constexpr int kSumThreads = 32 * kSumWarps;
constexpr int kPullThreads = kSumThreads + 32;   // and the producer warp
constexpr int kPullMinBlocks = 3;       // an SM's blocks: the register cap
constexpr int kChunk = 128;             // tile-list entries a stage holds
// a block's rings: chunks whose rows are in shared memory (1: the next
// chunk's rows are copied once the summing warps are done with a chunk's,
// and land while they finish work items; 2: during the chunk's sums, an
// ablation), and chunks the producer has sorted (it runs up to
// kMetaStages chunks ahead)
constexpr int kRowStages = 1, kMetaStages = 3;
constexpr int kSplit = 8;               // chunks of a work item, at most
// how the summing warps stage a chunk's gradient rows, the 16-byte blocks
// that hold them: 1 by 16-byte cp.async, a thread a block (a warp
// instruction copies about two entries); 0 the same through registers; 2 a
// TMA bulk copy a row, a thread an entry
constexpr int kRowCopy = 1;
// the pull an instance takes: the pipelined one for bfloat16 upstream
// gradients; for float32 the block-synchronous one (`sync_pull`), its lists
// whole
template <typename GI>
constexpr bool kPipelined = sizeof(GI) == 2;
constexpr int kMaxC = 32;               // channels: a lane each
constexpr int kIndexWarps = 8;
constexpr int kIndexThreads = 32 * kIndexWarps;
constexpr int kRounds = 2;              // of 32 points, for an index warp
constexpr int kSpan = kIndexWarps * kRounds * 32;   // points of an index block
constexpr int kMaxTiles = 4096;         // the index's per-warp histograms
constexpr int kMaxOrderedTiles = 1024;  // longest list first up to this many
constexpr int kScanBatch = 16;          // the scan's loads in flight a thread

static_assert(kTileY % kWarpY == 0 && kTileX % kWarpX == 0, "warp cells");
static_assert(kChunk % 32 == 0 && kChunk <= 256, "chunk size");
static_assert(kKeys < 256, "anchor keys are 8 bits");
static_assert(kIndexWarps >= 4, "the last index block's four tile arrays");
static_assert(kRowStages >= 1 && kMetaStages >= kRowStages, "rings");
static_assert(kChunk <= kSumThreads, "a summing thread an entry (TMA)");

// A point's anchor cell (its (x0, y0) tap) on the quarter-res map, the tap
// steps (0 at a clamped border) and the weights: `quarter_point`'s, so the
// forward's to the bit.
struct Anchor {
  int y, x, ddy, ddx;
  float wx, owx, wy, owy, m;
};

__device__ __forceinline__ Anchor anchor_of(float2 n, float m, int fh,
                                            int fw) {
  const Point q = quarter_point(n, fh, fw, 1, m);
  Anchor a;
  a.y = q.o00 / fw;
  a.x = q.o00 - a.y * fw;
  a.ddx = q.dx;
  a.ddy = q.dy != 0;
  a.wx = q.wx;
  a.owx = q.owx;
  a.wy = q.wy;
  a.owy = q.owy;
  a.m = q.m;
  return a;
}

// The tiles that a point's four taps reach, each once: its anchor's, then
// the one right of it, below it and below-right when a tap crosses into
// them (-1 where none).
__device__ __forceinline__ void tile_keys(const Anchor& a, int ntx,
                                          int keys[4]) {
  const int ty = a.y / kTileY, tx = a.x / kTileX;
  const int ty1 = (a.y + a.ddy) / kTileY, tx1 = (a.x + a.ddx) / kTileX;
  keys[0] = ty * ntx + tx;
  keys[1] = tx1 != tx ? ty * ntx + tx1 : -1;
  keys[2] = ty1 != ty ? ty1 * ntx + tx : -1;
  keys[3] = tx1 != tx && ty1 != ty ? ty1 * ntx + tx1 : -1;
}

// One round of a warp's stable counting: each lane with a key >= 0 gets the
// number of entries of its key counted before (hist) plus those of the
// lower lanes of this round; hist then counts this round too. All 32 lanes
// call it.
__device__ __forceinline__ int warp_rank(int* hist, int key) {
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  const int lane = threadIdx.x & 31;
  const int rank =
      key >= 0 ? hist[key] + __popc(peers & ((1u << lane) - 1u)) : 0;
  __syncwarp();
  if (key >= 0 && lane == __ffs(peers) - 1) hist[key] += __popc(peers);
  __syncwarp();
  return rank;
}

// The transpose of `blend` for one channel: g times the mask, times each tap
// weight in the order the forward multiplied them, added into the map. Only
// the full-res image's gradient uses it (scalar atomics, see the note).
__device__ __forceinline__ void splat(float* __restrict__ map, const Point& q,
                                      float g) {
  const float a = g * q.m;
  const float top = a * q.owy;
  const float bot = a * q.wy;
  float* t = map + q.o00;
  atomicAdd(t, top * q.owx);
  atomicAdd(t + q.dx, top * q.wx);
  atomicAdd(t + q.dy, bot * q.owx);
  atomicAdd(t + q.dy + q.dx, bot * q.wx);
}

// The bfloat16 instance's image gradient (`_feg_bwd`'s RGB channels of
// d_packed, fused_gather.py:159-177): for each full-res pixel of the point's
// 8 x 8 window (origin (wy, wx), the quarter-res window's anchor times 4),
// (g*m x its row weight) x its column weight, each row or column weight the
// sum of the taps landing on it (`_interp_from_win`'s 8-slot weights),
// rounded to bfloat16 and added (scalar atomics) into the float32 map that
// the wrapper rounds once. Pixels no tap reaches add 0 and are skipped,
// unless g*m is not finite: then every pixel of the window gets its
// product, NaN where the weight is 0, as in JAX.
__device__ __forceinline__ void splat_bf16(float* __restrict__ map,
                                           const Point& q, float g, int W,
                                           int wy, int wx) {
  const float a = g * q.m;
  if (a == 0.0f) return;
  const int x0 = q.o00 / 3 % W, y0 = q.o00 / 3 / W;
  const int x1 = x0 + (q.dx != 0), y1 = y0 + (q.dy != 0);
  if (isfinite(a)) {
    const float r[2] = {q.dy ? q.owy : q.owy + q.wy, q.wy};
    const float c[2] = {q.dx ? q.owx : q.owx + q.wx, q.wx};
    for (int i = 0; i <= (q.dy != 0); ++i)
      for (int j = 0; j <= (q.dx != 0); ++j)
        atomicAdd(map + 3 * ((y0 + i) * W + x0 + j),
                  round_bf16(a * r[i] * c[j]));
    return;
  }
  const int uy0 = min(max(y0 - wy, 0), 7), uy1 = min(max(y1 - wy, 0), 7);
  const int ux0 = min(max(x0 - wx, 0), 7), ux1 = min(max(x1 - wx, 0), 7);
  for (int i = 0; i < 8; ++i) {
    const float rw = (uy0 == i ? q.owy : 0.0f) + (uy1 == i ? q.wy : 0.0f);
    for (int j = 0; j < 8; ++j) {
      const float cw = (ux0 == j ? q.owx : 0.0f) + (ux1 == j ? q.wx : 0.0f);
      atomicAdd(map + 3 * ((wy + i) * W + wx + j), round_bf16(a * rw * cw));
    }
  }
}

// The index's scratch (int32), per view: first what the memset zeroes (the
// count pass's tickets and non-finite flags), then the pull's tickets of
// split tiles (zeroed by the count pass), [chunk][tile] counts (offsets
// after the
// scan), tile starts, the number of work items, the work items (tile, list
// begin, list end, range | ranges << 16) in the order the pull takes them,
// the tile lists, and the split work items' partial sums. A list entry is
// a point in one tile's list: its index (bit 31 set where it is invalid),
// its anchor's key in the tile's region with its tap steps and mask
// (key | ddx << 8 | ddy << 9 | m << 10), and its weights wx, wy.
struct Index {
  int* tickets;
  int* flags;
  int* tile_tickets;
  int* table;
  int* starts;
  int* nitems;
  int4* items;
  int4* lists;
  float* partials;
  int chunks, ntx, tiles, item_cap;
  long long list_cap, zeroed, ints, starts_at, nitems_at;
};

// floats of one work item's partial sums: its cells x both maps x kMaxC
constexpr int kPartial = kTileY * kTileX * 2 * kMaxC;

Index index_layout(int* scratch, int V, int P, int fh, int fw) {
  Index x;
  x.chunks = (P + kSpan - 1) / kSpan;
  x.ntx = (fw + kTileX - 1) / kTileX;
  x.tiles = (fh + kTileY - 1) / kTileY * x.ntx;
  x.list_cap = 4LL * P;   // a point is in at most four tile lists
  // a tile's list in ranges of at most kSplit chunks, one range at least:
  // fewer than tiles + entries / (kSplit * kChunk) + 1 work items a view
  x.item_cap = static_cast<int>(x.tiles + x.list_cap / (kSplit * kChunk) + 1);
  const long long tile_tickets = 2LL * V;
  x.zeroed = tile_tickets;
  const long long table = tile_tickets + 1LL * V * x.tiles,
                  starts = table + 1LL * V * x.chunks * x.tiles,
                  nitems = starts + 1LL * V * (x.tiles + 1),
                  items = (nitems + V + 3) / 4 * 4,
                  lists = items + 4LL * V * x.item_cap,
                  partials = lists + 4LL * V * x.list_cap;
  x.ints = partials + 1LL * V * x.item_cap * kPartial;
  x.starts_at = starts;
  x.nitems_at = nitems;
  const auto at = [scratch](long long o) {
    return scratch == nullptr ? nullptr : scratch + o;
  };
  x.tickets = at(0);
  x.flags = at(V);
  x.tile_tickets = at(tile_tickets);
  x.table = at(table);
  x.starts = at(starts);
  x.nitems = at(nitems);
  x.items = reinterpret_cast<int4*>(at(items));
  x.lists = reinterpret_cast<int4*>(at(lists));
  x.partials = reinterpret_cast<float*>(at(partials));
  return x;
}

// Whether a row of n <= 32 elements of T (float or bf16) is all finite
// (not inf, not NaN): load() issues 16-byte loads of the blocks that hold
// it, finite() reads them, so that other work can run while they are in
// flight.
template <typename T>
struct RowCheck {
  static constexpr int kPer = 16 / sizeof(T);   // elements a block
  uint4 u[9];
  int skip;

  __device__ __forceinline__ void load(const T* __restrict__ row, int n) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row);
    const uint4* p = reinterpret_cast<const uint4*>(lo & ~uintptr_t{15});
    skip = static_cast<int>(lo & 15) / static_cast<int>(sizeof(T));
#pragma unroll
    for (int i = 0; i < 9; ++i)
      u[i] = kPer * i < skip + n ? __ldg(p + i) : make_uint4(0, 0, 0, 0);
  }

  __device__ __forceinline__ bool finite(int n) const {
    bool bad = false;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      const unsigned e[4] = {u[i].x, u[i].y, u[i].z, u[i].w};
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int k = kPer * i + j;
        unsigned x;   // the element's bits, its sign at bit 31
        if constexpr (sizeof(T) == 4)
          x = e[j];
        else
          x = e[j / 2] >> (16 * (j % 2)) << 16;
        // the exponent bits all set: inf or NaN
        bad |= k >= skip && k < skip + n && (x & 0x7f800000u) == 0x7f800000u;
      }
    }
    return !bad;
  }
};

// Exclusive prefix sums of in[0, n) into out[0, n), by the whole index
// block, in batches of its threads; returns the total. in and out may be
// one array.
__device__ int block_scan(const int* in, int* out, int n, int* warp_sums) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += kIndexThreads) {
    const int i = i0 + threadIdx.x;
    const int k = i < n ? in[i] : 0;
    int incl = k;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[w] = incl;
    __syncthreads();
    int before = carry;
    for (int u = 0; u < w; ++u) before += warp_sums[u];
    if (i < n) out[i] = before + incl - k;
    for (int u = 0; u < kIndexWarps; ++u) carry += warp_sums[u];
    __syncthreads();
  }
  return carry;
}

// Index passes, one launch each, the same blocks: block c takes the chunk
// of kSpan points [c * kSpan, (c + 1) * kSpan) of view blockIdx.y, warp w
// the kRounds rounds of 32 consecutive points from c * kSpan + w * 32 *
// kRounds (coordinates loaded first, all rounds at once); each point enters
// the lists of the tiles its taps reach (`tile_keys`, in slot order),
// counted in the warp's histogram (`warp_rank`). kFill = false writes the
// chunk's count of each tile into table; the last block of a view to finish
// (tickets) turns the counts into each chunk's offset in each tile's list,
// the tiles' totals into starts, orders the tiles by the length of
// their lists, longest first (ties by index; by index alone above
// kMaxOrderedTiles tiles), so that the pull starts the longest lists first,
// and cuts each list into ranges of at most kSplit chunks (bfloat16; float32
// lists stay whole, for its block-synchronous pull): the view's work
// items, in that order. kFill = true recounts the same way, so
// the ranks agree, and writes each point's entry at starts[tile] +
// offset[chunk][tile] + the counts of the warps before it + its rank: a
// stable counting sort, so a tile's list is in the order (warp, round,
// slot, lane) of the points, by index but for the slot. An entry holds what
// the pull needs of its point: its anchor's key in that tile's region, tap
// steps and weights. Invalid points are
// in no list; the fill pass checks their upstream rows and flags the view
// (flags) where one holds inf or NaN. The count pass also splats d_rgb's
// RGB channels into d_imgs when it is not null. GI, GR: the upstream
// gradients' types (d_rgb, d_ray).
template <bool kFill, typename GI, typename GR>
__global__ void __launch_bounds__(kIndexThreads)
index_kernel(const float* __restrict__ xy,
             const unsigned char* __restrict__ valid,
             const GI* __restrict__ d_rgb, const GR* __restrict__ d_ray,
             float* __restrict__ d_imgs,
             Index x, int P, int H, int W, int fh, int fw, int C) {
  extern __shared__ int hists[];   // kIndexWarps x tiles
  __shared__ int warp_sums[kIndexWarps];
  __shared__ bool last;
  const int v = blockIdx.y, c = blockIdx.x;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  int* hist = hists + w * x.tiles;
  int* table = x.table + static_cast<size_t>(v) * x.chunks * x.tiles;
  int* starts = x.starts + static_cast<size_t>(v) * (x.tiles + 1);
  int4* list = x.lists + v * x.list_cap;
  xy += 2 * static_cast<size_t>(v) * P;
  valid += static_cast<size_t>(v) * P;
  for (int i = threadIdx.x; i < kIndexWarps * x.tiles; i += kIndexThreads)
    hists[i] = 0;
  const int p0 = c * kSpan + w * kRounds * 32;
  float2 pxy[kRounds];
  float pm[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = p0 + 32 * r + lane;
    pxy[r] = p < P ? make_float2(xy[2 * p], xy[2 * p + 1]) : make_float2(0, 0);
    pm[r] = p < P && valid[p] ? 1.0f : 0.0f;
  }
  __syncthreads();
  int keys[kRounds][4], ranks[kRounds][4];
  // the fill pass's entries: each round's anchor (y | ddy << 30, x | ddx <<
  // 30) and weights
  int ay[kRounds], ax[kRounds];
  float awx[kRounds], awy[kRounds];
  bool nonfinite = false;   // an invalid point's upstream rows: inf or NaN
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = p0 + 32 * r + lane;
    const size_t vp = static_cast<size_t>(v) * P + p;
    // invalid points stay out of the lists; the fill pass checks their
    // upstream rows while the ranks run
    const bool out = kDropInvalid && pm[r] == 0.0f;
    const bool check = kFill && out && p < P;
    RowCheck<GI> row_i;
    RowCheck<GR> row_r;
    if (check) {
      row_i.load(d_rgb + vp * (3 + C) + 3, C);
      row_r.load(d_ray + vp * C, C);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) keys[r][s] = -1;
    if (p < P) {
      const float2 n = normalised(pxy[r], H, W);
      if (!out) {
        const Anchor a = anchor_of(n, pm[r], fh, fw);
        tile_keys(a, x.ntx, keys[r]);
        ay[r] = a.y | a.ddy << 30;
        ax[r] = a.x | a.ddx << 30;
        awx[r] = a.wx;
        awy[r] = a.wy;
      }
      if (!kFill && d_imgs != nullptr) {
        const Point q = full_point(n, H, W, pm[r]);
        float* map = d_imgs + static_cast<size_t>(v) * H * W * 3;
        if constexpr (sizeof(GI) == 2) {   // the bfloat16 instance
          const Anchor a = anchor_of(n, pm[r], fh, fw);
          const int wy = 4 * min(a.y, fh - 2), wx = 4 * min(a.x, fw - 2);
          for (int ch = 0; ch < 3; ++ch)
            splat_bf16(map + ch, q, to_f(d_rgb[vp * (3 + C) + ch]), W, wy,
                       wx);
        } else {
          for (int ch = 0; ch < 3; ++ch)
            splat(map + ch, q, d_rgb[vp * (3 + C) + ch]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) ranks[r][s] = warp_rank(hist, keys[r][s]);
    if (check) nonfinite |= !row_i.finite(C) || !row_r.finite(C);
  }
  if (__syncthreads_or(nonfinite) && threadIdx.x == 0) atomicOr(x.flags + v, 1);
  // per tile: the warps' counts become their offsets in the chunk (the
  // barrier above ends the ranks)
  for (int t = threadIdx.x; t < x.tiles; t += kIndexThreads) {
    int run = 0;
    for (int u = 0; u < kIndexWarps; ++u) {
      const int h = hists[u * x.tiles + t];
      hists[u * x.tiles + t] = run;
      run += h;
    }
    if (!kFill) table[c * x.tiles + t] = run;
  }
  __syncthreads();
  if (kFill) {
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      if (keys[r][0] < 0) continue;
      const int y = ay[r] & 0x3fffffff, xx = ax[r] & 0x3fffffff;
      const int ddy = ay[r] >> 30, ddx = ax[r] >> 30;
      const int bits = ddx << 8 | ddy << 9 | (pm[r] != 0.0f) << 10;
      const int p = p0 + 32 * r + lane;
      // the tiles' first rows and columns (`tile_keys`' slots: the anchor's
      // tile, right of it, below it, below-right)
      const int ty0 = y / kTileY * kTileY, ty1 = (y + ddy) / kTileY * kTileY;
      const int tx0 = xx / kTileX * kTileX, tx1 = (xx + ddx) / kTileX * kTileX;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = keys[r][s];
        if (k < 0) continue;
        // the anchor in tile k's region (its top and left halo row 0)
        const int key = (y - (s < 2 ? ty0 : ty1) + 1) * (kTileX + 1) + xx -
                        (s % 2 == 0 ? tx0 : tx1) + 1;
        list[starts[k] + table[c * x.tiles + k] + hist[k] + ranks[r][s]] =
            make_int4(p | (pm[r] != 0.0f ? 0 : static_cast<int>(0x80000000u)),
                      key | bits, __float_as_int(awx[r]),
                      __float_as_int(awy[r]));
      }
    }
    return;
  }

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(x.tickets + v, 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // entries a work item of the pipelined pull takes at most; the
  // block-synchronous pull's lists stay whole
  constexpr int kRange = kSplit * kChunk;
  // The view's last block: per tile, the exclusive sum over chunks (in
  // place) and its total, then the exclusive sum of the totals.
  for (int t = threadIdx.x; t < x.tiles; t += kIndexThreads) {
    int total = 0;
    for (int k0 = 0; k0 < x.chunks; k0 += kScanBatch) {   // loads first
      int n[kScanBatch];
#pragma unroll
      for (int k = 0; k < kScanBatch; ++k)
        n[k] = k0 + k < x.chunks ? __ldcg(table + (k0 + k) * x.tiles + t) : 0;
#pragma unroll
      for (int k = 0; k < kScanBatch; ++k) {
        if (k0 + k < x.chunks) table[(k0 + k) * x.tiles + t] = total;
        total += n[k];
      }
    }
    hists[t] = total;
  }
  __syncthreads();
  const int entries = block_scan(hists, starts, x.tiles, warp_sums);
  if (threadIdx.x == 0) starts[x.tiles] = entries;
  // by position in the pull's order: the tile, its ranges, its first item
  // (the pipelined pull; a block-synchronous list is one work item, written
  // at once)
  int* by_pos = hists + x.tiles;
  int* ranges = hists + 2 * x.tiles;
  int* first = hists + 3 * x.tiles;
  int4* item = x.items + static_cast<size_t>(v) * x.item_cap;
  for (int t = threadIdx.x; t < x.tiles; t += kIndexThreads) {
    int r = t;
    const int n = hists[t];
    if (x.tiles <= kMaxOrderedTiles) {
      r = 0;
      for (int u = 0; u < x.tiles; ++u) {
        const int m = hists[u];
        r += m > n || (m == n && u < t);
      }
    }
    if constexpr (kPipelined<GI>) {
      by_pos[r] = t;
      ranges[r] = max(1, (n + kRange - 1) / kRange);
      x.tile_tickets[v * x.tiles + t] = 0;   // for the pull's split lists
    } else {
      const int begin = __ldcg(starts + t);   // written by this block
      item[r] = make_int4(t, begin, begin + n, 1 << 16);
    }
  }
  if constexpr (!kPipelined<GI>) {
    if (threadIdx.x == 0) x.nitems[v] = x.tiles;
    return;
  }
  __syncthreads();
  const int items = block_scan(ranges, first, x.tiles, warp_sums);
  if (threadIdx.x == 0) x.nitems[v] = items;
  for (int r = threadIdx.x; r < x.tiles; r += kIndexThreads) {
    const int t = by_pos[r], nr = ranges[r];
    const int begin = __ldcg(starts + t), end = begin + hists[t];
    for (int j = 0; j < nr; ++j)
      item[first[r] + j] = make_int4(t, begin + j * kRange,
                                     min(end, begin + (j + 1) * kRange),
                                     j | nr << 16);
  }
}

// A chunk's record of an entry, in its meta stage: the 2 x 2 window's folded
// weights (`pull_entry_bf16`), where its rows start in the row stage (d_rgb's
// | tap steps and mask << 16, d_ray's).
struct __align__(16) Record {
  float4 w;
  int rgb, ray, pad0, pad1;
};

// The pull: block w takes work item w / V of view w % V (a tile, or one
// range of a long tile list; the views' i-th items together, longest
// first). Its producer warp walks the item's list kChunk entries at a
// time; its kSumWarps summing warps each own kWarpY x kWarpX cells of the
// tile, a lane channel c of both maps, summing them in registers. For each
// chunk the producer (its entries already in its buffer: the next chunk's
// land by cp.async meanwhile), in the chunk's meta stage (kMetaStages of
// them, the producer up to that many chunks ahead),
//   1. writes each entry's copy job (where its two gradient rows, d_rgb's
//      channels 3.. and d_ray, start and how many 16-byte blocks hold
//      them) and the header, and arrives on `jobs_full`;
//   2. ranks the entries by key (warp_rank, round by round, so stably),
//      turns the counts into each key's segment and writes each entry's
//      record (weights, tap steps, where its rows start) to its place, and
//      arrives on `meta_full`.
// The summing warps copy each chunk's rows, in their own dtype, into the
// row stage (`copy_rows`: a thread a 16-byte block; completion counted on
// `rows_full`) once `jobs_full` says the jobs are there and `rows_empty`
// that every summing warp is done with the chunk before (so with one row
// stage the copies run while the warps finish work items and the producer
// sorts); then each waits on `meta_full` and `rows_full`, walks the (kWarpY
// + 1) x (kWarpX + 1) anchor cells whose taps can reach its cells, in
// row-major order, each segment in list order, adds each entry's
// contributions to the cells its taps land on (`pull_entry_bf16`), and
// arrives on `rows_empty` and `meta_empty` (which the producer waits on
// before it fills the meta stage again). After the item's last chunk the
// summing warps write each cell once; a range of a split list writes its
// partial sums, and the range whose ticket comes last adds the ranges'
// partials in range order (0, 1, ...) and writes the cells. So a cell sums
// range by range, chunk by chunk, its four anchor cells (y-1,x-1), (y-1,x),
// (y,x-1), (y,x) in turn, each in list order: a fixed order, the same
// whichever range comes last. The bfloat16 instance takes it (`kPipelined`): GI and
// GR are the upstream gradients' types (d_rgb, d_ray), O the maps'
// gradients'.
// Adds an entry to the kWarpY x kWarpX cells a warp owns, from anchor (ar,
// ac) of their (kWarpY + 1) x (kWarpX + 1) (constants once unrolled): the
// cell kY rows below and kX columns right of the anchor gets, in `splat`'s
// order, g*m times the row weight of each row tap that lands on it (top,
// then bottom), times the column weight of each column tap that does (x0,
// then x1). At a clamped border both taps of a pair land on one cell and
// both are added.
template <int WY, int WX>
__device__ __forceinline__ void pull_entry(float ai[WY][WX], float ar[WY][WX],
                                           int kAr, int kAc, float gi,
                                           float gr, float4 q, int ddy,
                                           int ddx) {
#pragma unroll
  for (int cy = 0; cy < WY; ++cy) {
    const int kY = cy + 1 - kAr;
    if (kY < 0 || kY > 1) continue;
    const bool top = kY == 0, bot = ddy == kY;
    const float ti = gi * q.w, tr = gr * q.w;   // owy
    const float bi = gi * q.z, br = gr * q.z;   // wy
#pragma unroll
    for (int cx = 0; cx < WX; ++cx) {
      const int kX = cx + 1 - kAc;
      if (kX < 0 || kX > 1) continue;
      const bool x0 = kX == 0, x1 = ddx == kX;
      if (top) {
        if (x0) { ai[cy][cx] += ti * q.y; ar[cy][cx] += tr * q.y; }   // owx
        if (x1) { ai[cy][cx] += ti * q.x; ar[cy][cx] += tr * q.x; }   // wx
      }
      if (bot) {
        if (x0) { ai[cy][cx] += bi * q.y; ar[cy][cx] += br * q.y; }
        if (x1) { ai[cy][cx] += bi * q.x; ar[cy][cx] += br * q.x; }
      }
    }
  }
}

// The bfloat16 instance's `pull_entry`: `_feg_bwd` on bfloat16 maps. A
// point adds to each cell its taps land on once, g*m times the cell's
// folded weight (rw * cw: a row's weight is owy or wy, owy + wy where a
// clamped border puts both row taps on it; the same for columns), rounded
// to bfloat16 (the transpose of the maps' bfloat16 -> float32 promotion)
// before the float32 sum, as `_interp_from_win` and `_splat_windows` do
// (fused_gather.py:137-144, 214-229). Cells of a point's window that no
// tap reaches (weight 0) add 0 and are skipped.
// q: the window's weights (W00, W01, W10, W11), Wab = rw_a * cw_b with
// rw_0 = owy (+ wy where ddy is 0), rw_1 = wy, cw_0 = owx (+ wx where ddx is
// 0), cw_1 = wx, folded and multiplied by the producer. Both maps' products
// round to bfloat16 in one conversion (cvt.rn.bf16x2, each half rounded to
// the nearest).
__device__ __forceinline__ void pull_entry_bf16(float ai[kWarpY][kWarpX],
                                                float ar[kWarpY][kWarpX],
                                                int kAr, int kAc, float gi,
                                                float gr, float4 q, int ddy,
                                                int ddx) {
#pragma unroll
  for (int cy = 0; cy < kWarpY; ++cy) {
    const int kY = cy + 1 - kAr;
    if (kY < 0 || kY > ddy) continue;
#pragma unroll
    for (int cx = 0; cx < kWarpX; ++cx) {
      const int kX = cx + 1 - kAc;
      if (kX < 0 || kX > ddx) continue;
      const float w = kY == 0 ? (kX == 0 ? q.x : q.y) : (kX == 0 ? q.z : q.w);
      const __nv_bfloat162 b = __floats2bfloat162_rn(gi * w, gr * w);
      const unsigned u = *reinterpret_cast<const unsigned*>(&b);
      ai[cy][cx] += __uint_as_float(u << 16);
      ar[cy][cx] += __uint_as_float(u & 0xffff0000u);
    }
  }
}

// Shared memory of a pull block: kRowStages row stages, each a chunk's
// gradient rows in slots of 16-byte blocks (a row of kMaxC elements at any
// 2- or 4-byte offset fits); kMetaStages meta stages, each a chunk's
// records in sorted order, its entries' copy jobs, the keys' segments and a
// header; then the producer's histogram and entries (two chunks' list
// entries, the next one's landing while this one is sorted), the summing
// warps' NaN bits and ticket, and the barriers. (A meta stage's jobs: each entry's rows' first
// 16-byte blocks, d_rgb's then d_ray's, at kJobs; their block counts,
// d_rgb's | d_ray's << 8, at kJobBlocks.)
template <typename GI, typename GR>
struct PullSmem {
  static constexpr int kRgbSlot = kMaxC * sizeof(GI) + 16;
  static constexpr int kRaySlot = kMaxC * sizeof(GR) + 16;
  // 16-byte blocks an entry's rows take at most
  static constexpr int kBlocks = kRgbSlot / 16 + kRaySlot / 16;
  // a row stage: rgb slots, then ray slots
  static constexpr int kRay = kChunk * kRgbSlot;
  static constexpr int kRowStage = kRay + kChunk * kRaySlot;
  // a meta stage: records, the entries' copy jobs (each row's first
  // 16-byte block, the two rows' block counts), segments, header
  static constexpr int kRecs = 0;
  static constexpr int kJobs = kRecs + sizeof(Record) * kChunk;
  static constexpr int kJobBlocks = kJobs + 16 * kChunk;
  static constexpr int kSeg = kJobBlocks + 4 * kChunk;
  static constexpr int kHdr = kSeg + (4 * (kKeys + 1) + 15) / 16 * 16;
  static constexpr int kMetaStage = kHdr + 32;
  static constexpr int kMeta = kRowStages * kRowStage;
  static constexpr int kHist = kMeta + kMetaStages * kMetaStage;
  static constexpr int kEntries = kHist + (4 * kKeys + 15) / 16 * 16;
  static constexpr int kBits = kEntries + 2 * 16 * kChunk;
  static constexpr int kBars = kBits + 4 * (2 * kTileY * kTileX + 4);
  // barriers: jobs_full, meta_full, meta_empty a meta stage, rows_full,
  // rows_empty a row stage
  static constexpr int kBytes = kBars + 8 * (3 * kMetaStages + 2 * kRowStages);
  static_assert(kRgbSlot % 16 == 0 && kRaySlot % 16 == 0 &&
                    kRowStage % 16 == 0 && kMetaStage % 16 == 0 &&
                    kBars % 8 == 0,
                "copy destinations 16-byte aligned");
  static_assert(kRay < 65536, "d_rgb rows' offsets are 16 bits");
};

// A meta stage's header: the item's view, tile, index in its view, range
// and ranges, what the chunk is to the item, its entries, and whether the
// view takes the NaN path
constexpr int kFirstChunk = 1, kLastChunk = 2, kNoWork = 4;
struct Header {
  int v, tile, item, flags, range, ranges, n, nan;
};

// mbarrier and copy primitives (sm_90)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// an arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// an arrival once the thread's cp.async copies so far have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Waits for the phase of the given parity to complete. A wait that lasts
// seconds (2^26 tries; a legitimate one lasts microseconds) traps, so that a
// fault in the pipeline ends the launch with an error instead of hanging
// the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == 1u << 26) __trap();
  }
}
// The wait of the q-th use of a ring of `size` barriers for that use's
// phase to complete (full), or (free) for the phase before it, which
// passes at once on the first use.
__device__ __forceinline__ void ring_wait(uint64_t* ring, int size, int q,
                                          bool free) {
  bar_wait(ring + q % size, (q / size & 1) ^ static_cast<unsigned>(free));
}
// the summing warps' own barrier (the producer never joins it)
__device__ __forceinline__ void sum_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kSumThreads) : "memory");
}

// Where a row starts in its first 16-byte block, and how many blocks hold
// its n elements.
template <typename T>
__device__ __forceinline__ int row_skip(const T* row) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
}
template <typename T>
__device__ __forceinline__ int row_blocks(const T* row, int n) {
  return (row_skip(row) + n * static_cast<int>(sizeof(T)) + 15) >> 4;
}
template <typename T>
__device__ __forceinline__ const char* row_base(const T* row) {
  return reinterpret_cast<const char*>(row) - row_skip(row);
}

// A chunk's list entries, the n at list, into buf by cp.async (a commit
// group)
__device__ __forceinline__ void fetch_entries(int4* buf, const int4* list,
                                              int n) {
  for (int e = threadIdx.x & 31; e < n; e += 32)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(
                     smem_addr(buf + e)),
                 "l"(list + e)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The producer warp (see the pull's note): per chunk, its meta stage.
template <typename GI, typename GR>
__device__ __forceinline__ void produce(unsigned char* smem,
                                        uint64_t* jobs_full,
                                        uint64_t* meta_full,
                                        uint64_t* meta_empty,
                                        const GI* __restrict__ d_rgb,
                                        const GR* __restrict__ d_ray,
                                        const Index& x, int V, int P, int C) {
  using S = PullSmem<GI, GR>;
  constexpr int kR = kChunk / 32;   // entries a lane
  const int lane = threadIdx.x & 31;
  int* hist = reinterpret_cast<int*>(smem + S::kHist);
  // the block's work item: item i of view v
  const int v = blockIdx.x % V, i = blockIdx.x / V;
  const int4 item = x.items[static_cast<size_t>(v) * x.item_cap + i];
  const int tile = item.x, begin = item.y, end = item.z;
  const int nan = kDropInvalid && x.flags[v];
  const int4* list = x.lists + v * x.list_cap;
  const size_t vp = static_cast<size_t>(v) * P;
  int4* buf = reinterpret_cast<int4*>(smem + S::kEntries);
  fetch_entries(buf, list + begin, min(kChunk, end - begin));
  int q = 0;   // chunks so far
  for (int b = begin;; b += kChunk, ++q) {
    {
      const int n = min(kChunk, end - b);
      const bool last = b + kChunk >= end;
      // the next chunk's entries start to land; this chunk's have
      if (!last) {
        fetch_entries(buf + (q + 1) % 2 * kChunk, list + b + kChunk,
                      min(kChunk, end - b - kChunk));
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncwarp();
      int4 ent[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r)
        ent[r] = 32 * r + lane < n ? buf[q % 2 * kChunk + 32 * r + lane]
                                   : make_int4(0, 0, 0, 0);
      ring_wait(meta_empty, kMetaStages, q, true);
      unsigned char* meta = smem + S::kMeta + q % kMetaStages * S::kMetaStage;
      const char** jobs = reinterpret_cast<const char**>(meta + S::kJobs);
      int* job_blocks = reinterpret_cast<int*>(meta + S::kJobBlocks);
      // the entries' copy jobs
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int e = 32 * r + lane;
        if (e < n) {
          const size_t p = vp + (ent[r].x & 0x7fffffff);
          const GI* ri = d_rgb + p * (3 + C) + 3;
          const GR* rr = d_ray + p * C;
          jobs[2 * e] = row_base(ri);
          jobs[2 * e + 1] = row_base(rr);
          const int bi = row_blocks(ri, C), br = row_blocks(rr, C);
          job_blocks[e] = bi | br << 8;
        }
      }
      if (lane == 0) {
        Header* h = reinterpret_cast<Header*>(meta + S::kHdr);
        h->v = v;
        h->tile = tile;
        h->item = i;
        h->flags = (b == begin ? kFirstChunk : 0) | (last ? kLastChunk : 0);
        h->range = item.w & 0xffff;
        h->ranges = item.w >> 16;
        h->n = n;
        h->nan = nan;
      }
      __syncwarp();
      // the summing warps may start the rows' copies
      if (lane == 0) bar_arrive(jobs_full + q % kMetaStages);
      // the ranks by key, round by round, then the keys' segments
      for (int k = lane; k < kKeys; k += 32) hist[k] = 0;
      __syncwarp();
      int key[kR], rank[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        key[r] = 32 * r + lane < n ? ent[r].y & 0xff : -1;
        rank[r] = warp_rank(hist, key[r]);
      }
      int* seg = reinterpret_cast<int*>(meta + S::kSeg);
      {
        int run[kKeysPerLane], sum = 0;
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          const int k = lane * kKeysPerLane + j;
          run[j] = k < kKeys ? hist[k] : 0;
          sum += run[j];
        }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += y;
        }
        int base = incl - sum;
#pragma unroll
        for (int j = 0; j < kKeysPerLane; ++j) {
          const int k = lane * kKeysPerLane + j;
          if (k < kKeys) seg[k] = base;
          base += run[j];
        }
        if (lane == 31) seg[kKeys] = incl;
      }
      __syncwarp();
      // each entry's record in its key's segment, in list order
      Record* recs = reinterpret_cast<Record*>(meta + S::kRecs);
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (key[r] >= 0) {
          const float wx = __int_as_float(ent[r].z),
                      wy = __int_as_float(ent[r].w);
          const float owx = 1.0f - wx, owy = 1.0f - wy;
          Record rec;
          const float c0 = ent[r].y >> 8 & 1 ? owx : owx + wx;
          const float r0 = ent[r].y >> 9 & 1 ? owy : owy + wy;
          rec.w = make_float4(r0 * c0, r0 * wx, wy * c0, wy * wx);
          // where the rows start in a row stage
          const int e = 32 * r + lane;
          const size_t p = vp + (ent[r].x & 0x7fffffff);
          rec.rgb = (e * S::kRgbSlot + row_skip(d_rgb + p * (3 + C) + 3)) |
                    (ent[r].y >> 8 & 7) << 16;
          rec.ray = S::kRay + e * S::kRaySlot + row_skip(d_ray + p * C);
          recs[seg[key[r]] + rank[r]] = rec;
        }
      __syncwarp();
      if (lane == 0) bar_arrive(meta_full + q % kMetaStages);
      if (last) break;
    }
  }
  ++q;
  // no work left: the summing warps stop at this chunk
  ring_wait(meta_empty, kMetaStages, q, true);
  if (lane == 0) {
    unsigned char* meta = smem + S::kMeta + q % kMetaStages * S::kMetaStage;
    reinterpret_cast<Header*>(meta + S::kHdr)->flags = kNoWork;
    bar_arrive(jobs_full + q % kMetaStages);
  }
}

// The summing warps' copies of a chunk's rows (its meta stage `meta`, with
// the copy jobs, header h) into a row stage, completing on `full`: each
// thread takes 16-byte blocks k = t, t + kSumThreads, ... of the chunk's
// entries' kBlocks slots each (a warp instruction copies about two
// entries), by cp.async (kRowCopy 1) or through registers (0); or (2) a
// thread an entry, a TMA bulk copy a row. Every summing thread arrives on
// full once.
template <typename GI, typename GR>
__device__ __forceinline__ void copy_rows(unsigned char* rows,
                                          const unsigned char* meta,
                                          const Header& h, uint64_t* full) {
  using S = PullSmem<GI, GR>;
  const int t = threadIdx.x;
  const char* const* jobs =
      reinterpret_cast<const char* const*>(meta + S::kJobs);
  const int* job_blocks = reinterpret_cast<const int*>(meta + S::kJobBlocks);
  if (kRowCopy == 2) {
    const int nb = t < h.n ? job_blocks[t] : 0;
    bar_arrive_tx(full, 16 * ((nb & 0xff) + (nb >> 8)));
    if (t < h.n) {
      unsigned char* dst[2] = {rows + t * S::kRgbSlot,
                               rows + S::kRay + t * S::kRaySlot};
      const int blocks[2] = {nb & 0xff, nb >> 8};
      for (int i = 0; i < 2; ++i)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst[i])),
            "l"(jobs[2 * t + i]), "r"(16 * blocks[i]), "r"(smem_addr(full))
            : "memory");
    }
    return;
  }
#pragma unroll 2
  for (int k = t; k < h.n * S::kBlocks; k += kSumThreads) {
    const int e = k / S::kBlocks, j = k - e * S::kBlocks;
    const int nb = job_blocks[e], bi = nb & 0xff;
    const bool img = j < bi;
    const int jj = img ? j : j - bi;
    if (img || jj < nb >> 8) {
      unsigned char* dst = rows + (img ? e * S::kRgbSlot
                                       : S::kRay + e * S::kRaySlot) + 16 * jj;
      const char* src = jobs[2 * e + !img] + 16 * jj;
      if (kRowCopy == 1)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         smem_addr(dst)),
                     "l"(src)
                     : "memory");
      else
        *reinterpret_cast<uint4*>(dst) =
            __ldg(reinterpret_cast<const uint4*>(src));
    }
  }
  if (kRowCopy == 1)
    bar_arrive_copies(full);
  else
    bar_arrive(full);
}

// A summing warp's sums over one anchor cell's segment of the chunk: its
// records (recs) and rows (rows, the row stage).
template <typename GI, typename GR>
__device__ __forceinline__ void pull_segment(
    float ai[kWarpY][kWarpX], float ar[kWarpY][kWarpX], int kAr, int kAc,
    const int* seg, const Record* recs, const unsigned char* rows, int k,
    int lane) {
  const int end = seg[k + 1];
#pragma unroll 1
  for (int j = seg[k]; j < end; ++j) {
    const float4 q = recs[j].w;
    const int2 at = *reinterpret_cast<const int2*>(&recs[j].rgb);
    float gi = to_f(*reinterpret_cast<const GI*>(rows + (at.x & 0xffff) +
                                                 lane * sizeof(GI)));
    float gr = to_f(*reinterpret_cast<const GR*>(rows + at.y +
                                                 lane * sizeof(GR)));
    if (!kDropInvalid && !(at.x >> 18 & 1)) {   // an invalid point: g * 0
      gi *= 0.0f;
      gr *= 0.0f;
    }
    pull_entry_bf16(ai, ar, kAr, kAc, gi, gr, q, at.x >> 17 & 1,
                    at.x >> 16 & 1);
  }
}

// A summing warp after an item's last chunk: a split list's range writes
// its partial sums and takes a ticket; the range that comes last, or an
// item that is its tile's whole list, has the cells' sums (the ranges'
// partials added in range order), sets the NaN path's cells and writes
// each of the warp's cells once.
template <bool kVec, typename GI, typename GR, typename O>
__device__ __forceinline__ void finish(
    float ai[kWarpY][kWarpX], float ar[kWarpY][kWarpX], const Header& h,
    unsigned* bits, const float* __restrict__ xy,
    const unsigned char* __restrict__ valid, const GI* __restrict__ d_rgb,
    const GR* __restrict__ d_ray, const Index& x,
    O* __restrict__ d_img_feats, O* __restrict__ d_ray_feats, int P, int H,
    int W, int fh, int fw, int C) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int by = w / (kTileX / kWarpX) * kWarpY;
  const int bx = w % (kTileX / kWarpX) * kWarpX;
  const int ty0 = h.tile / x.ntx * kTileY, tx0 = h.tile % x.ntx * kTileX;
  if (h.ranges > 1) {
    float* part = x.partials + (static_cast<size_t>(h.v) * x.item_cap + h.item) *
                                   kPartial;
#pragma unroll
    for (int cy = 0; cy < kWarpY; ++cy)
#pragma unroll
      for (int cx = 0; cx < kWarpX; ++cx) {
        const int cell = (by + cy) * kTileX + bx + cx;
        __stcg(part + (2 * cell) * kMaxC + lane, ai[cy][cx]);
        __stcg(part + (2 * cell + 1) * kMaxC + lane, ar[cy][cx]);
      }
    __threadfence();
    sum_sync();
    int* last = reinterpret_cast<int*>(bits + 2 * kTileY * kTileX);
    if (t == 0)
      *last = atomicAdd(x.tile_tickets + h.v * x.tiles + h.tile, 1) ==
              h.ranges - 1;
    sum_sync();
    if (!*last) return;
    __threadfence();
    const float* p0 = part - static_cast<size_t>(h.range) * kPartial;
#pragma unroll
    for (int cy = 0; cy < kWarpY; ++cy)
#pragma unroll
      for (int cx = 0; cx < kWarpX; ++cx) {
        const int cell = (by + cy) * kTileX + bx + cx;
        float si = __ldcg(p0 + (2 * cell) * kMaxC + lane);
        float sr = __ldcg(p0 + (2 * cell + 1) * kMaxC + lane);
        for (int r = 1; r < h.ranges; ++r) {
          si += __ldcg(p0 + r * kPartial + (2 * cell) * kMaxC + lane);
          sr += __ldcg(p0 + r * kPartial + (2 * cell + 1) * kMaxC + lane);
        }
        ai[cy][cx] = si;
        ar[cy][cx] = sr;
      }
  }
  // The NaN path, for a view where an invalid point has a non-finite
  // upstream value (its g * 0 is NaN): every cell of such a point's 2 x 2
  // window (its anchor clipped to [0, fh-2] x [0, fw-2]) gets NaN in those
  // channels (bits set with atomicOr: any order gives the same bits), as
  // `_feg_bwd` multiplies g * 0 by the zero weights too.
  if (h.nan) {
    const size_t vp = static_cast<size_t>(h.v) * P;
    for (int i = t; i < 2 * kTileY * kTileX; i += kSumThreads) bits[i] = 0;
    sum_sync();
    for (int p = t; p < P; p += kSumThreads) {
      if (valid[vp + p]) continue;
      Anchor a = anchor_of(normalised(xy + 2 * vp, p, H, W), 0.0f, fh, fw);
      a.y = min(a.y, fh - 2);   // the window
      a.x = min(a.x, fw - 2);
      a.ddy = a.ddx = 1;
      unsigned nb[2] = {0u, 0u};
      bool read = false;
      for (int dy = 0; dy <= a.ddy; ++dy)
        for (int dx = 0; dx <= a.ddx; ++dx) {
          const int ly = a.y + dy - ty0, lx = a.x + dx - tx0;
          if (ly < 0 || ly >= kTileY || lx < 0 || lx >= kTileX) continue;
          if (!read) {   // the channels where g is not finite
            for (int ch = 0; ch < C; ++ch) {
              nb[0] |= unsigned(!isfinite(to_f(d_rgb[(vp + p) * (3 + C) + 3 +
                                                     ch])))
                       << ch;
              nb[1] |= unsigned(!isfinite(to_f(d_ray[(vp + p) * C + ch])))
                       << ch;
            }
            read = true;
          }
          atomicOr(bits + ly * kTileX + lx, nb[0]);
          atomicOr(bits + kTileY * kTileX + ly * kTileX + lx, nb[1]);
        }
    }
    sum_sync();
#pragma unroll
    for (int cy = 0; cy < kWarpY; ++cy)
#pragma unroll
      for (int cx = 0; cx < kWarpX; ++cx) {
        const int cell = (by + cy) * kTileX + bx + cx;
        if (bits[cell] >> lane & 1) ai[cy][cx] = __int_as_float(0x7fffffff);
        if (bits[kTileY * kTileX + cell] >> lane & 1)
          ar[cy][cx] = __int_as_float(0x7fffffff);
      }
    sum_sync();   // the bits are read before the next item clears them
  }
  // each of the warp's cells once: four-channel stores (float4, or four
  // bf16 in 8 bytes) from lanes [0, C/4) (the four channels gathered by
  // shuffles), else one channel a lane
#pragma unroll
  for (int cy = 0; cy < kWarpY; ++cy)
#pragma unroll
    for (int cx = 0; cx < kWarpX; ++cx) {
      const int y = ty0 + by + cy, xc = tx0 + bx + cx;
      const size_t o = ((static_cast<size_t>(h.v) * fh + y) * fw + xc) * C;
      if (kVec) {
        float4 gi4, gr4;
        const int src = 4 * lane % 32;
        gi4.x = __shfl_sync(0xffffffffu, ai[cy][cx], src);
        gi4.y = __shfl_sync(0xffffffffu, ai[cy][cx], src + 1);
        gi4.z = __shfl_sync(0xffffffffu, ai[cy][cx], src + 2);
        gi4.w = __shfl_sync(0xffffffffu, ai[cy][cx], src + 3);
        gr4.x = __shfl_sync(0xffffffffu, ar[cy][cx], src);
        gr4.y = __shfl_sync(0xffffffffu, ar[cy][cx], src + 1);
        gr4.z = __shfl_sync(0xffffffffu, ar[cy][cx], src + 2);
        gr4.w = __shfl_sync(0xffffffffu, ar[cy][cx], src + 3);
        if (y < fh && xc < fw && 4 * lane < C) {
          store4(d_img_feats + o + 4 * lane, gi4);
          store4(d_ray_feats + o + 4 * lane, gr4);
        }
      } else if (y < fh && xc < fw && lane < C) {
        d_img_feats[o + lane] = from_f<O>(ai[cy][cx]);
        d_ray_feats[o + lane] = from_f<O>(ar[cy][cx]);
      }
    }
}

template <bool kVec, typename GI, typename GR, typename O>
__global__ void __launch_bounds__(kPullThreads, kPullMinBlocks)
pull_kernel(const float* __restrict__ xy,
            const unsigned char* __restrict__ valid,
            const GI* __restrict__ d_rgb, const GR* __restrict__ d_ray,
            Index x, O* __restrict__ d_img_feats,
            O* __restrict__ d_ray_feats, int V, int P, int H, int W, int fh,
            int fw, int C) {
  using S = PullSmem<GI, GR>;
  // the grid covers the most work items a view can have; past the view's
  // own, the block has none
  if (static_cast<int>(blockIdx.x) / V >= x.nitems[blockIdx.x % V]) return;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* jobs_full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* meta_full = jobs_full + kMetaStages;
  uint64_t* meta_empty = meta_full + kMetaStages;
  uint64_t* rows_full = meta_empty + kMetaStages;
  uint64_t* rows_empty = rows_full + kRowStages;
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  if (t == 0) {
    for (int s = 0; s < kMetaStages; ++s) {
      bar_init(jobs_full + s, 1);   // the producer
      bar_init(meta_full + s, 1);
      bar_init(meta_empty + s, kSumWarps);
    }
    for (int s = 0; s < kRowStages; ++s) {
      bar_init(rows_full + s, kSumThreads);   // each thread's copies
      bar_init(rows_empty + s, kSumWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (w == kSumWarps) {
    produce(smem, jobs_full, meta_full, meta_empty, d_rgb, d_ray, x, V, P, C);
    return;
  }
  // The summing warps: chunk q's rows are copied once every summing warp is
  // done with chunk q - 1 (kRowStages 1: while they finish a work item and
  // the producer sorts chunk q), or while they sum it (2, an ablation).
  const int by = w / (kTileX / kWarpX) * kWarpY;
  const int bx = w % (kTileX / kWarpX) * kWarpX;
  unsigned* bits = reinterpret_cast<unsigned*>(smem + S::kBits);
  float ai[kWarpY][kWarpX] = {}, ar[kWarpY][kWarpX] = {};
  const auto meta_of = [&](int q) {
    return smem + S::kMeta + q % kMetaStages * S::kMetaStage;
  };
  const auto rows_of = [&](int q) {
    return smem + q % kRowStages * S::kRowStage;
  };
  // chunk q's header once the producer has it and the copy jobs; its rows'
  // copies started
  const auto next = [&](int q) {
    ring_wait(jobs_full, kMetaStages, q, false);
    const Header h =
        *reinterpret_cast<const Header*>(meta_of(q) + S::kHdr);
    if (!(h.flags & kNoWork)) {
      ring_wait(rows_empty, kRowStages, q, true);
      copy_rows<GI, GR>(rows_of(q), meta_of(q), h, rows_full + q % kRowStages);
    }
    return h;
  };
  Header h = next(0);
  for (int q = 0; !(h.flags & kNoWork); ++q) {
    Header h_next;
    if (kRowStages > 1) h_next = next(q + 1);
    ring_wait(meta_full, kMetaStages, q, false);   // the records
    ring_wait(rows_full, kRowStages, q, false);
    if (h.flags & kFirstChunk) {
#pragma unroll
      for (int cy = 0; cy < kWarpY; ++cy)
#pragma unroll
        for (int cx = 0; cx < kWarpX; ++cx) ai[cy][cx] = ar[cy][cx] = 0.0f;
    }
    const unsigned char* meta = meta_of(q);
    const int* seg = reinterpret_cast<const int*>(meta + S::kSeg);
    const Record* recs = reinterpret_cast<const Record*>(meta + S::kRecs);
    const unsigned char* rows = rows_of(q);
    // anchor (by + r, bx + c) of the region, row-major; lanes from C on
    // sum what is never stored
#pragma unroll
    for (int r = 0; r <= kWarpY; ++r)
#pragma unroll
      for (int c = 0; c <= kWarpX; ++c)
        pull_segment<GI, GR>(ai, ar, r, c, seg, recs, rows,
                             (by + r) * (kTileX + 1) + bx + c, lane);
    __syncwarp();
    if (lane == 0) {
      bar_arrive(rows_empty + q % kRowStages);
      bar_arrive(meta_empty + q % kMetaStages);
    }
    if (kRowStages == 1) h_next = next(q + 1);
    if (h.flags & kLastChunk) {
      finish<kVec>(ai, ar, h, bits, xy, valid, d_rgb, d_ray, x, d_img_feats,
                   d_ray_feats, P, H, W, fh, fw, C);
    }
    h = h_next;
  }
}

// The float32 instance's pull: block (view, i) owns the i-th tile of the
// view, longest list first (its work item: the count pass does not split
// float32 lists), all the block's warps together through each chunk of
// kSyncChunk entries in five barrier-separated phases:
//   1. per entry (a thread each), its record (the list entry: key, tap
//      steps, weights) into shared memory (the entry was loaded during the
//      chunk before);
//   2. the gradient rows (d_rgb's channels 3.., d_ray) start to copy
//      (cp.async, 4 bytes a lane, a warp a row at a time); warps
//      0..kRankWarps-1 rank the entries by key (one round each);
//   3. a thread a key turns the per-warp key counts into each key's
//      segment;
//   4. each entry's weights, key and list position go to its place in its
//      key's segment, in list order (a stable sort); the copies are waited
//      for;
//   5. each warp walks the 3 x 3 anchor cells whose taps can reach its 2 x
//      2 cells, in row-major order, each segment in list order, and adds
//      each entry's contributions to the cells its taps land on
//      (`pull_entry`).
// So a cell sums chunk by chunk, its four anchor cells in turn, each in
// list order. In float32 it was faster at the train pass's coordinates than
// the pipelined pull, whose rows are a third larger in float32 (PERF.md).
namespace sync_pull {

constexpr int kWarpY = 2, kWarpX = 2;   // cells a warp owns
constexpr int kWarps = kTileY / kWarpY * (kTileX / kWarpX);
constexpr int kThreads = 32 * kWarps;
constexpr int kSyncChunk = 256;         // tile-list entries staged at a time
constexpr int kRankWarps = kSyncChunk / 32;
constexpr int kRow = 64;                // staged floats an entry: img | ray

static_assert(kSyncChunk <= kThreads && kRankWarps <= kWarps, "chunk");
static_assert(kKeys <= kThreads, "a thread a key in step 3");
static_assert(2 * kTileY * kTileX <= kRankWarps * kKeys,
              "the NaN path's bits fit in the rank histograms");

constexpr size_t kSmem = sizeof(float) * kSyncChunk * kRow +
                         2 * sizeof(float4) * kSyncChunk +
                         sizeof(int) * (4 * kSyncChunk + kKeys + 1 +
                                        kRankWarps * kKeys);

__device__ __forceinline__ void segment(float ai[kWarpY][kWarpX],
                                        float ar[kWarpY][kWarpX], int kAr,
                                        int kAc, const int* seg,
                                        const int* meta, const float4* wts,
                                        const int* src, const float* rows,
                                        int k, int lane) {
#pragma unroll 4
  for (int j = seg[k]; j < seg[k + 1]; ++j) {
    const int mt = meta[j];
    const int e = src[j];
    float gi = rows[e * kRow + lane];
    float gr = rows[e * kRow + 32 + lane];
    if (!(mt >> 10 & 1)) {   // an invalid point left in: g * 0
      gi *= 0.0f;
      gr *= 0.0f;
    }
    pull_entry<kWarpY, kWarpX>(ai, ar, kAr, kAc, gi, gr, wts[j], mt >> 9 & 1,
                               mt >> 8 & 1);
  }
}

// One float of global memory into shared memory, asynchronously
// (cp.async); wait() waits for the thread's copies (and is the compiler's
// barrier for them: nothing reads a destination before it).
__device__ __forceinline__ void stage(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
pull_kernel(const float* __restrict__ xy,
            const unsigned char* __restrict__ valid,
            const float* __restrict__ d_rgb, const float* __restrict__ d_ray,
            Index x, float* __restrict__ d_img_feats,
            float* __restrict__ d_ray_feats, int P, int H, int W, int fh,
            int fw, int C) {
  extern __shared__ float4 smem[];
  float* rows = reinterpret_cast<float*>(smem);   // kSyncChunk x kRow
  float4* wts_in = smem + kSyncChunk * kRow / 4;  // wx, owx, wy, owy
  float4* wts = wts_in + kSyncChunk;              // sorted
  int* meta_in = reinterpret_cast<int*>(wts + kSyncChunk);   // key|ddx|ddy|m
  int* meta = meta_in + kSyncChunk;               // sorted
  int* pidx = meta + kSyncChunk;
  int* src = pidx + kSyncChunk;                   // sorted: list position
  int* seg = src + kSyncChunk;                    // kKeys + 1
  int* hist = seg + kKeys + 1;                    // kRankWarps x kKeys
  const int v = blockIdx.x;
  const int4 item = x.items[static_cast<size_t>(v) * x.item_cap + blockIdx.y];
  const int tile = item.x, begin = item.y, end = item.z;
  const int ty0 = tile / x.ntx * kTileY, tx0 = tile % x.ntx * kTileX;
  const int4* list = x.lists + v * x.list_cap;
  {
    const size_t vp = static_cast<size_t>(v) * P;
    xy += 2 * vp;
    valid += vp;
    d_rgb += vp * (3 + C);
    d_ray += vp * C;
  }
  const int t = threadIdx.x, w = t / 32, lane = t % 32;
  const int by = w / (kTileX / kWarpX) * kWarpY;
  const int bx = w % (kTileX / kWarpX) * kWarpX;
  float ai[kWarpY][kWarpX] = {}, ar[kWarpY][kWarpX] = {};
  // the next chunk's entry of this thread, loaded a chunk ahead
  int4 next = t < min(kSyncChunk, end - begin) ? list[begin + t]
                                               : make_int4(0, 0, 0, 0);
  for (int b = begin; b < end; b += kSyncChunk) {
    const int n = min(kSyncChunk, end - b);
    const int n_next = min(kSyncChunk, end - b - kSyncChunk);
    // 1.
    for (int i = t; i < kRankWarps * kKeys; i += kThreads) hist[i] = 0;
    if (t < n) {
      const float wx = __int_as_float(next.z), wy = __int_as_float(next.w);
      pidx[t] = next.x & 0x7fffffff;
      wts_in[t] = make_float4(wx, 1.0f - wx, wy, 1.0f - wy);
      meta_in[t] = next.y;
    }
    if (t < n_next) next = list[b + kSyncChunk + t];
    __syncthreads();
    // 2. the rows' copies start (list order), then the ranks
    if (lane < C) {
#pragma unroll 4
      for (int e = w; e < n; e += kWarps) {
        const int p = pidx[e];
        stage(rows + e * kRow + lane, d_rgb + p * (3 + C) + 3 + lane);
        stage(rows + e * kRow + 32 + lane, d_ray + p * C + lane);
      }
    }
    int key = -1, rank = 0;
    const int e = w * 32 + lane;
    if (w < kRankWarps) {
      key = e < n ? meta_in[e] & 0xff : -1;
      rank = warp_rank(hist + w * kKeys, key);
    }
    __syncthreads();
    // 3. hist[w][k] becomes the count of key k in warps before w (a thread
    //    a key), then seg[k] the count of keys before k (warp 0)
    if (t < kKeys) {
      int r = 0;
      for (int u = 0; u < kRankWarps; ++u) {
        const int h = hist[u * kKeys + t];
        hist[u * kKeys + t] = r;
        r += h;
      }
      seg[t] = r;
    }
    __syncthreads();
    if (w == 0) {
      int run[kKeysPerLane], sum = 0;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int k = lane * kKeysPerLane + j;
        run[j] = k < kKeys ? seg[k] : 0;
        sum += run[j];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int base = incl - sum;
#pragma unroll
      for (int j = 0; j < kKeysPerLane; ++j) {
        const int k = lane * kKeysPerLane + j;
        if (k < kKeys) seg[k] = base;
        base += run[j];
      }
      if (lane == 31) seg[kKeys] = incl;
    }
    __syncthreads();
    // 4. each entry's place in its key's segment, in list order
    if (key >= 0) {
      const int j = seg[key] + hist[w * kKeys + key] + rank;
      meta[j] = meta_in[e];
      wts[j] = wts_in[e];
      src[j] = e;
    }
    wait();
    __syncthreads();
    // 5. anchor (by + r, bx + c) of the region, row-major; lanes from C on
    //    sum what is never stored
#pragma unroll
    for (int r = 0; r <= kWarpY; ++r)
#pragma unroll
      for (int c = 0; c <= kWarpX; ++c)
        segment(ai, ar, r, c, seg, meta, wts, src, rows,
                (by + r) * (kTileX + 1) + bx + c, lane);
    __syncthreads();
  }
  // The NaN path (see `finish`): every cell that an invalid point with a
  // non-finite upstream value reaches gets NaN in those channels.
  if (kDropInvalid && x.flags[v]) {
    unsigned* nan_bits = reinterpret_cast<unsigned*>(hist);   // [2][cells]
    for (int i = t; i < 2 * kTileY * kTileX; i += kThreads) nan_bits[i] = 0;
    __syncthreads();
    for (int p = t; p < P; p += kThreads) {
      if (valid[p]) continue;
      const Anchor a = anchor_of(normalised(xy, p, H, W), 0.0f, fh, fw);
      unsigned bits[2] = {0u, 0u};
      bool read = false;
      for (int dy = 0; dy <= a.ddy; ++dy)
        for (int dx = 0; dx <= a.ddx; ++dx) {
          const int ly = a.y + dy - ty0, lx = a.x + dx - tx0;
          if (ly < 0 || ly >= kTileY || lx < 0 || lx >= kTileX) continue;
          if (!read) {   // the channels where g is not finite
            for (int ch = 0; ch < C; ++ch) {
              bits[0] |= unsigned(!isfinite(d_rgb[p * (3 + C) + 3 + ch])) << ch;
              bits[1] |= unsigned(!isfinite(d_ray[p * C + ch])) << ch;
            }
            read = true;
          }
          atomicOr(nan_bits + ly * kTileX + lx, bits[0]);
          atomicOr(nan_bits + kTileY * kTileX + ly * kTileX + lx, bits[1]);
        }
    }
    __syncthreads();
#pragma unroll
    for (int cy = 0; cy < kWarpY; ++cy)
#pragma unroll
      for (int cx = 0; cx < kWarpX; ++cx) {
        const int cell = (by + cy) * kTileX + bx + cx;
        if (nan_bits[cell] >> lane & 1) ai[cy][cx] = __int_as_float(0x7fffffff);
        if (nan_bits[kTileY * kTileX + cell] >> lane & 1)
          ar[cy][cx] = __int_as_float(0x7fffffff);
      }
  }
  // each of the warp's cells once: float4 stores from lanes [0, C/4) (the
  // four channels gathered by shuffles), else one channel a lane
#pragma unroll
  for (int cy = 0; cy < kWarpY; ++cy)
#pragma unroll
    for (int cx = 0; cx < kWarpX; ++cx) {
      const int y = ty0 + by + cy, xc = tx0 + bx + cx;
      const size_t o = ((static_cast<size_t>(v) * fh + y) * fw + xc) * C;
      if (kVec) {
        float4 gi4, gr4;
        const int s4 = 4 * lane % 32;
        gi4.x = __shfl_sync(0xffffffffu, ai[cy][cx], s4);
        gi4.y = __shfl_sync(0xffffffffu, ai[cy][cx], s4 + 1);
        gi4.z = __shfl_sync(0xffffffffu, ai[cy][cx], s4 + 2);
        gi4.w = __shfl_sync(0xffffffffu, ai[cy][cx], s4 + 3);
        gr4.x = __shfl_sync(0xffffffffu, ar[cy][cx], s4);
        gr4.y = __shfl_sync(0xffffffffu, ar[cy][cx], s4 + 1);
        gr4.z = __shfl_sync(0xffffffffu, ar[cy][cx], s4 + 2);
        gr4.w = __shfl_sync(0xffffffffu, ar[cy][cx], s4 + 3);
        if (y < fh && xc < fw && 4 * lane < C) {
          store4(d_img_feats + o + 4 * lane, gi4);
          store4(d_ray_feats + o + 4 * lane, gr4);
        }
      } else if (y < fh && xc < fw && lane < C) {
        d_img_feats[o + lane] = ai[cy][cx];
        d_ray_feats[o + lane] = ar[cy][cx];
      }
    }
}

}  // namespace sync_pull

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int forward(const T* imgs, const T* img_feats, const T* ray_feats,
            const float* xy, const unsigned char* valid, T* rgb_out,
            float* ray_out, int V, int P, int H, int W, int fh, int fw, int C,
            cudaStream_t stream) {
  if (V == 0 || P == 0) return 0;
  const dim3 grid((P + kPoints - 1) / kPoints, V);
  // vector reads and stores of four channels
  const size_t v4 = 4 * sizeof(T);
  const bool vec = C % 4 == 0 && aligned(img_feats, v4) &&
                   aligned(ray_feats, v4) && aligned(ray_out, 16);
  if (vec)
    gather_kernel<true, T><<<grid, kThreads, 0, stream>>>(
        imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out, P, H, W, fh,
        fw, C);
  else
    gather_kernel<false, T><<<grid, kThreads, 0, stream>>>(
        imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out, P, H, W, fh,
        fw, C);
  return static_cast<int>(cudaGetLastError());
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
  return forward(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out, V,
                 P, H, W, fh, fw, C, stream);
}

// The bfloat16 instance: bfloat16 maps and rgb_out (rounded to the nearest
// from the float32 blend), float32 ray_out (the blend), the same coordinates
// and limits.
extern "C" int epipolar_gather_forward_bf16(
    const bf16* imgs, const bf16* img_feats, const bf16* ray_feats,
    const float* xy, const unsigned char* valid, bf16* rgb_out,
    float* ray_out, int V, int P, int H, int W, int fh, int fw, int C,
    cudaStream_t stream) {
  return forward(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out, V,
                 P, H, W, fh, fw, C, stream);
}

// Lets an instance of the backward's kernels use its dynamic shared memory
// above 48 KB, once per device (a host call that costs more than a small
// launch). GI, GR: the upstream gradients' types; O: the maps' gradients'.
template <typename GI, typename GR, typename O>
static cudaError_t allow_smem() {
  static unsigned long long done = 0;   // one bit per device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (done >> dev & 1) return cudaSuccess;
  const int index_smem = static_cast<int>(sizeof(int)) * kIndexWarps * kMaxTiles;
  err = cudaFuncSetAttribute(index_kernel<false, GI, GR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             index_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(index_kernel<true, GI, GR>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               index_smem);
  for (int vec = 0; vec < 2 && err == cudaSuccess; ++vec) {
    if constexpr (!kPipelined<GI>)
      err = cudaFuncSetAttribute(
          vec ? sync_pull::pull_kernel<true> : sync_pull::pull_kernel<false>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(sync_pull::kSmem));
    else
      err = cudaFuncSetAttribute(
          vec ? pull_kernel<true, GI, GR, O> : pull_kernel<false, GI, GR, O>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          PullSmem<GI, GR>::kBytes);
  }
  if (err == cudaSuccess) done |= 1ULL << dev;
  return err;
}

// int32 elements of the backward's scratch for these sizes; -1 where the
// index cannot take them (more than kMaxTiles tiles a view).
extern "C" long long epipolar_gather_backward_scratch(int V, int P, int fh,
                                                      int fw) {
  const Index x = index_layout(nullptr, V, P, fh, fw);
  return x.tiles > kMaxTiles ? -1 : x.ints;
}

// Where a call's index lies in its scratch, for reading it back: the int32
// offsets of the tile starts ([V][tiles + 1]) and of the views' work-item
// counts ([V]), the tiles a view; then, for the `bf16_instance`'s pull (0
// float32, 1 bfloat16), the entries a chunk and the chunks a work item at
// most (0: whole lists).
extern "C" int epipolar_gather_backward_layout(int V, int P, int fh, int fw,
                                               int bf16_instance,
                                               long long* out) {
  const Index x = index_layout(nullptr, V, P, fh, fw);
  out[0] = x.starts_at;
  out[1] = x.nitems_at;
  out[2] = x.tiles;
  out[3] = bf16_instance ? kChunk : sync_pull::kSyncChunk;
  out[4] = bf16_instance ? kSplit : 0;
  return 0;
}

// CUDA launches of one epipolar_gather_backward call without d_imgs (with
// it: the same, the caller zeroes d_imgs); the bfloat16 instance's too.
extern "C" int epipolar_gather_backward_launches() { return 4; }

template <typename GI, typename GR, typename O>
static int backward(const float* xy, const unsigned char* valid,
                    const GI* d_rgb, const GR* d_ray, float* d_imgs,
                    O* d_img_feats, O* d_ray_feats, int* scratch, int V, int P,
                    int H, int W, int fh, int fw, int C, cudaStream_t stream) {
  if (V == 0) return 0;
  const Index x = index_layout(scratch, V, P, fh, fw);
  if (x.tiles > kMaxTiles || C > kMaxC)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (P == 0) {   // no point: both maps' gradients are 0
    const size_t bytes = sizeof(O) * V * fh * fw * C;
    err = cudaMemsetAsync(d_img_feats, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(d_ray_feats, 0, bytes, stream);
    return static_cast<int>(err);
  }
  err = allow_smem<GI, GR, O>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // the count pass's tickets and the flags
  err = cudaMemsetAsync(x.tickets, 0, sizeof(int) * x.zeroed, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(x.chunks, V);
  const size_t smem = sizeof(int) * kIndexWarps * x.tiles;
  index_kernel<false, GI, GR><<<blocks, kIndexThreads, smem, stream>>>(
      xy, valid, d_rgb, d_ray, d_imgs, x, P, H, W, fh, fw, C);
  index_kernel<true, GI, GR><<<blocks, kIndexThreads, smem, stream>>>(
      xy, valid, d_rgb, d_ray, nullptr, x, P, H, W, fh, fw, C);
  // stores of four channels
  const size_t v4 = 4 * sizeof(O);
  const bool vec = C % 4 == 0 && aligned(d_img_feats, v4) &&
                   aligned(d_ray_feats, v4);
  if constexpr (!kPipelined<GI>) {   // a block a tile
    const auto kernel = vec ? sync_pull::pull_kernel<true>
                            : sync_pull::pull_kernel<false>;
    kernel<<<dim3(V, x.tiles), sync_pull::kThreads, sync_pull::kSmem,
             stream>>>(xy, valid, d_rgb, d_ray, x, d_img_feats, d_ray_feats, P,
                       H, W, fh, fw, C);
  } else {
    // a block per work item, the views' i-th items together (longest first)
    const auto kernel = vec ? pull_kernel<true, GI, GR, O>
                            : pull_kernel<false, GI, GR, O>;
    kernel<<<V * x.item_cap, kPullThreads, PullSmem<GI, GR>::kBytes,
             stream>>>(xy, valid, d_rgb, d_ray, x, d_img_feats, d_ray_feats, V,
                       P, H, W, fh, fw, C);
  }
  return static_cast<int>(cudaGetLastError());
}

// The transpose of epipolar_gather_forward with respect to the maps: writes
// every cell of d_img_feats and d_ray_feats [V,fh,fw,C], and adds into
// d_imgs [V,H,W,3] (zeroed by the caller) unless it is null. scratch: the
// int32 elements that epipolar_gather_backward_scratch gives, uninitialised.
// The forward's 32-bit limits.
extern "C" int epipolar_gather_backward(
    const float* xy, const unsigned char* valid, const float* d_rgb,
    const float* d_ray, float* d_imgs, float* d_img_feats, float* d_ray_feats,
    int* scratch, int V, int P, int H, int W, int fh, int fw, int C,
    cudaStream_t stream) {
  return backward(xy, valid, d_rgb, d_ray, d_imgs, d_img_feats, d_ray_feats,
                  scratch, V, P, H, W, fh, fw, C, stream);
}

// The bfloat16 instance (`_feg_bwd` on bfloat16 maps): d_rgb in bfloat16,
// d_ray in float32 (the float32 sum of its consumers' gradients), the maps'
// gradients written in bfloat16, each cell the float32 sum of its points'
// contributions rounded to bfloat16 (`pull_entry_bf16`), rounded once; the
// image's contributions, rounded likewise, added into d_imgs (float32,
// zeroed by the caller, who rounds it once) unless it is null
// (`splat_bf16`). The same scratch and limits.
extern "C" int epipolar_gather_backward_bf16(
    const float* xy, const unsigned char* valid, const bf16* d_rgb,
    const float* d_ray, float* d_imgs, bf16* d_img_feats, bf16* d_ray_feats,
    int* scratch, int V, int P, int H, int W, int fh, int fw, int C,
    cudaStream_t stream) {
  return backward(xy, valid, d_rgb, d_ray, d_imgs, d_img_feats, d_ray_feats,
                  scratch, V, P, H, W, fh, fw, C, stream);
}

// An instance of the backward's kernels as built, on the current card: for
// the count, the fill and the pull kernel (vector path), registers a thread,
// spilled (local) bytes a thread, static shared memory; then the pull's
// dynamic shared memory and its resident blocks per SM.
template <typename GI, typename GR, typename O>
static int backward_info(int* out) {
  cudaFuncAttributes attr[3];
  cudaError_t err = cudaFuncGetAttributes(&attr[0], index_kernel<false, GI, GR>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr[1], index_kernel<true, GI, GR>);
  int per_sm = 0, smem = 0;
  if (err == cudaSuccess) err = allow_smem<GI, GR, O>();
  if constexpr (!kPipelined<GI>) {
    smem = static_cast<int>(sync_pull::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr[2], sync_pull::pull_kernel<true>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, sync_pull::pull_kernel<true>, sync_pull::kThreads, smem);
  } else {
    smem = PullSmem<GI, GR>::kBytes;
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr[2], pull_kernel<true, GI, GR, O>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pull_kernel<true, GI, GR, O>, kPullThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < 3; ++i) {
    out[3 * i] = attr[i].numRegs;
    out[3 * i + 1] = static_cast<int>(attr[i].localSizeBytes);
    out[3 * i + 2] = static_cast<int>(attr[i].sharedSizeBytes);
  }
  out[9] = smem;
  out[10] = per_sm;
  return 0;
}

extern "C" int epipolar_gather_backward_info(int* out) {
  return backward_info<float, float, float>(out);
}
extern "C" int epipolar_gather_backward_bf16_info(int* out) {
  return backward_info<bf16, float, bf16>(out);
}

// ------------------------------------------------- gradient with respect to xy
// Replaces: the xy cotangent of `_feg_bwd` (graspnerf_tpu/ops/fused_gather.py
// :260-270), the VJP at :268 of `_interp_from_win` (:95-180) with respect to
// xy. For every (view v, point p): the a.e. derivative of the three bilinear
// samples with respect to (x, y), contracted with the upstream gradients
// d_rgb_feats [V,P,3+C] and d_ray_feats [V,P,C] -> d_xy [V,P,2] float32.
// floor and the border clamps carry no gradient: along an axis whose two
// taps were clamped onto one row (column) the difference of the taps is
// exactly 0, as JAX's folded weights' (1 - w) + w cancel. The chain factors
// are dxq/dx = fw/(w-1) on the feature maps (align_corners=False) and
// dxf/dx = (W-1)/(w-1) on the image (align_corners=True), applied as JAX's
// VJP applies them: 0.5 * fw and 0.5 * (W-1) into d(xn), then 2 / (w-1).
// Everything is times the mask: a non-finite upstream value at an invalid
// point gives NaN, as JAX's g * 0 does.
// Bound: bytes (the upstream rows read once). The maps' taps stay in L2,
// but on random coordinates they are ~1 KB a point in float32 (512 bytes in
// bfloat16), as the forward reads them: with the upstream, about 500 MB
// cross from L2 into the SMs at P = 64,000, which is what the float32
// instance's time is near.
// Design: the forward's three phases, transposed. A block takes kXyPoints
// consecutive points of one view (the view on blockIdx.y).
//   1. The block's d_rgb_feats rows (3 + C elements each, not 16-byte
//      aligned) are one contiguous slab of the upstream: its threads start
//      16-byte cp.async copies of the blocks that enclose it into shared
//      memory, the slab at its own offset from a 16-byte boundary (the
//      forward's phase 3 run backwards). Meanwhile one thread a point
//      computes its quarter-res taps and weights into shared memory, and
//      another its full-res ones (`make_point`'s arithmetic, so the
//      forward's to the bit).
//   2. L lanes a point (`kXyLanes`: 8 in float32, 4 in bfloat16), each
//      taking kXyRounds points in turn and owning kMaxC / L channels of both
//      maps: a 16-byte read of each of the four taps of each map (four
//      float32 or eight bfloat16 channels) and of the point's d_ray_feats
//      row; its d_rgb_feats channels from shared memory. At 8 lanes, lanes
//      0-5 read the image's two tap rows (x0, x1) x 3 colours and lane
//      c < 3 takes the x1 column from lane c + 3 by shuffle once the maps'
//      taps are summed, as the forward's phase 2 reads them; at 4, lanes
//      0-2 read the four taps of their colour. A lane's partial sums meet
//      in a shuffle reduction over the point's lanes; lanes 0 and 1 divide
//      and store d_x and d_y.
// Measured (tools/gather_variants.py --xy): the time is L2 traffic plus
// instructions; bfloat16 at 4 lanes issues half the lanes' address and
// index arithmetic, while float32 at 4 lanes (72 registers) ran slower on
// random coordinates.
// Arithmetic: the taps, weights and tap differences are the plain
// version's; each product that meets a sum is an FMA (an explicit fmaf: the
// library is built with -fmad=false), and each point's sum over its 2 C + 3
// channels runs in the lanes' order, not PyTorch's. Maps or d_ray_feats
// that are not aligned for the lanes' reads, or C % (kMaxC / L) != 0, take
// float reads (the staged slab does not need alignment).
// bfloat16 instance: the maps and d_rgb_feats in bfloat16, widened exactly
// to float32 (JAX promotes the window before the weighted sum), d_ray_feats
// float32; all arithmetic float32.
namespace {

constexpr int kXyPoints = 32;                 // points of one view a block
constexpr int kXyThreads = 2 * kXyPoints;     // phase 1: a thread a map
// lanes a point, float32 and bfloat16 maps
constexpr int kXyLanesF32 = 8, kXyLanesBF16 = 4;

template <typename T>
constexpr int kXyLanes = sizeof(T) == 4 ? kXyLanesF32 : kXyLanesBF16;

// K consecutive elements as float, from 16-byte reads (8-byte reads of
// four bfloat16)
template <int K>
__device__ __forceinline__ void load_k(const float* p, float* v) {
#pragma unroll
  for (int j = 0; j < K; j += 4) {
    const float4 u = ld4(p + j);
    v[j] = u.x;
    v[j + 1] = u.y;
    v[j + 2] = u.z;
    v[j + 3] = u.w;
  }
}
template <int K>
__device__ __forceinline__ void load_k(const bf16* p, float* v) {
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p + j));
      const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        v[j + 2 * h] = __uint_as_float(w[h] << 16);
        v[j + 2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const float4 u = load4(p + j);
      v[j] = u.x;
      v[j + 1] = u.y;
      v[j + 2] = u.z;
      v[j + 3] = u.w;
    }
  }
}

// d(sample)/d(px) and d(sample)/d(py) of one channel from its four taps
__device__ __forceinline__ float2 slopes(float v00, float v01, float v10,
                                         float v11, const Point& q) {
  return make_float2(fmaf(v11 - v10, q.wy, (v01 - v00) * q.owy),
                     fmaf(v11 - v01, q.wx, (v10 - v00) * q.owx));
}

// g . slopes of K channels c.. of `map` at q's taps (n of them on the
// element path), added into acc (x, y)
template <bool kVec, int K, typename T>
__device__ __forceinline__ void add_slopes(const T* __restrict__ map,
                                           const Point& q, int c, int n,
                                           const float* g, float2& acc) {
  const T* t = map + q.o00 + c;
  if (kVec) {
    float a[K], b[K], d[K], e[K];
    load_k<K>(t, a);
    load_k<K>(t + q.dx, b);
    load_k<K>(t + q.dy, d);
    load_k<K>(t + q.dy + q.dx, e);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float2 s = slopes(a[j], b[j], d[j], e[j], q);
      acc.x = fmaf(g[j], s.x, acc.x);
      acc.y = fmaf(g[j], s.y, acc.y);
    }
  } else {
    for (int j = 0; j < n; ++j) {
      const float2 s = slopes(
          to_f(__ldg(t + j)), to_f(__ldg(t + q.dx + j)),
          to_f(__ldg(t + q.dy + j)), to_f(__ldg(t + q.dy + q.dx + j)), q);
      acc.x = fmaf(g[j], s.x, acc.x);
      acc.y = fmaf(g[j], s.y, acc.y);
    }
  }
}

template <bool kVec, typename T>
__global__ void __launch_bounds__(kXyThreads)
xy_grad_kernel(const T* __restrict__ imgs, const T* __restrict__ img_feats,
               const T* __restrict__ ray_feats, const float* __restrict__ xy,
               const unsigned char* __restrict__ valid,
               const T* __restrict__ d_rgb, const float* __restrict__ d_ray,
               float* __restrict__ d_xy, int P, int H, int W, int fh, int fw,
               int C) {
  constexpr int E = 16 / sizeof(T);   // elements per 16 bytes
  constexpr int L = kXyLanes<T>, K = kMaxC / L;   // lanes, their channels
  constexpr int kXyRounds = kXyPoints * L / kXyThreads;   // a lane's points
  constexpr bool kRows = L == 8;   // the image's tap rows by lanes 0-5
  static_assert(kXyPoints % 8 == 0 && kXyThreads % 32 == 0 &&
                    kXyPoints * L % kXyThreads == 0 && K % 4 == 0,
                "xy block shape");
  __shared__ Point pts[kXyPoints], rgbs[kXyPoints];
  __shared__ __align__(16) T slab[kXyPoints * kMaxRow + E];
  const int R = 3 + C;
  const int p0 = blockIdx.x * kXyPoints;
  const int n = min(kXyPoints, P - p0);
  {   // this block's view
    const size_t v = blockIdx.y, vp = v * P;
    const size_t map = v * fh * fw * C;
    imgs += v * H * W * 3;
    img_feats += map;
    ray_feats += map;
    xy += 2 * vp;
    valid += vp;
    d_rgb += vp * R;
    d_ray += vp * C;
    d_xy += 2 * vp;
  }
  const T* rows = d_rgb + p0 * R;   // the block's d_rgb rows, n * R elements
  // slab[a + k] holds rows[k]: the same offset from 16 bytes
  const int a =
      static_cast<int>(reinterpret_cast<uintptr_t>(rows) / sizeof(T) % E);
  const int t = threadIdx.x;

  // 1. the slab's 16-byte blocks in flight; per point, once: the taps
  {
    const char* from = reinterpret_cast<const char*>(rows - a);
    const int blocks = (a + n * R + E - 1) / E;
    for (int s = t; s < blocks; s += kXyThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       smem_addr(slab + E * s)),
                   "l"(from + 16 * s)
                   : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int j = t; j < 2 * kXyPoints; j += kXyThreads) {
    const int i = j % kXyPoints;
    if (i < n) {
      const float m = valid[p0 + i] ? 1.0f : 0.0f;
      const float2 nxy = normalised(xy, p0 + i, H, W);
      if (j < kXyPoints)
        pts[i] = quarter_point(nxy, fh, fw, C, m);
      else
        rgbs[i] = full_point(nxy, H, W, m);
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();

  // 2. L lanes a point: the slopes, contracted with the upstream
  const int l = threadIdx.x % L, c = K * l;
  const float qx = 0.5f * static_cast<float>(fw);      // chain factors
  const float qy = 0.5f * static_cast<float>(fh);
  const float fx = 0.5f * static_cast<float>(W - 1);
  const float fy = 0.5f * static_cast<float>(H - 1);
#pragma unroll
  for (int r = 0; r < kXyRounds; ++r) {
    const int i = t / L + r * (kXyThreads / L);
    const bool live = i < n;   // the same for all lanes of the point
    const T* up = slab + a + i * R;   // the point's d_rgb_feats row
    Point f;   // the full-res taps
    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;   // the image's
    if (live) {
      f = rgbs[i];
      if (kRows ? l < 6 : l < 3) {   // rows y0, y1 at (x0 | x1, colour)
        const T* tap = imgs + f.o00 + (kRows ? l % 3 + l / 3 * f.dx : l);
        r0 = to_f(__ldg(tap));
        r1 = to_f(__ldg(tap + f.dy));
        if (!kRows) {   // and at x1
          r2 = to_f(__ldg(tap + f.dx));
          r3 = to_f(__ldg(tap + f.dy + f.dx));
        }
      }
    }
    float2 q_acc = make_float2(0.0f, 0.0f), f_acc = q_acc;
    if (live) {
      const Point q = pts[i];
      if (c < C) {   // the feature maps: the masked upstream, then slopes
        const int k = kVec ? K : min(K, C - c);   // kVec: C % K == 0
        float gi[K], gr[K];
        for (int j = 0; j < K; ++j)
          gi[j] = j < k ? to_f(up[3 + c + j]) * q.m : 0.0f;
        const float* ray = d_ray + (p0 + i) * C + c;
        if (kVec) {
          load_k<K>(ray, gr);
#pragma unroll
          for (int j = 0; j < K; ++j) gr[j] *= q.m;
        } else {
          for (int j = 0; j < K; ++j) gr[j] = j < k ? ray[j] * q.m : 0.0f;
        }
        add_slopes<kVec, K>(img_feats, q, c, k, gi, q_acc);
        add_slopes<kVec, K>(ray_feats, q, c, k, gr, q_acc);
      }
    }
    if (kRows) {   // the x1 column from lane l + 3, landed meanwhile
      r2 = __shfl_down_sync(0xffffffffu, r0, 3, L);
      r3 = __shfl_down_sync(0xffffffffu, r1, 3, L);
    }
    if (live && l < 3) {   // the image: colour l
      const float gc = to_f(up[l]) * f.m;
      const float2 s = slopes(r0, r2, r1, r3, f);
      f_acc.x = fmaf(gc, s.x, f_acc.x);
      f_acc.y = fmaf(gc, s.y, f_acc.y);
    }
    // into d(xn), d(yn): the quarter-res maps' and the image's chain factors
    float dx = q_acc.x * qx + f_acc.x * fx;
    float dy = q_acc.y * qy + f_acc.y * fy;
#pragma unroll
    for (int o = L / 2; o > 0; o /= 2) {
      dx += __shfl_xor_sync(0xffffffffu, dx, o, L);
      dy += __shfl_xor_sync(0xffffffffu, dy, o, L);
    }
    if (l < 2 && live)   // lane 0 d_x, lane 1 d_y: one division for both
      d_xy[2 * (p0 + i) + l] =
          (l ? dy : dx) * 2.0f / static_cast<float>(l ? H - 1 : W - 1);
  }
}

template <typename T>
int backward_xy(const T* imgs, const T* img_feats, const T* ray_feats,
                const float* xy, const unsigned char* valid, const T* d_rgb,
                const float* d_ray, float* d_xy, int V, int P, int H, int W,
                int fh, int fw, int C, cudaStream_t stream) {
  if (V == 0 || P == 0) return 0;
  if (C > kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + kXyPoints - 1) / kXyPoints, V);
  // vector reads of a lane's K channels: 16 bytes (8: four bfloat16) each
  constexpr int K = kMaxC / kXyLanes<T>;
  const size_t vb = K * sizeof(T) < 16 ? K * sizeof(T) : 16;
  const bool vec = C % K == 0 && aligned(img_feats, vb) &&
                   aligned(ray_feats, vb) && aligned(d_ray, 16);
  const auto kernel = vec ? xy_grad_kernel<true, T> : xy_grad_kernel<false, T>;
  kernel<<<grid, kXyThreads, 0, stream>>>(imgs, img_feats, ray_feats, xy,
                                          valid, d_rgb, d_ray, d_xy, P, H, W,
                                          fh, fw, C);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward_xy_info(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, xy_grad_kernel<true, T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  return 0;
}

}  // namespace

// d_xy [V,P,2] (float32, every element written) of the gather at xy: the
// forward's maps, coordinates and mask, the upstream d_rgb [V,P,3+C] in the
// maps' type and d_ray [V,P,C] float32. The forward's 32-bit limits; C <= 32.
extern "C" int epipolar_gather_backward_xy(
    const float* imgs, const float* img_feats, const float* ray_feats,
    const float* xy, const unsigned char* valid, const float* d_rgb,
    const float* d_ray, float* d_xy, int V, int P, int H, int W, int fh,
    int fw, int C, cudaStream_t stream) {
  return backward_xy(imgs, img_feats, ray_feats, xy, valid, d_rgb, d_ray,
                     d_xy, V, P, H, W, fh, fw, C, stream);
}

// The bfloat16 instance: bfloat16 maps and d_rgb, the rest as above.
extern "C" int epipolar_gather_backward_xy_bf16(
    const bf16* imgs, const bf16* img_feats, const bf16* ray_feats,
    const float* xy, const unsigned char* valid, const bf16* d_rgb,
    const float* d_ray, float* d_xy, int V, int P, int H, int W, int fh,
    int fw, int C, cudaStream_t stream) {
  return backward_xy(imgs, img_feats, ray_feats, xy, valid, d_rgb, d_ray,
                     d_xy, V, P, H, W, fh, fw, C, stream);
}

// The xy kernel's `dtype` instance as built (0 float32, 1 bfloat16), its
// vector path: registers a thread, spilled (local) bytes a thread, static
// shared memory.
extern "C" int epipolar_gather_backward_xy_info(int bf16_instance, int* out) {
  return bf16_instance ? backward_xy_info<bf16>(out)
                       : backward_xy_info<float>(out);
}
