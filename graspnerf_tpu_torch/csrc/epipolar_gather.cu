// Epipolar feature gather, forward (sm_90a, float32 and bfloat16) and
// backward (float32; its upstream type a template parameter of the pull).
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
// exactly widened to float32, weighed and blended as above; both outputs are
// written rounded to the nearest bfloat16, as the plain version rounds
// them. Its vector path reads and writes 8 bytes (four channels) at a time.
//
// Backward. Replaces: `_feg_bwd` (graspnerf_tpu/ops/fused_gather.py:260-270)
// with `_splat_windows` (:183-229), the transpose of the forward with respect
// to the maps: for every (view, point, channel) the upstream gradient times
// the mask, times each of the four tap weights, summed at that tap's map
// cell (JAX sums with one-hot matmuls because XLA:TPU serialises
// scatter-add). The gradient with respect to xy is not computed (no path
// needs it: the points carry no gradient). Upstream: d_rgb_feats [V,P,3+C]
// (its channels 0..2 go to the RGB image, 3.. to img_feats) and d_ray_feats
// [V,P,C]; outputs d_img_feats, d_ray_feats [V,fh,fw,C], every cell written
// once (no zeroing), and, only when asked for, d_imgs [V,H,W,3].
// Bound: bytes: the upstream gradients read once and the two maps'
// gradients written once. A scatter adds 4 taps x 2 maps x C floats a point
// into L2 with atomics (24.6 M vector reductions at P = 64,000, whose rate
// set the time of the scatter this replaces) in an order that changes from
// run to run. This design adds nothing into global memory: it pulls.
//   1. Index (two launches after a memset of tickets and flags): each point
//      enters the list of every kTileY x kTileX tile of map cells that its
//      taps reach (`tile_keys`; its anchor cell taken as the forward's
//      phase 1 takes it), by a stable counting sort over chunks of kSpan
//      points: a count pass with per-warp histograms, whose last block per
//      view scans them, then a fill pass that ranks the same way.
//   2. Pull (one launch): a block per tile and view stages its list in
//      chunks of kChunk entries in shared memory, sorted stably by anchor
//      cell (weights and anchor; the two gradient rows copied with cp.async
//      while the chunk is sorted). A
//      warp owns 2 x 2 cells, a lane one channel of both maps: it walks the
//      3 x 3 anchor cells whose taps can reach its cells and adds each
//      entry, in registers and in splat's order, to the cells its taps land
//      on, attributed by their computed targets (clamped borders put two
//      taps on one cell); every branch is the same for the whole warp. Then
//      each cell is written once, float4 stores where the maps' gradients
//      are 16-byte aligned and C % 4 == 0, else a float a lane. A long list
//      (a ray's 40 samples on one cell, points clamped onto a border) only
//      takes more chunks; the index orders each view's tiles longest list
//      first.
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

// T: float, or bf16 for the bfloat16 instance (maps and outputs in it; the
// coordinates, taps, weights and blends float32 all the same)
template <bool kVec, typename T>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const T* __restrict__ imgs,
              const T* __restrict__ img_feats,
              const T* __restrict__ ray_feats,
              const float* __restrict__ xy,
              const unsigned char* __restrict__ valid,
              T* __restrict__ rgb_out, T* __restrict__ ray_out,
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
    T* ray = ray_out + (p0 + i) * C;
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
        ray[j] = from_f<T>(sample1(ray_feats, q, j));
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
constexpr int kTileY = 8, kTileX = 8;   // map cells a pull block owns
// anchor cells whose points can reach a tile: the tile and its one-cell top
// and left halo, in the tile's region (row 0 and column 0 the halo)
constexpr int kKeys = (kTileY + 1) * (kTileX + 1);
// an invalid point adds g * 0, which is 0 unless g is not finite: the index
// leaves invalid points out, the fill pass flags the rare views where one
// has a non-finite upstream value, and those take the pull's NaN path (false: they are summed like the
// others, an ablation)
constexpr bool kDropInvalid = true;
constexpr int kKeysPerLane = (kKeys + 31) / 32;
constexpr int kWarpY = 2, kWarpX = 2;   // cells a pull warp owns
constexpr int kPullWarps = kTileY / kWarpY * (kTileX / kWarpX);
constexpr int kPullThreads = 32 * kPullWarps;
constexpr int kChunk = 256;             // tile-list entries staged at a time
constexpr int kRankWarps = kChunk / 32;
constexpr int kRow = 64;                // staged floats an entry: img | ray
constexpr int kIndexWarps = 8;
constexpr int kRounds = 2;              // of 32 points, for an index warp
constexpr int kSpan = kIndexWarps * kRounds * 32;   // points of an index block
constexpr int kMaxTiles = 4096;         // the index's per-warp histograms
constexpr int kMaxOrderedTiles = 1024;  // longest list first up to this many
constexpr int kScanBatch = 16;          // the scan's loads in flight a thread
// the pull reads the staged gradient rows from shared memory (false: from
// global memory, an ablation)
constexpr bool kStageRows = true;
// what a call launches (switches for tools/gather_variants.py's probes)
constexpr bool kRunIndex = true, kRunPull = true;
// SM cycles a pull phase, of two blocks a view (tools/gather_variants.py)
constexpr bool kStamps = false;

static_assert(kTileY % kWarpY == 0 && kTileX % kWarpX == 0, "warp cells");
static_assert(kChunk % 32 == 0 && kRankWarps <= kPullWarps, "chunk size");
static_assert(kChunk <= kPullThreads, "an entry a thread in step 1");
static_assert(kKeys < 256, "anchor keys are 8 bits");
static_assert(kKeys <= kPullThreads, "a thread a key in step 3");
static_assert(2 * kTileY * kTileX <= kRankWarps * kKeys,
              "the NaN path's bits fit in the rank histograms");

// kStamps: per view, the pull's first block (the longest list) and its
// middle one: cycles in phases 1-5, chunks, entries.
__device__ long long g_stamps[2 * 64][8];

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

// The index's scratch (int32), per view: the count pass's tickets and
// non-finite flags (the memset's), then [chunk][tile] counts (offsets after
// the scan), tile starts, the tiles in the order the pull takes them (tile,
// list begin, list end), tile lists. A list entry is a point: its index
// (bit 31 set where it is invalid) and its coordinates.
struct Index {
  int* tickets;
  int* flags;
  int* table;
  int* starts;
  int* order;
  int4* lists;
  int chunks, ntx, tiles;
  long long list_cap, ints;
};

Index index_layout(int* scratch, int V, int P, int fh, int fw) {
  Index x;
  x.chunks = (P + kSpan - 1) / kSpan;
  x.ntx = (fw + kTileX - 1) / kTileX;
  x.tiles = (fh + kTileY - 1) / kTileY * x.ntx;
  x.list_cap = 4LL * P;   // a point is in at most four tile lists
  const long long table = 2 * V, starts = table + 1LL * V * x.chunks * x.tiles,
                  order = starts + 1LL * V * (x.tiles + 1),
                  lists = (order + 3LL * V * x.tiles + 3) / 4 * 4;
  x.ints = lists + 4 * V * x.list_cap;
  x.tickets = scratch;
  x.flags = scratch == nullptr ? nullptr : scratch + V;
  x.table = scratch == nullptr ? nullptr : scratch + table;
  x.starts = scratch == nullptr ? nullptr : scratch + starts;
  x.order = scratch == nullptr ? nullptr : scratch + order;
  x.lists = scratch == nullptr ? nullptr
                               : reinterpret_cast<int4*>(scratch + lists);
  return x;
}

// Whether two rows of n <= 32 floats are all finite (not inf, not NaN):
// load() issues 16-byte loads of the blocks that hold them, finite() reads
// them, so that other work can run while they are in flight.
struct RowCheck {
  uint4 u[2][9];
  int skip[2];

  __device__ __forceinline__ void load(const float* __restrict__ a,
                                       const float* __restrict__ b, int n) {
    const float* rows[2] = {a, b};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uintptr_t lo = reinterpret_cast<uintptr_t>(rows[r]);
      const uint4* p = reinterpret_cast<const uint4*>(lo & ~uintptr_t{15});
      skip[r] = static_cast<int>(lo & 15) / 4;   // floats before the row
#pragma unroll
      for (int i = 0; i < 9; ++i)
        u[r][i] = 4 * i < skip[r] + n ? __ldg(p + i) : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ bool finite(int n) const {
    bool bad = false;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        const unsigned e[4] = {u[r][i].x, u[r][i].y, u[r][i].z, u[r][i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * i + j;
          bad |= k >= skip[r] && k < skip[r] + n &&
                 (e[j] & 0x7f800000u) == 0x7f800000u;
        }
      }
    return !bad;
  }
};

// Index passes, one launch each, the same blocks: block c takes the chunk
// of kSpan points [c * kSpan, (c + 1) * kSpan) of view blockIdx.y, warp w
// the kRounds rounds of 32 consecutive points from c * kSpan + w * 32 *
// kRounds (coordinates loaded first, all rounds at once); each point enters
// the lists of the tiles its taps reach (`tile_keys`, in slot order),
// counted in the warp's histogram (`warp_rank`). kFill = false writes the
// chunk's count of each tile into table; the last block of a view to finish
// (tickets) turns the counts into each chunk's offset in each tile's list,
// the tiles' totals into starts, and orders the tiles by the length of
// their lists, longest first (ties by index; by index alone above
// kMaxOrderedTiles tiles), so that the pull starts the longest lists first.
// kFill = true recounts the same way, so
// the ranks agree, and writes each point's index at starts[tile] +
// offset[chunk][tile] + the counts of the warps before it + its rank: a
// stable counting sort, so a tile's list is in the order (warp, round,
// slot, lane) of the points, by index but for the slot. Invalid points are
// in no list; the fill pass checks their upstream rows and flags the view
// (flags) where one holds inf or NaN. The count pass also splats d_rgb's
// RGB channels into d_imgs when it is not null.
template <bool kFill>
__global__ void __launch_bounds__(kIndexWarps * 32)
index_kernel(const float* __restrict__ xy,
             const unsigned char* __restrict__ valid,
             const float* __restrict__ d_rgb, const float* __restrict__ d_ray,
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
  for (int i = threadIdx.x; i < kIndexWarps * x.tiles; i += kIndexWarps * 32)
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
  bool nonfinite = false;   // an invalid point's upstream rows: inf or NaN
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = p0 + 32 * r + lane;
    const size_t vp = static_cast<size_t>(v) * P + p;
    // invalid points stay out of the lists; the fill pass checks their
    // upstream rows while the ranks run
    const bool out = kDropInvalid && pm[r] == 0.0f;
    const bool check = kFill && out && p < P;
    RowCheck rows;
    if (check) rows.load(d_rgb + vp * (3 + C) + 3, d_ray + vp * C, C);
#pragma unroll
    for (int s = 0; s < 4; ++s) keys[r][s] = -1;
    if (p < P) {
      const float2 n = normalised(pxy[r], H, W);
      if (!out) tile_keys(anchor_of(n, pm[r], fh, fw), x.ntx, keys[r]);
      if (!kFill && d_imgs != nullptr) {
        const Point q = full_point(n, H, W, pm[r]);
        for (int ch = 0; ch < 3; ++ch)
          splat(d_imgs + static_cast<size_t>(v) * H * W * 3 + ch, q,
                d_rgb[vp * (3 + C) + ch]);
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) ranks[r][s] = warp_rank(hist, keys[r][s]);
    if (check) nonfinite |= !rows.finite(C);
  }
  if (__syncthreads_or(nonfinite) && threadIdx.x == 0) atomicOr(x.flags + v, 1);
  // per tile: the warps' counts become their offsets in the chunk (the
  // barrier above ends the ranks)
  for (int t = threadIdx.x; t < x.tiles; t += kIndexWarps * 32) {
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
    for (int r = 0; r < kRounds; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int k = keys[r][s];
        if (k >= 0)
          list[starts[k] + table[c * x.tiles + k] + hist[k] + ranks[r][s]] =
              make_int4((p0 + 32 * r + lane) |
                            (pm[r] != 0.0f ? 0 : static_cast<int>(0x80000000u)),
                        __float_as_int(pxy[r].x), __float_as_int(pxy[r].y), 0);
      }
    return;
  }

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(x.tickets + v, 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The view's last block: per tile, the exclusive sum over chunks (in
  // place), then the exclusive sum of the tiles' totals.
  int carry = 0;
  for (int t0 = 0; t0 < x.tiles; t0 += kIndexWarps * 32) {
    const int t = t0 + threadIdx.x;
    int total = 0;
    if (t < x.tiles)
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
    int incl = total;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[w] = incl;
    __syncthreads();
    int before = carry;
    for (int k = 0; k < w; ++k) before += warp_sums[k];
    if (t < x.tiles) {
      starts[t] = before + incl - total;
      hists[t] = total;
    }
    for (int k = 0; k < kIndexWarps; ++k) carry += warp_sums[k];
    __syncthreads();
  }
  if (threadIdx.x == 0) starts[x.tiles] = carry;
  int* order = x.order + 3 * static_cast<size_t>(v) * x.tiles;
  for (int t = threadIdx.x; t < x.tiles; t += kIndexWarps * 32) {
    int r = t;
    const int n = hists[t];
    if (x.tiles <= kMaxOrderedTiles) {
      r = 0;
      for (int u = 0; u < x.tiles; ++u) {
        const int m = hists[u];
        r += m > n || (m == n && u < t);
      }
    }
    const int begin = __ldcg(starts + t);   // written by this block
    order[3 * r] = t;
    order[3 * r + 1] = begin;
    order[3 * r + 2] = begin + n;
  }
}

// The pull: block (view, i) owns the i-th tile of the view in the index's
// order (longest list first; the grid runs the views' i-th tiles
// together), kTileY x kTileX cells x all channels of
// both maps; warp w owns kWarpY x kWarpX of them, lane c channel c of both
// maps, and
// sums them in registers, to write each cell once at the end. The tile's
// list goes through shared memory kChunk entries at a time:
//   1. per entry (a thread each), its point's anchor, weights and key, the
//      anchor cell in the tile's region (the entry, which holds the point's
//      coordinates, was loaded during the chunk before);
//   2. the gradient rows (d_rgb's channels 3.., d_ray) start to copy
//      (cp.async, a warp a row at a time); warps 0..kRankWarps-1 rank the
//      entries by key (one round each);
//   3. warp 0 turns the per-warp key counts into each key's segment;
//   4. each entry's anchor, weights and list position go to its place in
//      its key's segment, in list order (a stable sort); the copies are
//      waited for;
//   5. each warp walks the (kWarpY + 1) x (kWarpX + 1) anchor cells whose
//      taps can reach its cells, in row-major order, each segment in list order, and adds each
//      entry's contributions to the cells its taps land on (`pull_entry`).
// So a cell sums chunk by chunk, its four anchor cells (y-1,x-1), (y-1,x),
// (y,x-1), (y,x) in turn, each in list order: a fixed order. G is the
// upstream gradients' type (float only, for now).
// Adds an entry to the kWarpY x kWarpX cells a warp owns, from anchor (ar,
// ac) of their (kWarpY + 1) x (kWarpX + 1) (constants once unrolled): the
// cell kY rows below and kX columns right of the anchor gets, in `splat`'s
// order, g*m times the row weight of each row tap that lands on it (top,
// then bottom), times the column weight of each column tap that does (x0,
// then x1). At a clamped border both taps of a pair land on one cell and
// both are added.
__device__ __forceinline__ void pull_entry(float ai[kWarpY][kWarpX],
                                           float ar[kWarpY][kWarpX], int kAr,
                                           int kAc, float gi, float gr,
                                           float4 q, int ddy, int ddx) {
#pragma unroll
  for (int cy = 0; cy < kWarpY; ++cy) {
    const int kY = cy + 1 - kAr;
    if (kY < 0 || kY > 1) continue;
    const bool top = kY == 0, bot = ddy == kY;
    const float ti = gi * q.w, tr = gr * q.w;   // owy
    const float bi = gi * q.z, br = gr * q.z;   // wy
#pragma unroll
    for (int cx = 0; cx < kWarpX; ++cx) {
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

template <typename G>
__device__ __forceinline__ void pull_segment(
    float ai[kWarpY][kWarpX], float ar[kWarpY][kWarpX], int kAr, int kAc,
    const int* seg, const int* meta, const float4* wts, const int* src,
    const float* rows, const int* pidx, const G* __restrict__ d_rgb,
    const G* __restrict__ d_ray, int k, int C, int lane) {
#pragma unroll 4
  for (int j = seg[k]; j < seg[k + 1]; ++j) {
    const int mt = meta[j];
    const int e = src[j];
    float gi, gr;
    if (kStageRows) {
      gi = rows[e * kRow + lane];
      gr = rows[e * kRow + 32 + lane];
    } else {
      const int ch = min(lane, C - 1);
      gi = to_f(d_rgb[pidx[e] * (3 + C) + 3 + ch]);
      gr = to_f(d_ray[pidx[e] * C + ch]);
    }
    if (!(mt >> 10 & 1)) {   // an invalid point left in: g * 0
      gi *= 0.0f;
      gr *= 0.0f;
    }
    pull_entry(ai, ar, kAr, kAc, gi, gr, wts[j], mt >> 9 & 1, mt >> 8 & 1);
  }
}

// One float of global memory into shared memory, asynchronously
// (cp.async, sm_80+); stage_wait() waits for the thread's copies (and is
// the compiler's barrier for them: nothing reads a destination before it).
__device__ __forceinline__ void stage(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
template <typename G>
__device__ __forceinline__ void stage(float* dst, const G* src) {
  *dst = to_f(*src);
}
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

template <bool kVec, typename G>
__global__ void __launch_bounds__(kPullThreads, 1024 / kPullThreads)
pull_kernel(const float* __restrict__ xy,
            const unsigned char* __restrict__ valid,
            const G* __restrict__ d_rgb, const G* __restrict__ d_ray,
            Index x, float* __restrict__ d_img_feats,
            float* __restrict__ d_ray_feats, int P, int H, int W, int fh,
            int fw, int C) {
  extern __shared__ float4 smem[];
  float* rows = reinterpret_cast<float*>(smem);   // kChunk x kRow
  float4* wts_in = smem + kChunk * kRow / 4;      // wx, owx, wy, owy
  float4* wts = wts_in + kChunk;                  // sorted
  int* meta_in = reinterpret_cast<int*>(wts + kChunk);   // key|ddx|ddy|m
  int* meta = meta_in + kChunk;                   // sorted
  int* pidx = meta + kChunk;
  int* src = pidx + kChunk;                       // sorted: list position
  int* seg = src + kChunk;                        // kKeys + 1
  int* hist = seg + kKeys + 1;                // kRankWarps x kKeys
  const int v = blockIdx.x;
  const int* order = x.order + 3 * (static_cast<size_t>(v) * x.tiles + blockIdx.y);
  const int tile = order[0], begin = order[1], end = order[2];
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
  long long stamps[5] = {0, 0, 0, 0, 0}, stamp = kStamps ? clock64() : 0;
#define STAMP(i)                          \
  if (kStamps) {                          \
    const long long now = clock64();      \
    stamps[i] += now - stamp;             \
    stamp = now;                          \
  }
  // the next chunk's entry of this thread, loaded a chunk ahead
  int4 next = t < min(kChunk, end - begin) ? list[begin + t]
                                           : make_int4(0, 0, 0, 0);
  for (int b = begin; b < end; b += kChunk) {
    const int n = min(kChunk, end - b);
    const int n_next = min(kChunk, end - b - kChunk);
    // 1.
    for (int i = t; i < kRankWarps * kKeys; i += kPullThreads) hist[i] = 0;
    if (t < n) {
      const float2 pxy = make_float2(__int_as_float(next.y),
                                     __int_as_float(next.z));
      const Anchor a = anchor_of(normalised(pxy, H, W),
                                 next.x >= 0 ? 1.0f : 0.0f, fh, fw);
      pidx[t] = next.x & 0x7fffffff;
      wts_in[t] = make_float4(a.wx, a.owx, a.wy, a.owy);
      meta_in[t] = ((a.y - ty0 + 1) * (kTileX + 1) + a.x - tx0 + 1) |
                   a.ddx << 8 | a.ddy << 9 | (a.m != 0.0f) << 10;
    }
    if (t < n_next) next = list[b + kChunk + t];
    __syncthreads();
    STAMP(0);
    // 2. the rows' copies start (list order), then the ranks
    if (kStageRows && lane < C) {
#pragma unroll 4
      for (int e = w; e < n; e += kPullWarps) {
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
    STAMP(1);
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
    STAMP(2);
    // 4. each entry's place in its key's segment, in list order
    if (key >= 0) {
      const int j = seg[key] + hist[w * kKeys + key] + rank;
      meta[j] = meta_in[e];
      wts[j] = wts_in[e];
      src[j] = e;
    }
    if (kStageRows) stage_wait();
    __syncthreads();
    STAMP(3);
    // 5. anchor (by + r, bx + c) of the region, row-major; lanes from C on
    //    sum what is never stored
#pragma unroll
    for (int r = 0; r <= kWarpY; ++r)
#pragma unroll
      for (int c = 0; c <= kWarpX; ++c)
        pull_segment(ai, ar, r, c, seg, meta, wts, src, rows, pidx, d_rgb,
                     d_ray, (by + r) * (kTileX + 1) + bx + c, C, lane);
    __syncthreads();
    STAMP(4);
  }
#undef STAMP
  if (kStamps && t == 0 && v < 64 &&
      (blockIdx.y == 0 || blockIdx.y == gridDim.y / 2)) {
    long long* out = g_stamps[2 * v + (blockIdx.y != 0)];
    for (int i = 0; i < 5; ++i) out[i] = stamps[i];
    out[5] = (end - begin + kChunk - 1) / kChunk;
    out[6] = end - begin;
    out[7] = tile;
  }
  // The NaN path, for a view where an invalid point has a non-finite
  // upstream value (its g * 0 is NaN): every cell that such a point's taps
  // reach gets NaN in those channels (bits set with atomicOr: any order
  // gives the same bits).
  if (kDropInvalid && x.flags[v]) {
    unsigned* nan_bits = reinterpret_cast<unsigned*>(hist);   // [2][cells]
    for (int i = t; i < 2 * kTileY * kTileX; i += kPullThreads) nan_bits[i] = 0;
    __syncthreads();
    for (int p = t; p < P; p += kPullThreads) {
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
              bits[0] |= unsigned(!isfinite(to_f(d_rgb[p * (3 + C) + 3 + ch])))
                         << ch;
              bits[1] |= unsigned(!isfinite(to_f(d_ray[p * C + ch]))) << ch;
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
  // four channels gathered by shuffles), else a float a lane
#pragma unroll
  for (int cy = 0; cy < kWarpY; ++cy)
#pragma unroll
    for (int cx = 0; cx < kWarpX; ++cx) {
      const int y = ty0 + by + cy, xc = tx0 + bx + cx;
      const size_t o = ((static_cast<size_t>(v) * fh + y) * fw + xc) * C;
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
        d_img_feats[o + lane] = ai[cy][cx];
        d_ray_feats[o + lane] = ar[cy][cx];
      }
    }
}

constexpr size_t kPullSmem =
    sizeof(float) * kChunk * kRow + 2 * sizeof(float4) * kChunk +
    sizeof(int) * (4 * kChunk + kKeys + 1 + kRankWarps * kKeys);

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}
bool aligned16(const void* p) { return aligned(p, 16); }

template <typename T>
int forward(const T* imgs, const T* img_feats, const T* ray_feats,
            const float* xy, const unsigned char* valid, T* rgb_out,
            T* ray_out, int V, int P, int H, int W, int fh, int fw, int C,
            cudaStream_t stream) {
  if (V == 0 || P == 0) return 0;
  const dim3 grid((P + kPoints - 1) / kPoints, V);
  // vector reads and stores of four channels
  const size_t v4 = 4 * sizeof(T);
  const bool vec = C % 4 == 0 && aligned(img_feats, v4) &&
                   aligned(ray_feats, v4) && aligned(ray_out, v4);
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

// The bfloat16 instance: bfloat16 maps and outputs (rounded to the nearest
// from the float32 blend), the same coordinates and limits.
extern "C" int epipolar_gather_forward_bf16(
    const bf16* imgs, const bf16* img_feats, const bf16* ray_feats,
    const float* xy, const unsigned char* valid, bf16* rgb_out,
    bf16* ray_out, int V, int P, int H, int W, int fh, int fw, int C,
    cudaStream_t stream) {
  return forward(imgs, img_feats, ray_feats, xy, valid, rgb_out, ray_out, V,
                 P, H, W, fh, fw, C, stream);
}

// Lets the backward's kernels use their dynamic shared memory above 48 KB,
// once per device (a host call that costs more than a small launch).
static cudaError_t allow_smem() {
  static unsigned long long done = 0;   // one bit per device ordinal
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || (done >> dev & 1)) return err;
  const int index_smem = static_cast<int>(sizeof(int)) * kIndexWarps * kMaxTiles;
  err = cudaFuncSetAttribute(index_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             index_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(index_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               index_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pull_kernel<true, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kPullSmem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pull_kernel<false, float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kPullSmem));
  if (err == cudaSuccess) done |= 1ULL << dev;
  return err;
}

// kStamps builds: the stamps of the last call (2 x 64 x 8 long longs).
extern "C" int epipolar_gather_backward_stamps(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)));
}

// int32 elements of the backward's scratch for these sizes; -1 where the
// index cannot take them (more than kMaxTiles tiles a view).
extern "C" long long epipolar_gather_backward_scratch(int V, int P, int fh,
                                                      int fw) {
  const Index x = index_layout(nullptr, V, P, fh, fw);
  return x.tiles > kMaxTiles ? -1 : x.ints;
}

// CUDA launches of one epipolar_gather_backward call without d_imgs (with
// it: the same, the caller zeroes d_imgs).
extern "C" int epipolar_gather_backward_launches() {
  return static_cast<int>(kRunIndex) * 3 + static_cast<int>(kRunPull);
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
  if (V == 0) return 0;
  const Index x = index_layout(scratch, V, P, fh, fw);
  if (x.tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  if (P == 0) {   // no point: both maps' gradients are 0
    const size_t bytes = sizeof(float) * V * fh * fw * C;
    err = cudaMemsetAsync(d_img_feats, 0, bytes, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(d_ray_feats, 0, bytes, stream);
    return static_cast<int>(err);
  }
  err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kRunIndex) {
    const dim3 grid(x.chunks, V);
    const size_t smem = sizeof(int) * kIndexWarps * x.tiles;
    err = cudaMemsetAsync(x.tickets, 0, sizeof(int) * 2 * V, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    index_kernel<false><<<grid, kIndexWarps * 32, smem, stream>>>(
        xy, valid, d_rgb, d_ray, d_imgs, x, P, H, W, fh, fw, C);
    index_kernel<true><<<grid, kIndexWarps * 32, smem, stream>>>(
        xy, valid, d_rgb, d_ray, nullptr, x, P, H, W, fh, fw, C);
  }
  if (kRunPull) {
    const dim3 grid(V, x.tiles);   // the views' longest lists first
    // float4 stores of four channels
    const bool vec = C % 4 == 0 && aligned16(d_img_feats) &&
                     aligned16(d_ray_feats);
    const auto kernel =
        vec ? pull_kernel<true, float> : pull_kernel<false, float>;
    kernel<<<grid, kPullThreads, kPullSmem, stream>>>(
        xy, valid, d_rgb, d_ray, x, d_img_feats, d_ray_feats, P, H, W, fh, fw,
        C);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's kernels as built, on the current card: for the count, the
// fill and the pull kernel (vector path), registers a thread, spilled
// (local) bytes a thread, static shared memory; then the pull's dynamic
// shared memory and its resident blocks per SM.
extern "C" int epipolar_gather_backward_info(int* out) {
  cudaFuncAttributes attr[3];
  cudaError_t err = cudaFuncGetAttributes(&attr[0], index_kernel<false>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr[1], index_kernel<true>);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr[2], pull_kernel<true, float>);
  if (err == cudaSuccess) err = allow_smem();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pull_kernel<true, float>, kPullThreads, kPullSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < 3; ++i) {
    out[3 * i] = attr[i].numRegs;
    out[3 * i + 1] = static_cast<int>(attr[i].localSizeBytes);
    out[3 * i + 2] = static_cast<int>(attr[i].sharedSizeBytes);
  }
  out[9] = static_cast<int>(kPullSmem);
  out[10] = per_sm;
  return 0;
}
