// InstanceNorm fused with what surrounds it in the view encoders (sm_90a,
// float32).
//
// Replaces no TPU kernel. The JAX encoders (graspnerf_tpu/models/
// nn_blocks.py) leave InstanceNorm, its activation, the residual adds and
// the reflect pads of the next convolution to XLA, which fuses them. In
// PyTorch each is its own kernel (a batch norm over [1, V*C, H, W] after
// two repeats of its weight and bias, the activation, the add, `F.pad`),
// and each writes its plane to device memory for the next to read back.
// Here one launch does a norm and all of that:
//
//   s = x (+ add)                 the pre-norm shortcut sum (ResidualBlock),
//                                 written to sum_out for the next shortcut
//   y = (s - mean) * rsqrt(var + eps) * w[c] + b[c] (+ res)
//                                 res: BasicBlock's shortcut, added after
//                                 the affine
//   y = relu(y) | elu(y) | y
//
// written unpadded (out) and/or with a reflect border of p pixels (padded:
// F.pad(y, (p,)*4, "reflect"), the edge not repeated) into a [V, C, H+2p,
// W+2p] view whose views lie pstride floats apart, so that it can be a
// channel slice of a concatenation. With up, padded holds instead the
// bilinear x2 upsampling of y (align_corners, PyTorch's arithmetic),
// reflect-padded: [V, C, 2H+2p, 2W+2p], the input of a decoder's
// convolution. Statistics are float32 and taken from the on-chip copy of
// the plane: the mean, then the biased variance as the mean of squared
// deviations from it.
//
// Bound: bytes. A norm reads each input plane once (x, add, res) and
// writes each output once (sum_out, out, padded); a handful of operations
// an element. Design: a block a plane, and the block's threads, as the
// wrapper picks them (ops/instance_norm.py `launch_plan`). The plane is
// read once from device memory into shared memory with 16-byte loads where
// rows allow, reduced, normalised in place, and written once. The padded
// (or upsampled) output is stored row by row, a warp a row, each lane a
// column: stores of consecutive floats, which the border's p-float offset
// leaves off 16-byte boundaries; a row reads the rows of the copy it
// reflects or interpolates. A plane beyond one block's shared memory is
// refused by the wrapper: the encoders' largest, 144 x 256 at 288 x 512
// images, takes 147,456 bytes.
// Sums are taken in a fixed order, so two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kNone = 0, kRelu = 1, kElu = 2 };

constexpr int kMaxThreads = 1024;

struct Args {
  const float* x;
  const float* add;   // pre-norm addend, or null
  const float* res;   // post-affine addend, or null
  const float* w;
  const float* b;
  float* sum_out;     // x + add, or null
  float* out;         // y, or null
  float* padded;      // y (upsampled, with up) reflect-padded, or null
  long long pstride;  // floats between views of padded
  int planes, C, H, W, pad, up, act, vec;
  float eps;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);  // lane 0's sum, on every lane
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * (n - 1) - i : i);
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == kRelu) return y <= 0.f ? 0.f : y;  // NaN stays NaN
  if (act == kElu) return y > 0.f ? y : expm1f(y);
  return y;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The plane's sum of each thread's v: the block's warps' in order.
__device__ float plane_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // red is free again
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0.f;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) v += red[i];
  return v;
}

__global__ void __launch_bounds__(kMaxThreads) norm_kernel(const Args a) {
  extern __shared__ __align__(16) float s[];
  __shared__ float red[kMaxThreads / 32];
  const int H = a.H, W = a.W, n = H * W;
  const int plane = blockIdx.x;
  const int t = threadIdx.x, nt = blockDim.x;
  const size_t off = static_cast<size_t>(plane) * n;

  // 1. the plane into shared memory (x + add), and its sum
  float acc = 0.f;
  if (a.vec) {
    const float4* x4 = reinterpret_cast<const float4*>(a.x + off);
    const float4* a4 = reinterpret_cast<const float4*>(a.add ? a.add + off
                                                              : nullptr);
    float4* o4 = reinterpret_cast<float4*>(a.sum_out ? a.sum_out + off
                                                     : nullptr);
    float4* s4 = reinterpret_cast<float4*>(s);
    for (int i = t; i < n / 4; i += nt) {
      float4 v = x4[i];
      if (a4) v = add4(v, a4[i]);
      if (o4) o4[i] = v;
      s4[i] = v;
      acc += (v.x + v.y) + (v.z + v.w);
    }
  } else {
    for (int i = t; i < n; i += nt) {
      float v = a.x[off + i];
      if (a.add) v += a.add[off + i];
      if (a.sum_out) a.sum_out[off + i] = v;
      s[i] = v;
      acc += v;
    }
  }
  const float mean = plane_sum(acc, red) / static_cast<float>(n);

  // 2. the biased variance, from the same elements of the copy
  acc = 0.f;
  if (a.vec) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    for (int i = t; i < n / 4; i += nt) {
      const float4 v = s4[i];
      const float dx = v.x - mean, dy = v.y - mean, dz = v.z - mean,
                  dw = v.w - mean;
      acc += (dx * dx + dy * dy) + (dz * dz + dw * dw);
    }
  } else {
    for (int i = t; i < n; i += nt) {
      const float d = s[i] - mean;
      acc += d * d;
    }
  }
  const float var = plane_sum(acc, red) / static_cast<float>(n);
  const int c = plane % a.C;
  const float rstd = rsqrtf(var + a.eps);
  const float wc = a.w[c], bc = a.b[c];

  // 3. normalise, affine, residual, activation: in place, and out
  if (a.vec) {
    float4* s4 = reinterpret_cast<float4*>(s);
    const float4* r4 = reinterpret_cast<const float4*>(a.res ? a.res + off
                                                             : nullptr);
    float4* y4 = reinterpret_cast<float4*>(a.out ? a.out + off : nullptr);
    for (int i = t; i < n / 4; i += nt) {
      float4 v = s4[i];
      v.x = (v.x - mean) * rstd * wc + bc;
      v.y = (v.y - mean) * rstd * wc + bc;
      v.z = (v.z - mean) * rstd * wc + bc;
      v.w = (v.w - mean) * rstd * wc + bc;
      if (r4) v = add4(v, r4[i]);
      v.x = activate(v.x, a.act);
      v.y = activate(v.y, a.act);
      v.z = activate(v.z, a.act);
      v.w = activate(v.w, a.act);
      s4[i] = v;
      if (y4) y4[i] = v;
    }
  } else {
    for (int i = t; i < n; i += nt) {
      float v = (s[i] - mean) * rstd * wc + bc;
      if (a.res) v += a.res[off + i];
      v = activate(v, a.act);
      s[i] = v;
      if (a.out) a.out[off + i] = v;
    }
  }

  // 4. the padded rows, each from the rows of the copy it reflects (and,
  // with up, interpolates)
  if (a.padded) {
    __syncthreads();
    const int p = a.pad, f = a.up ? 2 : 1;
    const int Hu = f * H, Wu = f * W, Hp = Hu + 2 * p, Wp = Wu + 2 * p;
    float* dst = a.padded + static_cast<size_t>(plane / a.C) * a.pstride +
                 static_cast<size_t>(c) * Hp * Wp;
    // align_corners scales, as PyTorch's upsample_bilinear2d computes them
    const float sh = Hu > 1 ? static_cast<float>(H - 1) / (Hu - 1) : 0.f;
    const float sw = Wu > 1 ? static_cast<float>(W - 1) / (Wu - 1) : 0.f;
    const int warp = t >> 5, warps = nt >> 5, lane = t & 31;
    for (int orow = warp; orow < Hp; orow += warps) {
      const int u = reflect(orow - p, Hu);
      float* drow = dst + static_cast<size_t>(orow) * Wp;
      if (!a.up) {
        const float* src = s + static_cast<size_t>(u) * W;
        for (int oc = lane; oc < Wp; oc += 32)
          drow[oc] = src[reflect(oc - p, W)];
        continue;
      }
      const float hr = sh * u;
      const int h0 = static_cast<int>(hr), hp = h0 < H - 1 ? 1 : 0;
      const float hl1 = hr - h0, hl0 = 1.f - hl1;
      const float* top = s + static_cast<size_t>(h0) * W;
      const float* bot = top + static_cast<size_t>(hp) * W;
      for (int oc = lane; oc < Wp; oc += 32) {
        const float wr = sw * reflect(oc - p, Wu);
        const int w0 = static_cast<int>(wr), wp = w0 < W - 1 ? 1 : 0;
        const float wl1 = wr - w0, wl0 = 1.f - wl1;
        drow[oc] = hl0 * (wl0 * top[w0] + wl1 * top[w0 + wp]) +
                   hl1 * (wl0 * bot[w0] + wl1 * bot[w0 + wp]);
      }
    }
  }
}

}  // namespace

extern "C" int instance_norm_max_threads() { return kMaxThreads; }

// One launch: planes = V * C planes of H x W, a block each; padded, with
// up, holds the 2H x 2W bilinear upsampling (align_corners)
// reflect-padded; threads and the dynamic shared memory (the plane) as
// `launch_plan` picks them. act: 0 none, 1 ReLU, 2 ELU. Returns the
// launch's cudaError_t.
extern "C" int instance_norm_act_forward(
    const float* x, const float* add, const float* res, const float* w,
    const float* b, float* sum_out, float* out, float* padded,
    long long pstride, int planes, int C, int H, int W, int pad, int up,
    int act, float eps, int threads, int smem_bytes, cudaStream_t stream) {
  if (planes == 0) return 0;
  if (threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t addr = reinterpret_cast<size_t>(x) |
                      reinterpret_cast<size_t>(add) |
                      reinterpret_cast<size_t>(res) |
                      reinterpret_cast<size_t>(sum_out) |
                      reinterpret_cast<size_t>(out);
  Args a{x, add, res, w, b, sum_out, out, padded, pstride, planes, C, H, W,
         pad, up, act, W % 4 == 0 && addr % 16 == 0, eps};
  cudaError_t err = cudaFuncSetAttribute(
      norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_kernel<<<planes, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The kernel as built, on the current card: registers and spilled (local)
// bytes a thread, static shared memory, most threads a block.
extern "C" int instance_norm_act_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, norm_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = static_cast<int>(attr.sharedSizeBytes);
  out[3] = attr.maxThreadsPerBlock;
  return 0;
}
