// Texture resample (K10).
//
// Replaces rtsdm_tpu/ops/warp_pallas.py:_warp_kernel (called by
// warp_resample_pallas). The TPU has no gather, so its kernel DMA'd a
// bounding region of the texture into VMEM per 8x128 block and ran the
// filter as one-hot matrix products, with a fallback plane where the tap
// spread left the region. A GPU thread reads any texel, so there is no
// fallback here.
//
// Bounded by memory: at TAA's shape ([3, 1208, 2048] -> [3, 1208, 2048])
// the traffic that cannot be avoided is the texture and the positions read
// once and the output written once (79 MB, 0.024 ms at 3.35 TB/s); the
// taps of neighbouring pixels overlap and hit L1/L2, so what costs is the
// gathers' L1 traffic. What the design does about it:
// * each thread owns kPx = 4 output pixels of a row, 32 apart along x, so
//   a warp owns 128 pixels and every gather instruction of the warp reads
//   the taps of 32 neighbouring pixels, which share their cache lines
//   (four pixels next to each other in one thread, read as one float4,
//   spread each gather over four lines and measured no faster); positions
//   are read and outputs written 128 bytes a warp, a ragged row masked in
//   the same kernel;
// * the channel count is a template parameter for the paths' 1 and 3 (a
//   generic loop serves any other), so every channel's taps are issued
//   before any blend; bilinear and nearest interleave a thread's four
//   pixels, so all their gathers are in flight together, while
//   Catmull-Rom (36 gathers a channel) takes them one at a time, in 64
//   registers instead of 96, which leaves room for twice the warps;
// * offsets are 32-bit (the wrapper refuses a texture or a target of 2^31
//   values or more);
// * blocks are 2-D, 32 x 8 threads (128 x 8 pixels), so rows y and y+1 of
//   the bilinear footprint are shared in L1 by neighbouring rows of the
//   block; a target of fewer than 8 rows takes 256 x 1 threads;
// * Catmull-Rom computes its three x and three y tap positions, their uv
//   round trips, floors, fractions and clamped indices once per axis (6
//   divides, not 18), then sums the nine blends in the reference's order.
//
// Semantics follow the reference's XLA samplers operation by operation
// (passes/temporal.py:_bilinear :39-54, _catmull_rom :57-85, and the
// gather of scene/textures.py:sample_env :212-225), which is also what the
// plain PyTorch version in ops/warp_cuda.py evaluates: bilinear taps at
// floor(p - 0.5) and +1, clamped (or wrapped in x), blended as
// (t00 (1-fx) + t01 fx)(1-fy) + (t10 (1-fx) + t11 fx) fy; Catmull-Rom as
// the nine bilinear taps of TAA.ps.slang:45-76 in that order, each through
// uv = p / size and back; nearest at floor(p). Built with --fmad=false and
// no fast math, so every expression rounds like the plain version.
#include <cuda_runtime.h>

namespace {

constexpr int kPx = 4;  // output pixels per thread, blockDim.x apart in x
enum Mode { kNearest = 0, kBilinear = 1, kCatmullRom = 2 };

__device__ __forceinline__ int tap_x(int i, int w, int wrap) {
  if (wrap) {
    const int r = i % w;
    return r < 0 ? r + w : r;
  }
  return min(max(i, 0), w - 1);
}

__device__ __forceinline__ int tap_y(int i, int h) {
  return min(max(i, 0), h - 1);
}

// One axis of a bilinear footprint at continuous texel coordinate v
// (texel centres at integers): the two texel indices (row offsets for y)
// and the fraction.
struct Axis {
  int a, b;
  float f;
};

__device__ __forceinline__ Axis x_axis(float v, int w, int wrap) {
  const float v0 = floorf(v);
  const int i = (int)v0;
  return {tap_x(i, w, wrap), tap_x(i + 1, w, wrap), v - v0};
}

__device__ __forceinline__ Axis y_axis(float v, int h, int w) {
  const float v0 = floorf(v);
  const int i = (int)v0;
  return {tap_y(i, h) * w, tap_y(i + 1, h) * w, v - v0};
}

// The four texels of footprint (ax, ay) in CC planes, all gathered before
// any of them is blended.
template <int CC>
__device__ __forceinline__ void gather4(const float* __restrict__ tex,
                                        int plane, const Axis& ax,
                                        const Axis& ay, float (&t)[CC][4]) {
#pragma unroll
  for (int c = 0; c < CC; ++c) {
    const float* p = tex + c * plane;
    t[c][0] = __ldg(p + ay.a + ax.a);
    t[c][1] = __ldg(p + ay.a + ax.b);
    t[c][2] = __ldg(p + ay.b + ax.a);
    t[c][3] = __ldg(p + ay.b + ax.b);
  }
}

__device__ __forceinline__ float blend(const float (&t)[4], float fx,
                                       float fy) {
  const float a = t[0] * (1.0f - fx) + t[1] * fx;
  const float c = t[2] * (1.0f - fx) + t[3] * fx;
  return a * (1.0f - fy) + c * fy;
}

// Catmull-Rom weights along one axis (TAA.ps.slang:45-60): tap positions
// tc - 1, tc + w2 / w12, tc + 2 and their weights w0, w12, w3.
__device__ __forceinline__ void cr_axis(float p, float (&pos)[3],
                                        float (&wt)[3]) {
  const float tc = floorf(p - 0.5f) + 0.5f;
  const float f = p - tc;
  const float f2 = f * f;
  const float f3 = f * f * f;
  const float w0 = f2 - 0.5f * (f3 + f);
  const float w1 = 1.5f * f3 - 2.5f * f2 + 1.0f;
  const float w3 = 0.5f * (f3 - f2);
  const float w2 = 1.0f - w0 - w1 - w3;
  const float w12 = w1 + w2;
  pos[0] = tc - 1.0f;
  pos[1] = tc + w2 / (w12 == 0.0f ? 1.0f : w12);
  pos[2] = tc + 2.0f;
  wt[0] = w0;
  wt[1] = w12;
  wt[2] = w3;
}

// CC channels of one output pixel at (px, py).
template <int MODE, int CC>
__device__ __forceinline__ void sample(const float* __restrict__ tex,
                                       int plane, int h, int w, int wrap,
                                       float px, float py, float (&v)[CC]) {
  if (MODE == kNearest) {
    const int o = tap_y((int)floorf(py), h) * w +
                  tap_x((int)floorf(px), w, wrap);
#pragma unroll
    for (int c = 0; c < CC; ++c) v[c] = __ldg(tex + c * plane + o);
  } else if (MODE == kBilinear) {
    const Axis ax = x_axis(px - 0.5f, w, wrap);
    const Axis ay = y_axis(py - 0.5f, h, w);
    float t[CC][4];
    gather4<CC>(tex, plane, ax, ay, t);
#pragma unroll
    for (int c = 0; c < CC; ++c) v[c] = blend(t[c], ax.f, ay.f);
  } else {
    // nine bilinear taps, x outer, y inner, summed in that order; each
    // axis position goes through uv = p / size and back once
    float xs[3], wx[3], ys[3], wy[3];
    cr_axis(px, xs, wx);
    cr_axis(py, ys, wy);
    const float wf = (float)w, hf = (float)h;
    Axis ax[3], ay[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      ax[a] = x_axis((xs[a] / wf) * wf - 0.5f, w, wrap);
      ay[a] = y_axis((ys[a] / hf) * hf - 0.5f, h, w);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float t[CC][4];
        gather4<CC>(tex, plane, ax[a], ay[b], t);
        const float wt = wx[a] * wy[b];
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const float s = blend(t[c], ax[a].f, ay[b].f) * wt;
          v[c] = (a == 0 && b == 0) ? s : v[c] + s;
        }
      }
    }
  }
}

// Channels [c0, c0 + CC) of output pixel x of the row starting at flat
// index row: the pixel's taps gathered, blended and stored.
template <int MODE, int CC>
__device__ __forceinline__ void pixel(const float* __restrict__ tex,
                                      int plane, int h, int w, int wrap,
                                      const float* __restrict__ sx,
                                      const float* __restrict__ sy, int row,
                                      int x, int c0, int n_out,
                                      float* __restrict__ out) {
  float v[CC];
  sample<MODE, CC>(tex + c0 * plane, plane, h, w, wrap,
                   __ldg(sx + row + x), __ldg(sy + row + x), v);
#pragma unroll
  for (int c = 0; c < CC; ++c) out[(c0 + c) * n_out + row + x] = v[c];
}

// Every channel (C of them, or c at run time where C is 0) of output pixel
// x of the row starting at flat index row.
template <int MODE, int C>
__device__ __forceinline__ void pixel_all(const float* __restrict__ tex,
                                          int c, int h, int w, int wrap,
                                          const float* __restrict__ sx,
                                          const float* __restrict__ sy,
                                          int row, int x, int n_out,
                                          float* __restrict__ out) {
  if (C > 0) {
    pixel<MODE, (C > 0 ? C : 1)>(tex, h * w, h, w, wrap, sx, sy, row, x, 0,
                                 n_out, out);
  } else {
    for (int c0 = 0; c0 < c; ++c0)
      pixel<MODE, 1>(tex, h * w, h, w, wrap, sx, sy, row, x, c0, n_out, out);
  }
}

// C: the channel count, or 0 for any (c at run time). A thread's kPx
// pixels are blockDim.x apart; bilinear and nearest interleave them (their
// gathers all in flight at once), Catmull-Rom takes them one at a time
// (each has 36 gathers a channel in flight, and fewer registers leave room
// for more warps).
template <int MODE, int C>
__global__ void warp_resample_kernel(const float* __restrict__ tex,
                                     const float* __restrict__ sx,
                                     const float* __restrict__ sy, int c,
                                     int h, int w, int ho, int wo,
                                     int blocks_x, int wrap_x,
                                     float* __restrict__ out) {
  const int bx = blockIdx.x % blocks_x;
  const int by = blockIdx.x / blocks_x;
  const int y = by * blockDim.y + threadIdx.y;
  const int x0 = bx * blockDim.x * kPx + threadIdx.x;
  if (y >= ho) return;
  const int row = y * wo;
  const int n_out = ho * wo;
  if (MODE == kCatmullRom) {
#pragma unroll 1
    for (int j = 0; j < kPx; ++j) {
      const int x = x0 + j * blockDim.x;
      if (x < wo)
        pixel_all<MODE, C>(tex, c, h, w, wrap_x, sx, sy, row, x, n_out, out);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int x = x0 + j * blockDim.x;
      if (x < wo)
        pixel_all<MODE, C>(tex, c, h, w, wrap_x, sx, sy, row, x, n_out, out);
    }
  }
}

template <int MODE, int C>
cudaError_t launch_c(const float* tex, const float* sx, const float* sy,
                     int c, int h, int w, int ho, int wo, int wrap_x,
                     float* out, cudaStream_t stream) {
  const dim3 block = ho >= 8 ? dim3(32, 8) : dim3(256, 1);
  const int blocks_x = (wo + kPx * block.x - 1) / (kPx * block.x);
  const int blocks_y = (ho + block.y - 1) / block.y;
  const long long blocks = (long long)blocks_x * blocks_y;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  warp_resample_kernel<MODE, C><<<(int)blocks, block, 0, stream>>>(
      tex, sx, sy, c, h, w, ho, wo, blocks_x, wrap_x, out);
  return cudaSuccess;
}

template <int MODE>
cudaError_t launch_mode(const float* tex, const float* sx, const float* sy,
                        int c, int h, int w, int ho, int wo, int wrap_x,
                        float* out, cudaStream_t stream) {
  if (c == 1)
    return launch_c<MODE, 1>(tex, sx, sy, c, h, w, ho, wo, wrap_x, out,
                             stream);
  if (c == 3)
    return launch_c<MODE, 3>(tex, sx, sy, c, h, w, ho, wo, wrap_x, out,
                             stream);
  return launch_c<MODE, 0>(tex, sx, sy, c, h, w, ho, wo, wrap_x, out,
                           stream);
}

}  // namespace

// tex: [c, h, w] float; sx, sy: [ho, wo] float (pixel units, texel centres
// at +0.5); out: [c, ho, wo]. mode 0 nearest, 1 bilinear, 2 Catmull-Rom.
// c*h*w and c*ho*wo below 2^31.
extern "C" int rtsdm_warp_resample(const float* tex, const float* sx,
                                   const float* sy, int c, int h, int w,
                                   int ho, int wo, int mode, int wrap_x,
                                   float* out, cudaStream_t stream) {
  if (mode < 0 || mode > 2 || c <= 0 || h <= 0 || w <= 0 || ho < 0 ||
      wo < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)ho * wo == 0) return (int)cudaGetLastError();
  cudaError_t err;
  if (mode == kNearest)
    err = launch_mode<kNearest>(tex, sx, sy, c, h, w, ho, wo, wrap_x, out,
                                stream);
  else if (mode == kBilinear)
    err = launch_mode<kBilinear>(tex, sx, sy, c, h, w, ho, wo, wrap_x, out,
                                 stream);
  else
    err = launch_mode<kCatmullRom>(tex, sx, sy, c, h, w, ho, wo, wrap_x, out,
                                   stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
