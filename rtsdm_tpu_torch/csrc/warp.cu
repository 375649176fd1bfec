// Texture resample (K10).
//
// Replaces rtsdm_tpu/ops/warp_pallas.py:_warp_kernel (called by
// warp_resample_pallas). The TPU has no gather, so its kernel DMA'd a
// bounding region of the texture into VMEM per 8x128 block and ran the
// filter as one-hot matrix products, with a fallback plane where the tap
// spread left the region. A GPU thread reads any texel, so here one thread
// owns one output pixel: it computes the tap positions and weights once and
// loops over the channels, reading the planar texture through the
// read-only cache. There is no fallback.
//
// Bounded by memory: at TAA's shape ([3, 1208, 2048] -> [3, 1208, 2048])
// each output value needs ~40 flops and the input texels are shared by
// neighbouring threads, so the traffic that cannot be avoided is the
// texture and the positions read once and the output written once; the
// taps of neighbouring pixels overlap and hit L1/L2.
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

constexpr int kThreads = 256;

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

// One bilinear tap set at continuous texel coordinates (x, y): the four
// texel offsets and the fractional weights.
struct Bilinear {
  int o00, o01, o10, o11;
  float fx, fy;
};

__device__ __forceinline__ Bilinear bilinear_at(float x, float y, int h,
                                                int w, int wrap) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  Bilinear b;
  b.fx = x - x0;
  b.fy = y - y0;
  const int xi = (int)x0, yi = (int)y0;
  const int xa = tap_x(xi, w, wrap), xb = tap_x(xi + 1, w, wrap);
  const int ya = tap_y(yi, h), yb = tap_y(yi + 1, h);
  b.o00 = ya * w + xa;
  b.o01 = ya * w + xb;
  b.o10 = yb * w + xa;
  b.o11 = yb * w + xb;
  return b;
}

__device__ __forceinline__ float blend(const float* __restrict__ plane,
                                       const Bilinear& b) {
  const float a = __ldg(plane + b.o00) * (1.0f - b.fx) +
                  __ldg(plane + b.o01) * b.fx;
  const float c = __ldg(plane + b.o10) * (1.0f - b.fx) +
                  __ldg(plane + b.o11) * b.fx;
  return a * (1.0f - b.fy) + c * b.fy;
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

__global__ void warp_resample_kernel(const float* __restrict__ tex,
                                     const float* __restrict__ sx,
                                     const float* __restrict__ sy, int c,
                                     int h, int w, int n_out, int mode,
                                     int wrap_x, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const size_t plane = (size_t)h * w;
  const float px = sx[i];
  const float py = sy[i];

  if (mode == 0) {  // nearest
    const int o = tap_y((int)floorf(py), h) * w +
                  tap_x((int)floorf(px), w, wrap_x);
    for (int ch = 0; ch < c; ++ch)
      out[(size_t)ch * n_out + i] = __ldg(tex + ch * plane + o);
    return;
  }
  if (mode == 1) {  // bilinear
    const Bilinear b = bilinear_at(px - 0.5f, py - 0.5f, h, w, wrap_x);
    for (int ch = 0; ch < c; ++ch)
      out[(size_t)ch * n_out + i] = blend(tex + ch * plane, b);
    return;
  }
  // Catmull-Rom: nine bilinear taps, x outer, y inner, summed in order
  float xs[3], wx[3], ys[3], wy[3];
  cr_axis(px, xs, wx);
  cr_axis(py, ys, wy);
  const float wf = (float)w, hf = (float)h;
  Bilinear taps[9];
  float wts[9];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      taps[3 * a + b] = bilinear_at((xs[a] / wf) * wf - 0.5f,
                                    (ys[b] / hf) * hf - 0.5f, h, w, wrap_x);
      wts[3 * a + b] = wx[a] * wy[b];
    }
  }
  for (int ch = 0; ch < c; ++ch) {
    const float* p = tex + ch * plane;
    float acc = blend(p, taps[0]) * wts[0];
#pragma unroll
    for (int k = 1; k < 9; ++k) acc = acc + blend(p, taps[k]) * wts[k];
    out[(size_t)ch * n_out + i] = acc;
  }
}

}  // namespace

// tex: [c, h, w] float; sx, sy: [n_out] float (pixel units, texel centres
// at +0.5); out: [c, n_out]. mode 0 nearest, 1 bilinear, 2 Catmull-Rom.
extern "C" int rtsdm_warp_resample(const float* tex, const float* sx,
                                   const float* sy, int c, int h, int w,
                                   int n_out, int mode, int wrap_x,
                                   float* out, cudaStream_t stream) {
  if (mode < 0 || mode > 2 || h <= 0 || w <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_out > 0)
    warp_resample_kernel<<<(n_out + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(tex, sx, sy, c, h, w, n_out, mode,
                                     wrap_x, out);
  return (int)cudaGetLastError();
}
