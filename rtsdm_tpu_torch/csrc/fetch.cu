// Level-select shifted fetches of SVAO's deinterleaved planes (K3, K4).
//
// K3 replaces rtsdm_tpu/ops/fetch_pallas.py:_fetch_fused_kernel (driver
// fetch_all_directions): for every ring direction d, dither class c and
// quarter-res texel q of the 16 deinterleaved depth planes, the radius
// level l = #{bounds b : radius(c, q) * radii[d] > b} picks a source class
// c2 and a static offset (y, x) from a table built once per configuration,
// and the output is planes[c2, y + qy, x + qx]. On the TPU this was a select
// chain over every level of a VMEM-resident halo, because the TPU has no
// gather; here it is one thread per output texel doing one table lookup and
// one load per plane set. Bounded by memory: per texel one radius read, one
// table read (cached) and one scattered but locally coherent plane read per
// set, one write per set.
//
// K4 replaces fetch_pallas.py:_fetch_sd_kernel (driver fetch_sd_packed):
// the same level selection over the 16-bit-pair-packed SD planes
// [kp, sd_h, sd_w] (divisor 4: the SD texel of a class-c pixel plus offset
// is a stride-1 shift), reading sd[kk, y0 + qy, x0 + qx] for every packed
// plane kk with the clamped global origin (y0, x0) of the table.
//
// The level is computed exactly as rtsdm_tpu/ops/ao.py:shift_level_index:
// a float32 product compared with float32 bounds (the float64 geometric
// midpoints rounded to float32). Built with --fmad=false.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int level_of(float r, const float* bounds,
                                        int n_bounds) {
  int lvl = 0;
  for (int b = 0; b < n_bounds; ++b) lvl += (r > bounds[b]) ? 1 : 0;
  return lvl;
}

__global__ void fetch_directions_kernel(
    const float* __restrict__ planes, const float* __restrict__ radius,
    const float* __restrict__ bounds, const float* __restrict__ radii,
    const int* __restrict__ tab, int n_src, int nd, int n_levels, int qh,
    int qw, int ph, int pw, float* __restrict__ out) {
  const long long total = (long long)nd * 16 * qh * qw;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int qx = (int)(i % qw);
  long long rem = i / qw;
  const int qy = (int)(rem % qh);
  rem /= qh;
  const int c = (int)(rem % 16);
  const int d = (int)(rem / 16);
  const float r = radius[((size_t)c * qh + qy) * qw + qx] * radii[d];
  const int lvl = level_of(r, bounds, n_levels - 1);
  const int* e = tab + (((size_t)d * 16 + c) * n_levels + lvl) * 3;
  const int c2 = e[0], y = e[1] + qy, x = e[2] + qx;
  for (int s = 0; s < n_src; ++s)
    out[((((size_t)s * nd + d) * 16 + c) * qh + qy) * qw + qx] =
        planes[(((size_t)s * 16 + c2) * ph + y) * pw + x];
}

__global__ void fetch_sd_packed_kernel(
    const int* __restrict__ sd, const float* __restrict__ radius,
    const float* __restrict__ bounds, const float* __restrict__ radii,
    const int* __restrict__ tab, int kp, int nd, int n_levels, int qh,
    int qw, int sd_h, int sd_w, int* __restrict__ out) {
  const long long total = (long long)nd * 16 * qh * qw;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int qx = (int)(i % qw);
  long long rem = i / qw;
  const int qy = (int)(rem % qh);
  rem /= qh;
  const int c = (int)(rem % 16);
  const int d = (int)(rem / 16);
  const float r = radius[((size_t)c * qh + qy) * qw + qx] * radii[d];
  const int lvl = level_of(r, bounds, n_levels - 1);
  const int* e = tab + (((size_t)d * n_levels + lvl) * 16 + c) * 2;
  const int y = e[0] + qy, x = e[1] + qx;
  for (int kk = 0; kk < kp; ++kk)
    out[((((size_t)d * 16 + c) * kp + kk) * qh + qy) * qw + qx] =
        sd[((size_t)kk * sd_h + y) * sd_w + x];
}

}  // namespace

// planes [n_src, 16, ph, pw]; radius [16, qh, qw]; bounds [n_levels - 1];
// radii [nd]; tab [nd, 16, n_levels, 3] = (c2, y, x); out
// [n_src, nd, 16, qh, qw].
extern "C" int rtsdm_fetch_directions(const float* planes,
                                      const float* radius,
                                      const float* bounds, const float* radii,
                                      const int* tab, int n_src, int nd,
                                      int n_levels, int qh, int qw, int ph,
                                      int pw, float* out,
                                      cudaStream_t stream) {
  const long long total = (long long)nd * 16 * qh * qw;
  if (total > 0)
    fetch_directions_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                              stream>>>(planes, radius, bounds, radii, tab,
                                        n_src, nd, n_levels, qh, qw, ph, pw,
                                        out);
  return (int)cudaGetLastError();
}

// sd [kp, sd_h, sd_w]; tab [nd, n_levels, 16, 2] = (y0, x0); out
// [nd, 16, kp, qh, qw].
extern "C" int rtsdm_fetch_sd_packed(const int* sd, const float* radius,
                                     const float* bounds, const float* radii,
                                     const int* tab, int kp, int nd,
                                     int n_levels, int qh, int qw, int sd_h,
                                     int sd_w, int* out,
                                     cudaStream_t stream) {
  const long long total = (long long)nd * 16 * qh * qw;
  if (total > 0)
    fetch_sd_packed_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                             stream>>>(sd, radius, bounds, radii, tab, kp, nd,
                                       n_levels, qh, qw, sd_h, sd_w, out);
  return (int)cudaGetLastError();
}
