// Level-select shifted fetches of SVAO's deinterleaved planes (K3, K4).
//
// K3 replaces rtsdm_tpu/ops/fetch_pallas.py:_fetch_fused_kernel (driver
// fetch_all_directions): for every ring direction d, dither class c and
// quarter-res texel q of the 16 deinterleaved depth planes, the radius
// level l = #{bounds b : radius(c, q) * radii[d] > b} picks a source class
// c2 and a static offset (y, x) from a table built once per configuration,
// and the output is planes[c2, y + qy, x + qx]. On the TPU this was a select
// chain over every level of a VMEM-resident halo, because the TPU has no
// gather; here it is a gather. Bounded by memory (a radius read per texel,
// a scattered but locally coherent plane read and a write per direction and
// set), so the kernel spends nothing else on the way: a block is a 32x8
// tile of one class's quarter texels (x fastest, so every write of a warp
// is one 128-byte line), a thread reads its texel's radius once and serves
// all nd directions, the class's table slice, the level bounds and radii
// sit in shared memory, the level is a binary search of the sorted bounds
// (the same count of bounds below r), and all index arithmetic is 32-bit
// (the wrapper checks the sizes fit).
//
// K4 replaces fetch_pallas.py:_fetch_sd_kernel (driver fetch_sd_packed):
// the same level selection over the 16-bit-pair-packed SD planes
// [kp, sd_h, sd_w] (divisor 4: the SD texel of a class-c pixel plus offset
// is a stride-1 shift), reading sd[kk, y0 + qy, x0 + qx] for every packed
// plane kk with the clamped global origin (y0, x0) of the table.
//
// K6 replaces fetch_pallas.py:fetch_taps_same_class (the HBAO ring, driven
// from rtsdm_tpu/passes/hbao.py): tap t = d * taps + k of direction d and
// step k reads, for class c and quarter texel q, the class's OWN padded
// plane (no cross-class remap: HBAO samples within one deinterleave slice)
// at the static offset tab[d, c, lvl[k, c, q]], a level given per step.
// The TPU's select chain over every level, its per-tile halo DMA and its
// dedup of equal consecutive offsets were workarounds for the missing
// gather; here it is one thread per output texel doing one table lookup
// and one load per plane set. Bounded by memory, as K3.
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

constexpr int kTileX = 32, kTileY = 8;   // K3's block: a tile of texels
constexpr int kMaxBounds = 63;           // rtsdm_tpu_torch/ops/fetch_cuda.py
constexpr int kMaxDirs = 64;

__global__ void __launch_bounds__(kTileX * kTileY)
    fetch_directions_kernel(const float* __restrict__ planes,
                            const float* __restrict__ radius,
                            const float* __restrict__ bounds,
                            const float* __restrict__ radii,
                            const int* __restrict__ tab, int n_src, int nd,
                            int n_levels, int qh, int qw, int ph, int pw,
                            float* __restrict__ out) {
  __shared__ float sb[kMaxBounds];
  __shared__ float sr[kMaxDirs];
  extern __shared__ int st[];  // tab[:, c] as [nd, n_levels, 3]
  const int c = blockIdx.z;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int n_b = n_levels - 1;
  const int row = n_levels * 3;
  for (int i = tid; i < n_b; i += kTileX * kTileY) sb[i] = bounds[i];
  for (int i = tid; i < nd; i += kTileX * kTileY) sr[i] = radii[i];
  for (int i = tid; i < nd * row; i += kTileX * kTileY) {
    const int d = i / row;
    st[i] = tab[(d * 16 + c) * row + (i - d * row)];
  }
  __syncthreads();
  const int qx = blockIdx.x * kTileX + threadIdx.x;
  const int qy = blockIdx.y * kTileY + threadIdx.y;
  if (qx >= qw || qy >= qh) return;
  const int plane = qh * qw;
  const int q = qy * qw + qx;
  const float rad = radius[c * plane + q];
  for (int d = 0; d < nd; ++d) {
    const float r = rad * sr[d];
    // #{b : r > bounds[b]}: the bounds ascend, so r > bounds[b] holds for
    // a prefix of them (for none when r is NaN)
    int lvl = 0;
    for (int step = 32; step > 0; step >>= 1) {
      const int i = lvl + step;
      if (i <= n_b && r > sb[i - 1]) lvl = i;
    }
    const int* e = st + d * row + lvl * 3;
    const int src = (e[0] * ph + e[1] + qy) * pw + e[2] + qx;
    for (int s = 0; s < n_src; ++s)
      out[((s * nd + d) * 16 + c) * plane + q] =
          planes[s * 16 * ph * pw + src];
  }
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

__global__ void fetch_taps_same_class_kernel(
    const float* __restrict__ planes, const int* __restrict__ lvl,
    const int* __restrict__ tab, int n_src, int nd, int taps, int n_levels,
    int qh, int qw, int ph, int pw, float* __restrict__ out) {
  const long long total = (long long)nd * taps * 16 * qh * qw;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int qx = (int)(i % qw);
  long long rem = i / qw;
  const int qy = (int)(rem % qh);
  rem /= qh;
  const int c = (int)(rem % 16);
  const int t = (int)(rem / 16);
  const int d = t / taps, k = t - d * taps;
  const int l = lvl[(((size_t)k * 16 + c) * qh + qy) * qw + qx];
  const int nt = nd * taps;
  const size_t o = (((size_t)t * 16 + c) * qh + qy) * qw + qx;
  if (l < 0 || l >= n_levels) {  // no level selected: the chain's 0
    for (int s = 0; s < n_src; ++s)
      out[(size_t)s * nt * 16 * qh * qw + o] = 0.0f;
    return;
  }
  const int* e = tab + (((size_t)d * 16 + c) * n_levels + l) * 2;
  const int y = e[0] + qy, x = e[1] + qx;
  for (int s = 0; s < n_src; ++s)
    out[(size_t)s * nt * 16 * qh * qw + o] =
        planes[(((size_t)s * 16 + c) * ph + y) * pw + x];
}

}  // namespace

// planes [n_src, 16, ph, pw]; radius [16, qh, qw]; bounds [n_levels - 1]
// ascending; radii [nd]; tab [nd, 16, n_levels, 3] = (c2, y, x); out
// [n_src, nd, 16, qh, qw]; n_levels - 1 <= 63, nd <= 64 and every size
// below 2^31 elements.
extern "C" int rtsdm_fetch_directions(const float* planes,
                                      const float* radius,
                                      const float* bounds, const float* radii,
                                      const int* tab, int n_src, int nd,
                                      int n_levels, int qh, int qw, int ph,
                                      int pw, float* out,
                                      cudaStream_t stream) {
  if (nd > 0 && qh > 0 && qw > 0 && n_src > 0) {
    const dim3 grid((qw + kTileX - 1) / kTileX, (qh + kTileY - 1) / kTileY,
                    16);
    fetch_directions_kernel<<<grid, dim3(kTileX, kTileY),
                              nd * n_levels * 3 * sizeof(int), stream>>>(
        planes, radius, bounds, radii, tab, n_src, nd, n_levels, qh, qw, ph,
        pw, out);
  }
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

// planes [n_src, 16, ph, pw]; lvl [taps, 16, qh, qw]; tab
// [nd, 16, n_levels, 2] = padded-plane (y, x); out [n_src, nd * taps, 16,
// qh, qw].
extern "C" int rtsdm_fetch_taps_same_class(const float* planes,
                                           const int* lvl, const int* tab,
                                           int n_src, int nd, int taps,
                                           int n_levels, int qh, int qw,
                                           int ph, int pw, float* out,
                                           cudaStream_t stream) {
  const long long total = (long long)nd * taps * 16 * qh * qw;
  if (total > 0)
    fetch_taps_same_class_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                                   stream>>>(planes, lvl, tab, n_src, nd,
                                             taps, n_levels, qh, qw, ph, pw,
                                             out);
  return (int)cudaGetLastError();
}
