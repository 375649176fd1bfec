// Level-select shifted fetches of SVAO's deinterleaved planes (K3, K4, K6,
// K11).
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
// K4 replaces fetch_pallas.py:_fetch_sd_kernel (driver fetch_sd_packed,
// whose 16-bit pack, fetch_pallas.py:448-453, it does too): the same level
// selection over the SD map [sd_h, sd_w, k] (divisor 4: the SD texel of a
// class-c pixel plus offset is a stride-1 shift), reading the texel
// (y0 + qy, x0 + qx) with the clamped global origin (y0, x0) of the table
// and packing its k depths as the plain version's pack_sd16 does: each
// 16-bit field is rint(depth * 65535) (round half to even) clamped to
// [0, 65535], layer 2j in bits 0-15 and layer 2j+1 in bits 16-31 of plane
// j, the high half of the last plane 0 when k is odd. Bounded by memory
// (the packed output is nearly all its bytes), so K4 has K3's form: a
// block is a 32x8 tile of one class's quarter texels, the class's table
// slice, the level bounds and radii sit in shared memory, a thread reads
// its radius once and serves all nd directions and all packed planes,
// finding each level by the binary search, and all index arithmetic is
// 32-bit (the wrapper checks the sizes fit). At k = 4 a texel's depths are
// one float4 read.
//
// K6 replaces fetch_pallas.py:fetch_taps_same_class (the HBAO ring, driven
// from rtsdm_tpu/passes/hbao.py): tap t = d * taps + k of direction d and
// step k reads, for class c and quarter texel q, the class's OWN padded
// plane (no cross-class remap: HBAO samples within one deinterleave slice)
// at the static offset tab[d, c, lvl[k, c, q]], a level given per step.
// The TPU's select chain over every level, its per-tile halo DMA and its
// dedup of equal consecutive offsets were workarounds for the missing
// gather; here it is a gather. Bounded by memory: the nd * taps * n_src
// outputs a texel writes are nearly all of its bytes (the planes, a few
// MB, stay in L2), so K6 has K3's form: a block is a 32x8 tile of one
// class's quarter texels (x fastest, every write of a warp one 128-byte
// line), the class's table slice tab[:, c] sits in shared memory, a thread
// reads each of its taps levels once and serves all nd directions and all
// n_src sets from it, and all index arithmetic is 32-bit (the wrapper
// checks the sizes fit).
//
// K11, phase 2's SD fetch at stochMapDivisor 1 and 2 (wrapper
// fetch_sd_strided), replaces no TPU kernel: the JAX package fetches the SD
// map there with XLA code (rtsdm_tpu/ops/ao_shift.py:fetch_sd_direction, a
// strided slice and a select per class and level). For one ring direction
// d it selects the level as K4 does and reads the k depths of SD texel
// (y0 + s qy, x0 + s qx), s = 4 / divisor, with the clamped origin (y0, x0)
// of the table, into a float [16, k, qh, qw] output (no pack: phase 2 reads
// the depths as they are). Bounded by memory: each value is read and
// written once, so K11 has K4's form (a block is a 32x8 tile of one class's
// quarter texels, the class's table slice and the level bounds in shared
// memory, 32-bit indices, a float4 read a texel at k = 4), one direction a
// launch so that only one direction's output is alive. The class is the
// fastest block index: at stride 4 a warp reads every fourth texel, and the
// tiles of the other classes, which read the texels between, then run at
// the same time and find them in L2.
//
// The level is computed exactly as rtsdm_tpu/ops/ao.py:shift_level_index:
// a float32 product compared with float32 bounds (the float64 geometric
// midpoints rounded to float32). Built with --fmad=false.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTileX = 32, kTileY = 8;   // K3's block: a tile of texels
constexpr int kMaxBounds = 63;           // rtsdm_tpu_torch/ops/fetch_cuda.py
constexpr int kMaxDirs = 64;

// #{b : r > bounds[b]} of n_b <= 63 ascending bounds: r > bounds[b] holds
// for a prefix of them (for none when r is NaN)
__device__ __forceinline__ int level_of(float r, const float* sb, int n_b) {
  int lvl = 0;
  for (int step = 32; step > 0; step >>= 1) {
    const int i = lvl + step;
    if (i <= n_b && r > sb[i - 1]) lvl = i;
  }
  return lvl;
}

// pack_sd16's 16-bit field of a depth. A NaN depth packs as 0 (fmaxf
// returns the number); the SD map holds none, as K5 and K7 store decoded
// 16-bit depths.
__device__ __forceinline__ unsigned sd16(float v) {
  return (unsigned)fminf(fmaxf(rintf(v * 65535.0f), 0.0f), 65535.0f);
}

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
    const int* e = st + d * row + level_of(rad * sr[d], sb, n_b) * 3;
    const int src = (e[0] * ph + e[1] + qy) * pw + e[2] + qx;
    for (int s = 0; s < n_src; ++s)
      out[((s * nd + d) * 16 + c) * plane + q] =
          planes[s * 16 * ph * pw + src];
  }
}

// K = 4: a texel's four depths are one float4 read (the wrapper's map is
// 16-byte aligned); K = 0: k at run time, a short loop
template <int K>
__global__ void __launch_bounds__(kTileX * kTileY)
    fetch_sd_packed_kernel(const float* __restrict__ sd,
                           const float* __restrict__ radius,
                           const float* __restrict__ bounds,
                           const float* __restrict__ radii,
                           const int* __restrict__ tab, int k, int nd,
                           int n_levels, int qh, int qw, int sd_w,
                           int* __restrict__ out) {
  __shared__ float sb[kMaxBounds];
  __shared__ float sr[kMaxDirs];
  extern __shared__ int st[];  // tab[:, :, c] as [nd, n_levels, 2]
  const int c = blockIdx.z;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int n_b = n_levels - 1;
  for (int i = tid; i < n_b; i += kTileX * kTileY) sb[i] = bounds[i];
  for (int i = tid; i < nd; i += kTileX * kTileY) sr[i] = radii[i];
  for (int i = tid; i < nd * n_levels * 2; i += kTileX * kTileY)
    st[i] = tab[((i >> 1) * 16 + c) * 2 + (i & 1)];
  __syncthreads();
  const int qx = blockIdx.x * kTileX + threadIdx.x;
  const int qy = blockIdx.y * kTileY + threadIdx.y;
  if (qx >= qw || qy >= qh) return;
  if (K != 0) k = K;
  const int kp = (k + 1) / 2;
  const int plane = qh * qw;
  const int q = qy * qw + qx;
  const float rad = radius[c * plane + q];
  // unrolled, a thread's reads of several directions are in flight at once
  // (0.0656 against 0.0764 ms on the device at the SVAO path's call, H100
  // 80GB HBM3 at 700 W)
#pragma unroll 8
  for (int d = 0; d < nd; ++d) {
    const int* e = st + (d * n_levels + level_of(rad * sr[d], sb, n_b)) * 2;
    const int texel = (e[0] + qy) * sd_w + e[1] + qx;
    int* o = out + (d * 16 + c) * kp * plane + q;
    if (K == 4) {
      const float4 v = reinterpret_cast<const float4*>(sd)[texel];
      o[0] = (int)(sd16(v.x) | (sd16(v.y) << 16));
      o[plane] = (int)(sd16(v.z) | (sd16(v.w) << 16));
    } else {
      const float* s = sd + texel * k;
      for (int j = 0; j < kp; ++j) {
        const unsigned hi = 2 * j + 1 < k ? sd16(s[2 * j + 1]) : 0u;
        o[j * plane] = (int)(sd16(s[2 * j]) | (hi << 16));
      }
    }
  }
}

// K = 4: a texel's four depths are one float4 read; K = 0: k at run time
template <int K>
__global__ void __launch_bounds__(kTileX * kTileY)
    fetch_sd_strided_kernel(const float* __restrict__ sd,
                            const float* __restrict__ radius,
                            const float* __restrict__ bounds,
                            const float* __restrict__ radii,
                            const int* __restrict__ tab, int d, int k,
                            int n_levels, int qh, int qw, int sd_w,
                            int stride, float* __restrict__ out) {
  __shared__ float sb[kMaxBounds];
  __shared__ int st[2 * (kMaxBounds + 1)];  // tab[d, :, c] as [n_levels, 2]
  const int c = blockIdx.x;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int n_b = n_levels - 1;
  for (int i = tid; i < n_b; i += kTileX * kTileY) sb[i] = bounds[i];
  for (int i = tid; i < n_levels * 2; i += kTileX * kTileY)
    st[i] = tab[((d * n_levels + (i >> 1)) * 16 + c) * 2 + (i & 1)];
  __syncthreads();
  const int qx = blockIdx.y * kTileX + threadIdx.x;
  const int qy = blockIdx.z * kTileY + threadIdx.y;
  if (qx >= qw || qy >= qh) return;
  if (K != 0) k = K;
  const int plane = qh * qw;
  const int q = qy * qw + qx;
  const int* e = st + level_of(radius[c * plane + q] * radii[d], sb, n_b) * 2;
  const int texel = (e[0] + qy * stride) * sd_w + e[1] + qx * stride;
  float* o = out + c * k * plane + q;
  if (K == 4) {
    const float4 v = reinterpret_cast<const float4*>(sd)[texel];
    o[0] = v.x;
    o[plane] = v.y;
    o[2 * plane] = v.z;
    o[3 * plane] = v.w;
  } else {
    for (int j = 0; j < k; ++j) o[j * plane] = sd[texel * k + j];
  }
}

__global__ void __launch_bounds__(kTileX * kTileY)
    fetch_taps_same_class_kernel(const float* __restrict__ planes,
                                 const int* __restrict__ lvl,
                                 const int* __restrict__ tab, int n_src,
                                 int nd, int taps, int n_levels, int qh,
                                 int qw, int ph, int pw,
                                 float* __restrict__ out) {
  extern __shared__ int st[];  // tab[:, c] as [nd, n_levels, 2]
  const int c = blockIdx.z;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const int row = n_levels * 2;
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
  const int out_set = nd * taps * 16 * plane;  // one set's outputs
  const int src_set = 16 * ph * pw;            // one set's planes
  const float* own = planes + (c * ph + qy) * pw + qx;  // set 0, class c
  for (int k = 0; k < taps; ++k) {
    const int l = lvl[(k * 16 + c) * plane + q];
    const bool ok = l >= 0 && l < n_levels;  // else the chain's 0
#pragma unroll 4
    for (int d = 0; d < nd; ++d) {
      const int* e = st + d * row + (ok ? l : 0) * 2;
      const int src = e[0] * pw + e[1];
      const int o = ((d * taps + k) * 16 + c) * plane + q;
      for (int s = 0; s < n_src; ++s)
        out[s * out_set + o] = ok ? own[s * src_set + src] : 0.0f;
    }
  }
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

// sd [sd_h, sd_w, k] float32; radius [16, qh, qw]; bounds [n_levels - 1]
// ascending; radii [nd]; tab [nd, n_levels, 16, 2] = (y0, x0); out
// [nd, 16, ceil(k/2), qh, qw]; n_levels - 1 <= 63, nd <= 64, every size
// below 2^31 elements and tab[:, :, c] (nd * n_levels * 2 ints) within
// 48 KB.
extern "C" int rtsdm_fetch_sd_packed(const float* sd, const float* radius,
                                     const float* bounds, const float* radii,
                                     const int* tab, int k, int nd,
                                     int n_levels, int qh, int qw, int sd_w,
                                     int* out, cudaStream_t stream) {
  if (nd > 0 && qh > 0 && qw > 0 && k > 0) {
    const dim3 grid((qw + kTileX - 1) / kTileX, (qh + kTileY - 1) / kTileY,
                    16);
    const size_t smem = nd * n_levels * 2 * sizeof(int);
    if (k == 4 && (reinterpret_cast<uintptr_t>(sd) & 15) == 0)
      fetch_sd_packed_kernel<4><<<grid, dim3(kTileX, kTileY), smem,
                                  stream>>>(sd, radius, bounds, radii, tab,
                                            k, nd, n_levels, qh, qw, sd_w,
                                            out);
    else
      fetch_sd_packed_kernel<0><<<grid, dim3(kTileX, kTileY), smem,
                                  stream>>>(sd, radius, bounds, radii, tab,
                                            k, nd, n_levels, qh, qw, sd_w,
                                            out);
  }
  return (int)cudaGetLastError();
}

// sd [sd_h, sd_w, k] float32; radius [16, qh, qw]; bounds [n_levels - 1]
// ascending; radii [nd]; tab [nd, n_levels, 16, 2] = (y0, x0); d the
// direction; out [16, k, qh, qw]; n_levels - 1 <= 63, every size below
// 2^31 elements and every texel read inside the map (the table's clamp).
extern "C" int rtsdm_fetch_sd_strided(const float* sd, const float* radius,
                                      const float* bounds, const float* radii,
                                      const int* tab, int d, int k,
                                      int n_levels, int qh, int qw, int sd_w,
                                      int stride, float* out,
                                      cudaStream_t stream) {
  if (qh > 0 && qw > 0 && k > 0) {
    const dim3 grid(16, (qw + kTileX - 1) / kTileX,
                    (qh + kTileY - 1) / kTileY);
    if (k == 4 && (reinterpret_cast<uintptr_t>(sd) & 15) == 0)
      fetch_sd_strided_kernel<4><<<grid, dim3(kTileX, kTileY), 0, stream>>>(
          sd, radius, bounds, radii, tab, d, k, n_levels, qh, qw, sd_w,
          stride, out);
    else
      fetch_sd_strided_kernel<0><<<grid, dim3(kTileX, kTileY), 0, stream>>>(
          sd, radius, bounds, radii, tab, d, k, n_levels, qh, qw, sd_w,
          stride, out);
  }
  return (int)cudaGetLastError();
}

// planes [n_src, 16, ph, pw]; lvl [taps, 16, qh, qw]; tab
// [nd, 16, n_levels, 2] = padded-plane (y, x); out [n_src, nd * taps, 16,
// qh, qw]; every size below 2^31 elements and tab[:, c] (nd * n_levels * 2
// ints) within 48 KB.
extern "C" int rtsdm_fetch_taps_same_class(const float* planes,
                                           const int* lvl, const int* tab,
                                           int n_src, int nd, int taps,
                                           int n_levels, int qh, int qw,
                                           int ph, int pw, float* out,
                                           cudaStream_t stream) {
  if (nd > 0 && taps > 0 && qh > 0 && qw > 0 && n_src > 0) {
    const dim3 grid((qw + kTileX - 1) / kTileX, (qh + kTileY - 1) / kTileY,
                    16);
    fetch_taps_same_class_kernel<<<grid, dim3(kTileX, kTileY),
                                   nd * n_levels * 2 * sizeof(int),
                                   stream>>>(planes, lvl, tab, n_src, nd,
                                             taps, n_levels, qh, qw, ph, pw,
                                             out);
  }
  return (int)cudaGetLastError();
}
