// Shadow-ray any-hit (K8).
//
// Replaces rtsdm_tpu/ops/rt_pallas.py:any_hit_pallas, which runs the
// streaming SD kernel (_sd_stream_kernel, :482) with classic=True,
// num_samples=1, cull_back=False and early_exit=True. Every ray has its own
// origin (a shaded surface point), so the per-triangle shared-origin rows
// of the SD trace do not apply: each chunk holds raw v0/e1/e2 rows and the
// Moller-Trumbore cross products are formed per ray-triangle pair.
//
// One block owns one 8x32 ray tile (one thread per ray) and walks the
// tile's list of 128-triangle chunks, ordered near to far along the mean
// ray direction; each 12x128 chunk is staged in shared memory. A thread
// whose ray has hit stops testing, and the block stops walking as soon as
// every live ray of the tile has hit (__syncthreads_or); dead rays
// (tmax <= tmin, e.g. tmax = -1 for background or light-backfacing pixels)
// count as done from the start. The result is an OR, so the order of the
// walk cannot change it. Bounded by arithmetic: ~47 flops per ray-triangle
// pair tested. Each thread writes how many pairs its ray tested (up to and
// including the one that hit), which is the work this run's data needed;
// the chunks a tile walked are the most of its rays' pairs over 128,
// rounded up.
//
// Per-pair math follows rt_pallas.py:_classic_origin_math (:238-295) with
// k = 1, no culling and back faces accepted (any_hit_pallas sets the
// accept-back flag for every triangle): unnormalized spu, spv, stp against
// adet; stp in (tmin adet, tmax adet); the reject flag; then the baked 4x4
// alpha bit at the cell of u = pu inv, v = pv inv. A hit is any accepted
// pair (the 1-slot reservoir holds a value below INVALID). Built with
// --fmad=false and no fast math, so every expression rounds like the plain
// PyTorch version in ops/rt_cuda.py.
#include <cuda_runtime.h>

namespace {

constexpr int kTileRays = 256;  // 8x32 ray tile
constexpr int kTC = 128;        // triangles per chunk
constexpr int kRows = 12;       // v0(3) e1(3) e2(3), acc-back, reject, mask
constexpr float kEpsDet = 1e-9f;

__global__ void any_hit_kernel(const float* __restrict__ tri_packed,
                               const int* __restrict__ lists,
                               const int* __restrict__ counts,
                               const float* __restrict__ rays, int n_rays,
                               int n_chunks, int list_w,
                               unsigned char* __restrict__ hit_out,
                               int* __restrict__ pairs_out) {
  __shared__ float tri[kRows * kTC];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int r = b * kTileRays + t;
  const float ox = rays[0 * (size_t)n_rays + r];
  const float oy = rays[1 * (size_t)n_rays + r];
  const float oz = rays[2 * (size_t)n_rays + r];
  const float dx = rays[3 * (size_t)n_rays + r];
  const float dy = rays[4 * (size_t)n_rays + r];
  const float dz = rays[5 * (size_t)n_rays + r];
  const float tmin = rays[6 * (size_t)n_rays + r];
  const float tmax = rays[7 * (size_t)n_rays + r];

  bool hit = false;
  int pairs = 0;
  const bool live = tmax > tmin;
  const int raw = counts[b];
  const bool full = raw > list_w;
  const int cnt = full ? n_chunks : raw;
  for (int j = 0; j < cnt; ++j) {
    // stop once every live ray of the tile has hit; the barrier also
    // keeps the previous chunk staged until every thread is done with it
    if (!__syncthreads_or(live && !hit)) break;
    const int ci = full ? j : lists[(size_t)b * list_w + j];
    const float* src = tri_packed + (size_t)ci * kRows * kTC;
    for (int i = t; i < kRows * kTC; i += kTileRays) tri[i] = src[i];
    __syncthreads();
    if (hit || !live) continue;

    int l = 0;
    for (; l < kTC; ++l) {
      const float e1x = tri[3 * kTC + l], e1y = tri[4 * kTC + l],
                  e1z = tri[5 * kTC + l];
      const float e2x = tri[6 * kTC + l], e2y = tri[7 * kTC + l],
                  e2z = tri[8 * kTC + l];
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const float tvx = ox - tri[0 * kTC + l];
      const float tvy = oy - tri[1 * kTC + l];
      const float tvz = oz - tri[2 * kTC + l];
      const float pu = tvx * px + tvy * py + tvz * pz;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      const float pv = dx * qx + dy * qy + dz * qz;
      const float tp = e2x * qx + e2y * qy + e2z * qz;
      bool ok = (fabsf(det) > kEpsDet) &&
                ((det > 0.0f) || (tri[9 * kTC + l] > 0.0f));
      const float s = det >= 0.0f ? 1.0f : -1.0f;
      const float adet = det * s, spu = pu * s, spv = pv * s, stp = tp * s;
      ok = ok && (tri[10 * kTC + l] == 0.0f);
      const bool ok_face = ok && (spu >= 0.0f) && (spv >= 0.0f) &&
                           (spu + spv <= adet) && (stp > tmin * adet) &&
                           (stp < tmax * adet);
      if (!ok_face) continue;
      const float inv = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);
      const float u = pu * inv;
      const float v = pv * inv;
      const int cell =
          __float2int_rz(fminf(fmaxf(u * 4.0f, 0.0f), 3.0f)) +
          4 * __float2int_rz(fminf(fmaxf(v * 4.0f, 0.0f), 3.0f));
      const int amask = __float2int_rz(tri[11 * kTC + l]);
      if ((((unsigned)amask >> cell) & 1u) != 0u) {
        hit = true;
        break;
      }
    }
    pairs += hit ? l + 1 : kTC;
  }
  hit_out[r] = hit ? 1 : 0;
  pairs_out[r] = pairs;
}

}  // namespace

// rays: [8, nb*256] float (ox, oy, oz, dx, dy, dz, tmin, tmax);
// hit: [nb*256] uint8; pairs: [nb*256] int (ray-triangle pairs each ray
// tested).
extern "C" int rtsdm_any_hit(const float* tri_packed, const int* lists,
                             const int* counts, const float* rays, int nb,
                             int n_chunks, int list_w, unsigned char* hit,
                             int* pairs, cudaStream_t stream) {
  if (nb > 0)
    any_hit_kernel<<<nb, kTileRays, 0, stream>>>(
        tri_packed, lists, counts, rays, nb * kTileRays, n_chunks, list_w,
        hit, pairs);
  return (int)cudaGetLastError();
}
