// Stochastic-depth ray trace (K5).
//
// Replaces rtsdm_tpu/ops/rt_pallas.py:_sd_stream_kernel (driver
// sd_trace_pallas_stream) in its shared-origin, reservoir form: one ray per
// SD texel, every ray starting at the pinhole origin. Each block owns one
// 8x32 ray tile (one thread per ray) and walks the tile's ascending list of
// 128-triangle chunks, staging each 13x128 chunk of shared-origin rows in
// shared memory. Bounded by arithmetic: a visited chunk costs each ray 128
// three-term dot-product triples and compares (the per-triangle rows fold
// the origin-dependent cross products in once per frame); the tail (divide,
// alpha bit, hash, insertion) runs only for face-accepted hits, which are
// rare because the ray intervals are tight. The chunk lists (world AABB +
// pinhole screen cull, built on the host) keep the visits few, and the
// k-slot reservoir lives in registers (K is a template parameter).
//
// Semantics follow rt_pallas.py:_shared_origin_math (:200-231) and
// _hash_tail (:73-133) exactly: the unnormalized face test first, then
// inv = 1/det; the baked 4x4 alpha bit at the barycentric cell; the 15-bit
// key from the int32 hash of (u, v) (wrapping multiplies, arithmetic >>,
// floor mod of |hb| where |INT_MIN| stays negative); the reservoir keeps the
// k smallest DISTINCT packed values (key15*65536 + depth16 by default,
// depth16*32768 + min(key15, 32766) for the k-buffer). Built with
// --fmad=false and no fast math so every expression rounds like the plain
// PyTorch version in ops/rt_cuda.py.
#include <cuda_runtime.h>

namespace {

constexpr int kTileRays = 256;   // 8x32 ray tile
constexpr int kTC = 128;         // triangles per chunk
constexpr int kRows = 13;        // nt(3) bt(3) ct(3) tp, acc-back, reject, mask
constexpr int kInvalid = 2147483647;
constexpr float kEpsDet = 1e-9f;

__device__ __forceinline__ int key15_of(int hb) {
  const int a = hb < 0 ? (int)(0u - (unsigned)hb) : hb;  // |INT_MIN| wraps
  const int r = a % 32767;
  return r < 0 ? r + 32767 : r;  // floor mod, as jnp's % on int32
}

__device__ __forceinline__ int hash_uv(float u, float v) {
  int hb = __float2int_rz(u * 8388593.0f) ^
           (int)((unsigned)__float2int_rz(v * 4194301.0f) << 7);
  hb = hb ^ (hb >> 8);
  hb = (int)((unsigned)hb * 0x9E3779B1u);
  return hb ^ (hb >> 13);
}

template <int K>
__device__ __forceinline__ void insert_distinct(int (&slots)[K], int v) {
#pragma unroll
  for (int s = 0; s < K; ++s)
    if (slots[s] == v) return;
#pragma unroll
  for (int s = 0; s < K; ++s) {  // sorted trickle: slots stay ascending
    const int lo = min(slots[s], v);
    v = max(slots[s], v);
    slots[s] = lo;
  }
}

template <int K>
__global__ void sd_trace_kernel(const float* __restrict__ tri_packed,
                                const int* __restrict__ lists,
                                const int* __restrict__ counts,
                                const float* __restrict__ rays, int n_rays,
                                int n_chunks, int list_w, int cull_back,
                                int kbuffer, int* __restrict__ out) {
  __shared__ float tri[kRows * kTC];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int r = b * kTileRays + t;
  const float dx = rays[0 * (size_t)n_rays + r];
  const float dy = rays[1 * (size_t)n_rays + r];
  const float dz = rays[2 * (size_t)n_rays + r];
  const float tmin = rays[3 * (size_t)n_rays + r];
  const float tmax = rays[4 * (size_t)n_rays + r];
  const float za = rays[5 * (size_t)n_rays + r];
  const float zb = rays[6 * (size_t)n_rays + r];

  int slots[K];
#pragma unroll
  for (int s = 0; s < K; ++s) slots[s] = kInvalid;

  const int raw = counts[b];
  const bool full = raw > list_w;
  const int cnt = full ? n_chunks : raw;
  for (int j = 0; j < cnt; ++j) {
    const int ci = full ? j : lists[(size_t)b * list_w + j];
    const float* src = tri_packed + (size_t)ci * kRows * kTC;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = t; i < kRows * kTC; i += kTileRays) tri[i] = src[i];
    __syncthreads();

    for (int l = 0; l < kTC; ++l) {
      const float det = dx * tri[0 * kTC + l] + dy * tri[1 * kTC + l] +
                        dz * tri[2 * kTC + l];
      const float pu = dx * tri[3 * kTC + l] + dy * tri[4 * kTC + l] +
                       dz * tri[5 * kTC + l];
      const float pv = dx * tri[6 * kTC + l] + dy * tri[7 * kTC + l] +
                       dz * tri[8 * kTC + l];
      const float tp = tri[9 * kTC + l];
      bool ok;
      float adet, spu, spv, stp;
      if (cull_back) {
        ok = det > kEpsDet;
        adet = det;
        spu = pu;
        spv = pv;
        stp = tp;
      } else {
        ok = (fabsf(det) > kEpsDet) &&
             ((det > 0.0f) || (tri[10 * kTC + l] > 0.0f));
        const float s = det >= 0.0f ? 1.0f : -1.0f;
        adet = det * s;
        spu = pu * s;
        spv = pv * s;
        stp = tp * s;
      }
      ok = ok && (tri[11 * kTC + l] == 0.0f);
      const bool ok_face = ok && (spu >= 0.0f) && (spv >= 0.0f) &&
                           (spu + spv <= adet) && (stp > tmin * adet) &&
                           (stp < tmax * adet);
      if (!ok_face) continue;

      const float inv = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);
      const float u = pu * inv;
      const float v = pv * inv;
      const float th = tp * inv;
      const int cell =
          __float2int_rz(fminf(fmaxf(u * 4.0f, 0.0f), 3.0f)) +
          4 * __float2int_rz(fminf(fmaxf(v * 4.0f, 0.0f), 3.0f));
      const int amask = __float2int_rz(tri[12 * kTC + l]);
      if ((((unsigned)amask >> cell) & 1u) == 0u) continue;

      const float d_norm = fminf(fmaxf(th * za - zb, 0.0f), 1.0f);
      const int d16 = min(max(__float2int_rz(d_norm * 65535.0f), 0), 65535);
      const int k15 = key15_of(hash_uv(u, v));
      const int packed =
          kbuffer ? d16 * 32768 + min(k15, 32766) : k15 * 65536 + d16;
      insert_distinct<K>(slots, packed);
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) out[(size_t)r * K + s] = slots[s];
}

__global__ void sd_keys_kernel(const float* __restrict__ u,
                               const float* __restrict__ v,
                               const int* __restrict__ hb, int n,
                               int* __restrict__ key_uv,
                               int* __restrict__ key_hb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  key_uv[i] = key15_of(hash_uv(u[i], v[i]));
  key_hb[i] = key15_of(hb[i]);
}

template <int K>
void launch_trace(const float* tri_packed, const int* lists,
                  const int* counts, const float* rays, int nb,
                  int n_chunks, int list_w, int cull_back, int kbuffer,
                  int* out, cudaStream_t stream) {
  sd_trace_kernel<K><<<nb, kTileRays, 0, stream>>>(
      tri_packed, lists, counts, rays, nb * kTileRays, n_chunks, list_w,
      cull_back, kbuffer, out);
}

}  // namespace

// rays: [7, nb*256] float (dx, dy, dz, tmin, tmax, za, zb); out: [nb*256, k].
extern "C" int rtsdm_sd_trace(const float* tri_packed, const int* lists,
                              const int* counts, const float* rays, int nb,
                              int n_chunks, int list_w, int k, int cull_back,
                              int kbuffer, int* out, cudaStream_t stream) {
  if (nb > 0) {
    switch (k) {
      case 1: launch_trace<1>(tri_packed, lists, counts, rays, nb, n_chunks,
                              list_w, cull_back, kbuffer, out, stream); break;
      case 2: launch_trace<2>(tri_packed, lists, counts, rays, nb, n_chunks,
                              list_w, cull_back, kbuffer, out, stream); break;
      case 3: launch_trace<3>(tri_packed, lists, counts, rays, nb, n_chunks,
                              list_w, cull_back, kbuffer, out, stream); break;
      case 4: launch_trace<4>(tri_packed, lists, counts, rays, nb, n_chunks,
                              list_w, cull_back, kbuffer, out, stream); break;
      case 5: launch_trace<5>(tri_packed, lists, counts, rays, nb, n_chunks,
                              list_w, cull_back, kbuffer, out, stream); break;
      case 6: launch_trace<6>(tri_packed, lists, counts, rays, nb, n_chunks,
                              list_w, cull_back, kbuffer, out, stream); break;
      case 7: launch_trace<7>(tri_packed, lists, counts, rays, nb, n_chunks,
                              list_w, cull_back, kbuffer, out, stream); break;
      case 8: launch_trace<8>(tri_packed, lists, counts, rays, nb, n_chunks,
                              list_w, cull_back, kbuffer, out, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// The reservoir key of (u, v) and of a raw hash value, computed by the same
// device functions the trace uses — lets a test drive the INT_MIN case,
// which no geometry can be steered into.
extern "C" int rtsdm_sd_keys(const float* u, const float* v, const int* hb,
                             int n, int* key_uv, int* key_hb,
                             cudaStream_t stream) {
  if (n > 0)
    sd_keys_kernel<<<(n + 255) / 256, 256, 0, stream>>>(u, v, hb, n, key_uv,
                                                        key_hb);
  return (int)cudaGetLastError();
}
