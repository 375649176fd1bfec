// Stochastic-depth ray trace: K5 (streamed chunk lists) and K7 (resident,
// in-kernel chunk-AABB cull).
//
// K5 replaces rtsdm_tpu/ops/rt_pallas.py:_sd_stream_kernel (called by
// sd_trace_pallas_stream) in its shared-origin form, K7 replaces _sd_kernel
// (called by sd_trace_pallas, the VMEM-resident tier that the reference takes
// for scenes of up to 65,536 triangles). Both trace one ray per SD texel,
// every ray starting at the pinhole origin, against 128-triangle chunks of
// shared-origin rows; one thread owns one ray and a block owns 256 rays.
// - K5: the block is an 8x32 ray tile and walks the tile's ascending list
//   of chunks (world AABB + pinhole screen cull, built on the host), or
//   every chunk when the list overflowed.
// - K7: the block is 256 consecutive rays in row-major order. It reduces
//   the conservative AABB of its rays' valid segments (o + d*tmin,
//   o + d*tmax) in shared memory, then walks EVERY chunk in order and
//   skips those whose AABB misses the block's box: no host-built list, so a
//   small scene spares the per-frame list launches. The TPU kept all
//   triangles resident in VMEM; here each visited 13x128 chunk (6.5 KB) is
//   staged into shared memory, as in K5.
// Bounded by arithmetic: a visited chunk costs each ray 128 three-term
// dot-product triples and compares (the per-triangle rows fold the
// origin-dependent cross products in once per frame); the tail (divide,
// alpha bit, hash, insertion) runs only for face-accepted hits, which are
// rare because the ray intervals are tight. The k slots live in registers
// (K is a template parameter).
//
// Semantics follow rt_pallas.py:_shared_origin_math (:200-231) and
// _hash_tail (:37-146) exactly: the unnormalized face test first, then
// inv = 1/det; the baked 4x4 alpha bit at the barycentric cell; the 15-bit
// key from the int32 hash of (u, v) (wrapping multiplies, arithmetic >>,
// floor mod of |hb| where |INT_MIN| stays negative). Insertion modes:
// - default: the k smallest DISTINCT key15*65536 + depth16;
// - kbuffer: the k smallest distinct depth16*32768 + min(key15, 32766);
// - coverage: each slot keeps the min depth16 of the hits whose stratified
//   coverage mask (int_hash.cuh) covers it; rng = key15 / 32767, rng2 from
//   the hash remixed with depth16.
// MaxCount (max_count > 0): a hit takes part only while fewer than
// max_count face-accepted hits (before the alpha test) came before it in
// chunk order, then triangle order; the TPU's triangular MXU product for
// the ordinal is a running counter here (saturating at 2^30). Once every
// live ray of a block has counted max_count, later chunks cannot change
// its slots and the block stops (exact). Built with --fmad=false and no
// fast math so every expression rounds like the plain PyTorch versions in
// ops/rt_cuda.py.
#include <cuda_runtime.h>

#include "int_hash.cuh"

namespace {

constexpr int kBlockRays = 256;  // rays per block
constexpr int kTC = 128;         // triangles per chunk
constexpr int kRows = 13;        // nt(3) bt(3) ct(3) tp, acc-back, reject, mask
constexpr int kInvalid = 2147483647;
constexpr float kEpsDet = 1e-9f;
constexpr int kCountCap = 1 << 30;
constexpr int kMaxLut = 256;     // 2^k coverage masks for k <= 8
constexpr unsigned kGolden = 0x9E3779B1u;
constexpr int kModeKBuffer = 1;
constexpr int kModeCoverage = 2;
constexpr float kInf = __builtin_huge_valf();

// Uniform per-launch insertion parameters.
struct Tail {
  int cull_back;
  int mode;
  int max_count;  // 0: uncapped
  float ak;       // alpha * k (coverage)
  int lut_n;
};

struct Ray {
  float dx, dy, dz, tmin, tmax, za, zb;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        int n_rays, int r) {
  Ray ray;
  ray.dx = rays[0 * (size_t)n_rays + r];
  ray.dy = rays[1 * (size_t)n_rays + r];
  ray.dz = rays[2 * (size_t)n_rays + r];
  ray.tmin = rays[3 * (size_t)n_rays + r];
  ray.tmax = rays[4 * (size_t)n_rays + r];
  ray.za = rays[5 * (size_t)n_rays + r];
  ray.zb = rays[6 * (size_t)n_rays + r];
  return ray;
}

__device__ __forceinline__ int hash_uv(float u, float v) {
  int hb = __float2int_rz(u * 8388593.0f) ^
           (int)((unsigned)__float2int_rz(v * 4194301.0f) << 7);
  hb = hb ^ (hb >> 8);
  hb = (int)((unsigned)hb * kGolden);
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

// The block's shared memory: the staged chunk and the coverage tables.
template <int K>
struct Shared {
  float tri[kRows * kTC];
  int lut[kMaxLut];
  int idx[K + 2];
};

template <int K>
__device__ __forceinline__ void load_tables(Shared<K>& sh, const int* lut,
                                            const int* idx, int lut_n) {
  for (int i = threadIdx.x; i < lut_n; i += kBlockRays) sh.lut[i] = lut[i];
  if (threadIdx.x < K + 2) sh.idx[threadIdx.x] = idx[threadIdx.x];
}

// Fold one staged chunk into this thread's slots and face-accepted count.
template <int K>
__device__ __forceinline__ void visit_chunk(const Shared<K>& sh,
                                            const Ray& ray, const Tail& tail,
                                            int (&slots)[K], int& count) {
  const float* tri = sh.tri;
  for (int l = 0; l < kTC; ++l) {
    const float det = ray.dx * tri[0 * kTC + l] + ray.dy * tri[1 * kTC + l] +
                      ray.dz * tri[2 * kTC + l];
    const float pu = ray.dx * tri[3 * kTC + l] + ray.dy * tri[4 * kTC + l] +
                     ray.dz * tri[5 * kTC + l];
    const float pv = ray.dx * tri[6 * kTC + l] + ray.dy * tri[7 * kTC + l] +
                     ray.dz * tri[8 * kTC + l];
    const float tp = tri[9 * kTC + l];
    bool ok;
    float adet, spu, spv, stp;
    if (tail.cull_back) {
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
                         (spu + spv <= adet) && (stp > ray.tmin * adet) &&
                         (stp < ray.tmax * adet);
    if (!ok_face) continue;
    bool capped = false;
    if (tail.max_count > 0) {  // the cap counts hits before the alpha test
      capped = count >= tail.max_count;
      count = min(count + 1, kCountCap);
    }

    const float inv = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);
    const float u = pu * inv;
    const float v = pv * inv;
    const float th = tp * inv;
    const int cell =
        __float2int_rz(fminf(fmaxf(u * 4.0f, 0.0f), 3.0f)) +
        4 * __float2int_rz(fminf(fmaxf(v * 4.0f, 0.0f), 3.0f));
    const int amask = __float2int_rz(tri[12 * kTC + l]);
    if ((((unsigned)amask >> cell) & 1u) == 0u || capped) continue;

    const float d_norm = fminf(fmaxf(th * ray.za - ray.zb, 0.0f), 1.0f);
    const int d16 = min(max(__float2int_rz(d_norm * 65535.0f), 0), 65535);
    const int hb = hash_uv(u, v);
    const int k15 = key15_of(hb);
    if (tail.mode == kModeCoverage) {
      const float rng = (float)k15 * kInv32767;
      int h2 = (hb ^ (int)((unsigned)d16 * kGolden)) ^ (hb >> 5);
      h2 = h2 ^ (h2 >> 11);
      const float rng2 = (float)key15_of(h2) * kInv32767;
      const int mask =
          coverage_mask<K>(tail.ak, rng, rng2, sh.lut, tail.lut_n, sh.idx);
#pragma unroll
      for (int s = 0; s < K; ++s)
        if ((mask >> s) & 1) slots[s] = min(slots[s], d16);
    } else {
      const int packed = tail.mode == kModeKBuffer
                             ? d16 * 32768 + min(k15, 32766)
                             : k15 * 65536 + d16;
      insert_distinct<K>(slots, packed);
    }
  }
}

// Barrier before a chunk is staged (every thread is done with the previous
// one). Returns true when the block may stop: under a MaxCount, every live
// ray (tmax > tmin; a dead ray has no hit) has counted max_count.
__device__ __forceinline__ bool sync_and_done(const Tail& tail,
                                              const Ray& ray, int count) {
  if (tail.max_count > 0)
    return __syncthreads_and(!(ray.tmax > ray.tmin) ||
                             count >= tail.max_count) != 0;
  __syncthreads();
  return false;
}

template <int K>
__device__ __forceinline__ void stage_chunk(Shared<K>& sh,
                                            const float* __restrict__ src) {
  for (int i = threadIdx.x; i < kRows * kTC; i += kBlockRays)
    sh.tri[i] = src[i];
  __syncthreads();
}

template <int K>
__global__ void sd_trace_kernel(const float* __restrict__ tri_packed,
                                const int* __restrict__ lists,
                                const int* __restrict__ counts,
                                const float* __restrict__ rays, int n_rays,
                                int n_chunks, int list_w, Tail tail,
                                const int* __restrict__ lut,
                                const int* __restrict__ idx,
                                int* __restrict__ out) {
  __shared__ Shared<K> sh;
  load_tables<K>(sh, lut, idx, tail.lut_n);
  const int b = blockIdx.x;
  const int r = b * kBlockRays + threadIdx.x;
  const Ray ray = load_ray(rays, n_rays, r);

  int slots[K];
#pragma unroll
  for (int s = 0; s < K; ++s) slots[s] = kInvalid;
  int count = 0;

  const int raw = counts[b];
  const bool full = raw > list_w;
  const int cnt = full ? n_chunks : raw;
  for (int j = 0; j < cnt; ++j) {
    const int ci = full ? j : lists[(size_t)b * list_w + j];
    if (sync_and_done(tail, ray, count)) break;
    stage_chunk<K>(sh, tri_packed + (size_t)ci * kRows * kTC);
    visit_chunk<K>(sh, ray, tail, slots, count);
  }
#pragma unroll
  for (int s = 0; s < K; ++s) out[(size_t)r * K + s] = slots[s];
}

// min / max over the block of per-thread values (all threads take part).
__device__ __forceinline__ float block_min(float v, float* scratch) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // scratch is free again
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  v = scratch[0];
  for (int w = 1; w < kBlockRays / 32; ++w) v = fminf(v, scratch[w]);
  return v;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  return -block_min(-v, scratch);
}

template <int K>
__global__ void sd_trace_resident_kernel(const float* __restrict__ tri_packed,
                                         const float* __restrict__ aabb,
                                         const float* __restrict__ origin,
                                         const float* __restrict__ rays,
                                         int n_rays, int n_chunks, Tail tail,
                                         const int* __restrict__ lut,
                                         const int* __restrict__ idx,
                                         int* __restrict__ out) {
  __shared__ Shared<K> sh;
  __shared__ float scratch[kBlockRays / 32];
  load_tables<K>(sh, lut, idx, tail.lut_n);
  const int r = blockIdx.x * kBlockRays + threadIdx.x;
  const Ray ray = load_ray(rays, n_rays, r);

  // the conservative AABB of the block's valid segments (rt_pallas.py:
  // 317-332): rays with tmax <= tmin, padding included, add nothing
  const bool valid = ray.tmax > ray.tmin;
  const float d[3] = {ray.dx, ray.dy, ray.dz};
  float lo[3], hi[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float o = origin[c];
    const float a = o + d[c] * ray.tmin;
    const float e = o + d[c] * ray.tmax;
    lo[c] = block_min(valid ? fminf(a, e) : kInf, scratch);
    hi[c] = block_max(valid ? fmaxf(a, e) : -kInf, scratch);
  }

  int slots[K];
#pragma unroll
  for (int s = 0; s < K; ++s) slots[s] = kInvalid;
  int count = 0;

  for (int ci = 0; ci < n_chunks; ++ci) {
    // chunk AABB [6, n_chunks] (rows 0-2 min, 3-5 max) against the block's
    // box: the same value for every thread, so the block skips together
    const bool overlap =
        (aabb[0 * (size_t)n_chunks + ci] <= hi[0]) &&
        (aabb[3 * (size_t)n_chunks + ci] >= lo[0]) &&
        (aabb[1 * (size_t)n_chunks + ci] <= hi[1]) &&
        (aabb[4 * (size_t)n_chunks + ci] >= lo[1]) &&
        (aabb[2 * (size_t)n_chunks + ci] <= hi[2]) &&
        (aabb[5 * (size_t)n_chunks + ci] >= lo[2]);
    if (!overlap) continue;
    if (sync_and_done(tail, ray, count)) break;
    stage_chunk<K>(sh, tri_packed + (size_t)ci * kRows * kTC);
    visit_chunk<K>(sh, ray, tail, slots, count);
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

Tail make_tail(int cull_back, int mode, int max_count, float ak,
               int lut_n) {
  Tail tail;
  tail.cull_back = cull_back;
  tail.mode = mode;
  tail.max_count = max_count;
  tail.ak = ak;
  tail.lut_n = lut_n;
  return tail;
}

bool valid_args(int k, int mode, int lut_n) {
  return k >= 1 && k <= 8 && mode >= 0 && mode <= kModeCoverage &&
         lut_n >= 0 && lut_n <= kMaxLut;
}

}  // namespace

// K5. rays: [7, nb*256] float (dx, dy, dz, tmin, tmax, za, zb) in 8x32-tile
// order; lists [nb, list_w], counts [nb]; mode 0 default, 1 kbuffer, 2
// coverage; ak = alpha * k; lut [lut_n] and idx [k + 2]:
// stratified_coverage_tables(k); out: [nb*256, k].
extern "C" int rtsdm_sd_trace(const float* tri_packed, const int* lists,
                              const int* counts, const float* rays, int nb,
                              int n_chunks, int list_w, int k, int cull_back,
                              int mode, int max_count, float ak,
                              const int* lut, int lut_n, const int* idx,
                              int* out, cudaStream_t stream) {
  if (!valid_args(k, mode, lut_n)) return (int)cudaErrorInvalidValue;
  const Tail tail = make_tail(cull_back, mode, max_count, ak, lut_n);
  if (nb > 0) {
    switch (k) {
#define RTSDM_TRACE_CASE(KK)                                               \
  case KK:                                                                 \
    sd_trace_kernel<KK><<<nb, kBlockRays, 0, stream>>>(                    \
        tri_packed, lists, counts, rays, nb * kBlockRays, n_chunks, list_w, \
        tail, lut, idx, out);                                              \
    break;
      RTSDM_TRACE_CASE(1)
      RTSDM_TRACE_CASE(2)
      RTSDM_TRACE_CASE(3)
      RTSDM_TRACE_CASE(4)
      RTSDM_TRACE_CASE(5)
      RTSDM_TRACE_CASE(6)
      RTSDM_TRACE_CASE(7)
      RTSDM_TRACE_CASE(8)
#undef RTSDM_TRACE_CASE
    }
  }
  return (int)cudaGetLastError();
}

// K7. rays as K5's but in row-major order; aabb: [6, n_chunks] chunk AABBs;
// origin: [3], the rays' shared origin.
extern "C" int rtsdm_sd_trace_resident(const float* tri_packed,
                                       const float* aabb, const float* origin,
                                       const float* rays, int nb,
                                       int n_chunks, int k, int cull_back,
                                       int mode, int max_count, float ak,
                                       const int* lut, int lut_n,
                                       const int* idx, int* out,
                                       cudaStream_t stream) {
  if (!valid_args(k, mode, lut_n)) return (int)cudaErrorInvalidValue;
  const Tail tail = make_tail(cull_back, mode, max_count, ak, lut_n);
  if (nb > 0) {
    switch (k) {
#define RTSDM_RESIDENT_CASE(KK)                                            \
  case KK:                                                                 \
    sd_trace_resident_kernel<KK><<<nb, kBlockRays, 0, stream>>>(           \
        tri_packed, aabb, origin, rays, nb * kBlockRays, n_chunks, tail,   \
        lut, idx, out);                                                    \
    break;
      RTSDM_RESIDENT_CASE(1)
      RTSDM_RESIDENT_CASE(2)
      RTSDM_RESIDENT_CASE(3)
      RTSDM_RESIDENT_CASE(4)
      RTSDM_RESIDENT_CASE(5)
      RTSDM_RESIDENT_CASE(6)
      RTSDM_RESIDENT_CASE(7)
      RTSDM_RESIDENT_CASE(8)
#undef RTSDM_RESIDENT_CASE
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
