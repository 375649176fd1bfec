// Stochastic-depth ray trace: K5 (streamed tier) and K7 (resident tier), one
// kernel body.
//
// K5 replaces rtsdm_tpu/ops/rt_pallas.py:_sd_stream_kernel (called by
// sd_trace_pallas_stream, which also builds the tiles' chunk lists,
// build_chunk_lists) in its shared-origin form, K7 replaces _sd_kernel
// (called by sd_trace_pallas, the VMEM-resident tier that the reference takes
// for scenes of up to 65,536 triangles). Both trace one ray per SD texel,
// every ray starting at the pinhole origin, against 128-triangle chunks of
// shared-origin rows. A block owns an 8x32 texel tile of the SD grid and
// each of its 256 threads one ray.
// - The block reduces the world box of its rays' valid segments (o + d*tmin,
//   o + d*tmax) and, for K5, their screen range (rx, ry) and interval range,
//   with build_chunk_lists' expressions. Its warps then test 32 chunks at a
//   time against the chunk AABBs (and K5's screen rows) and append the
//   overlapping ids to an ascending list in shared memory (ballot and
//   population count), a window of kWindow chunks at a time.
// - K5 keeps the reference's list width: LIST_CAP when n_chunks > 2 *
//   LIST_CAP, else n_chunks; a tile with more overlaps than the width walks
//   every chunk (rt_pallas.py:476, ops/rt_cuda.py:compact_lists), so it
//   counts its overlaps first. K7 has no width: it walks every overlapping
//   chunk. The only differences are template parameters: the cull (world
//   and screen with the width, or world alone) and the back-face cull.
// - K5's rays come in 8x32-tile order (a grid 32 wide); K7 reads the
//   row-major rays of the SD grid through the tile mapping, so no host
//   reorder runs, and tiles past the grid's edge hold dead rays.
// - Chunks are walked in ascending order (MaxCount counts in chunk order,
//   then triangle order). Each listed chunk (128 triangles x 16 floats,
//   triangle-major: nt, tp | bt, accept-back | ct, reject | mask, padding;
//   ops/rt_cuda.py:prep_triangles_packed) is copied into shared memory as
//   float4s between two barriers. The face test reads three float4s; the
//   alpha mask is read only on a hit. A thread runs the face tests of
//   kGroup triangles before any hit's tail: straight-line code with kGroup
//   independent chains, since a pair's dependent operations, more than
//   their count, bound the visit.
// Bounded by arithmetic: a visited chunk costs each ray 128 pairs of three
// three-term dot products and five compares (18 counted operations); the
// tail (divide, alpha bit, hash, insertion) runs only for face-accepted
// hits, which are rare because the ray intervals are tight. det, u*det and
// v*det are a small matrix product, but no tensor core can take it: each
// product and sum must round as a separate fp32 operation (--fmad=false),
// which neither TF32 nor split-TF32 products reproduce. The k slots live in
// registers (K is a template parameter).
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

constexpr int kTileH = 8, kTileW = 32;  // the block's texel tile
constexpr int kThreads = kTileH * kTileW;  // one ray a thread
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;               // face tests before any tail
constexpr int kTC = 128;                // triangles per chunk
constexpr int kTriF4 = 4;               // float4s a triangle
constexpr int kChunkF4 = kTC * kTriF4;  // float4s a chunk
constexpr int kWindow = 1024;           // chunks listed at once
constexpr int kInvalid = 2147483647;
constexpr float kEpsDet = 1e-9f;
constexpr int kCountCap = 1 << 30;
constexpr int kMaxLut = 256;            // 2^k coverage masks for k <= 8
constexpr unsigned kGolden = 0x9E3779B1u;
constexpr int kModeKBuffer = 1;
constexpr int kModeCoverage = 2;
constexpr float kInf = __builtin_huge_valf();

// Uniform per-launch insertion parameters.
struct Tail {
  int mode;
  int max_count;  // 0: uncapped
  float ak;       // alpha * k (coverage)
  int lut_n;
};

struct Params {
  const float4* tri;    // [n_chunks][kTC][kTriF4]
  const float* aabb;    // [rows][n_chunks]: min xyz, max xyz (K5: + screen)
  const float* origin;  // [3]
  const float* rays;    // [7][n_rays]: dx, dy, dz, tmin, tmax, za, zb
  const float* rx;      // K5: [n_rays] signed texel x, or null (no screen
  const float* ry;      //     test); K5: [n_rays] texel y
  int n_rays, grid_h, grid_w, tiles_x, n_chunks;
  int list_w;           // K5: the list width; K7: n_chunks (never full)
  Tail tail;
  const int* lut;
  const int* idx;
  int* out;             // [grid_h * grid_w][K]
};

struct Ray {
  float dx, dy, dz, tmin, tmax, za, zb;
};

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

// The block's shared memory: the staged chunk, the window's chunk list,
// the coverage tables and the reduction scratch.
template <int K>
struct Shared {
  float4 tri[kChunkF4];
  int list[kWindow];
  int lut[kMaxLut];
  int idx[K + 2];
  float red[kWarps][12];
  float box[12];  // the block's cull box (block_box)
  int wcount[kWarps];
};

// Copy chunk ci into `dst` (every thread its share).
__device__ __forceinline__ void stage_chunk(float4* dst, const float4* tri,
                                            int ci) {
  const float4* src = tri + (size_t)ci * kChunkF4;
#pragma unroll
  for (int i = threadIdx.x; i < kChunkF4; i += kThreads) dst[i] = src[i];
}

// The face test of one ray against one triangle (a, b, c: the first
// three float4s of its row): the unnormalized Moller-Trumbore test, the
// back-face rule and the reject flag (c.w).
template <bool CULL_BACK>
__device__ __forceinline__ bool face_test(const Ray& ray, const float4& a,
                                          const float4& b, const float4& c) {
  const float det = ray.dx * a.x + ray.dy * a.y + ray.dz * a.z;
  const float pu = ray.dx * b.x + ray.dy * b.y + ray.dz * b.z;
  const float pv = ray.dx * c.x + ray.dy * c.y + ray.dz * c.z;
  const float tp = a.w;
  bool ok;
  if (CULL_BACK) {
    ok = (det > kEpsDet) && (pu >= 0.0f) && (pv >= 0.0f) &&
         (pu + pv <= det) && (tp > ray.tmin * det) && (tp < ray.tmax * det);
  } else {
    const float s = det >= 0.0f ? 1.0f : -1.0f;
    const float adet = det * s;
    const float spu = pu * s;
    const float spv = pv * s;
    const float stp = tp * s;
    ok = (fabsf(det) > kEpsDet) && (spu >= 0.0f) && (spv >= 0.0f) &&
         (spu + spv <= adet) && (stp > ray.tmin * adet) &&
         (stp < ray.tmax * adet) && ((det > 0.0f) || (b.w > 0.0f));
  }
  return ok && c.w == 0.0f;
}

// A face-accepted hit of `ray` on the triangle at `row`: the MaxCount
// ordinal, the alpha bit and the insertion into the slots.
template <int K>
__device__ __forceinline__ void hit_tail(const Ray& ray, const float4* row,
                                         const Tail& tail, const int* lut,
                                         const int* idx, int (&slots)[K],
                                         int& count) {
  const float4 a = row[0], b = row[1], c = row[2];
  const float det = ray.dx * a.x + ray.dy * a.y + ray.dz * a.z;
  const float pu = ray.dx * b.x + ray.dy * b.y + ray.dz * b.z;
  const float pv = ray.dx * c.x + ray.dy * c.y + ray.dz * c.z;
  const float tp = a.w;
  bool capped = false;
  if (tail.max_count > 0) {  // the cap counts hits before the alpha test
    capped = count >= tail.max_count;
    count = min(count + 1, kCountCap);
  }

  const float inv = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);
  const float u = pu * inv;
  const float v = pv * inv;
  const float th = tp * inv;
  const int cell = __float2int_rz(fminf(fmaxf(u * 4.0f, 0.0f), 3.0f)) +
                   4 * __float2int_rz(fminf(fmaxf(v * 4.0f, 0.0f), 3.0f));
  const int amask = __float2int_rz(row[3].x);
  if ((((unsigned)amask >> cell) & 1u) == 0u || capped) return;

  const float d_norm = fminf(fmaxf(th * ray.za - ray.zb, 0.0f), 1.0f);
  const int d16 = min(max(__float2int_rz(d_norm * 65535.0f), 0), 65535);
  const int hb = hash_uv(u, v);
  const int k15 = key15_of(hb);
  if (tail.mode == kModeCoverage) {
    const float rng = (float)k15 * kInv32767;
    int h2 = (hb ^ (int)((unsigned)d16 * kGolden)) ^ (hb >> 5);
    h2 = h2 ^ (h2 >> 11);
    const float rng2 = (float)key15_of(h2) * kInv32767;
    const int mask = coverage_mask<K>(tail.ak, rng, rng2, lut, tail.lut_n,
                                      idx);
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

// Fold one staged chunk into this thread's ray: kGroup triangles at a
// time, the group's face tests first (straight-line code, no branch), then
// the tails of its hits in triangle order.
template <int K, bool CULL_BACK>
__device__ __forceinline__ void visit_chunk(const float4* tri,
                                            const Ray& ray, const Tail& tail,
                                            const int* lut, const int* idx,
                                            int (&slots)[K], int& count) {
#pragma unroll 1
  for (int l0 = 0; l0 < kTC; l0 += kGroup) {
    unsigned hits = 0u;  // bit g: the ray hits triangle l0 + g
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const float4* row = tri + (l0 + g) * kTriF4;
      hits |= (unsigned)face_test<CULL_BACK>(ray, row[0], row[1], row[2])
              << g;
    }
    while (hits != 0u) {
      const int g = __ffs(hits) - 1;
      hits &= hits - 1u;
      hit_tail<K>(ray, tri + (l0 + g) * kTriF4, tail, lut, idx, slots,
                  count);
    }
  }
}

// The block's cull box: world lo xyz, hi xyz, then (K5) texel x lo, hi,
// y lo, hi, tmin lo, tmax hi of its valid rays.
struct Box {
  float v[12];
};

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool is_min_entry(int e) {
  return e < 3 || (e >= 6 && (e & 1) == 0);
}

// Reduce the per-thread partial box over the block into sh.box. Entries
// 0-2, 6, 8, 10 are minima; 3-5, 7, 9, 11 maxima.
template <int K>
__device__ __forceinline__ void block_box(const Box& part, Shared<K>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < 12; ++e) {
    const float v =
        is_min_entry(e) ? warp_min(part.v[e]) : warp_max(part.v[e]);
    if (lane == 0) sh.red[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x < 12) {
    const int e = threadIdx.x;
    float v = sh.red[0][e];
    for (int w = 1; w < kWarps; ++w)
      v = is_min_entry(e) ? fminf(v, sh.red[w][e]) : fmaxf(v, sh.red[w][e]);
    sh.box[e] = v;
  }
  __syncthreads();
}

// Does chunk ci overlap the block's box (build_chunk_lists' tests)?
template <bool STREAM>
__device__ __forceinline__ bool overlaps(const Params& p, const float* box,
                                         int ci) {
  const float* a = p.aabb + ci;
  const size_t n = (size_t)p.n_chunks;
  bool ov = (a[0 * n] <= box[3]) && (a[3 * n] >= box[0]) &&
            (a[1 * n] <= box[4]) && (a[4 * n] >= box[1]) &&
            (a[2 * n] <= box[5]) && (a[5 * n] >= box[2]);
  if (STREAM && p.rx != nullptr)
    ov = ov && (a[6 * n] <= box[7]) && (a[9 * n] >= box[6]) &&
         (a[7 * n] <= box[9]) && (a[10 * n] >= box[8]) &&
         (a[8 * n] <= box[11]) && (a[11 * n] >= box[10]);
  return ov;
}

// The block's overlaps over all chunks (unclamped, as compact_lists'
// counts).
template <int K, bool STREAM>
__device__ __forceinline__ int count_overlaps(const Params& p,
                                              Shared<K>& sh) {
  int n = 0;
  for (int c0 = 0; c0 < p.n_chunks; c0 += kThreads) {
    const int ci = c0 + threadIdx.x;
    n += __popc(__ballot_sync(
        0xffffffffu, ci < p.n_chunks && overlaps<STREAM>(p, sh.box, ci)));
  }
  if ((threadIdx.x & 31) == 0) sh.wcount[threadIdx.x >> 5] = n;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < kWarps; ++w) total += sh.wcount[w];
  __syncthreads();  // wcount is free again
  return total;
}

// The ascending list of the overlapping chunks in [win, win + kWindow),
// in sh.list; returns its length. Starts and ends with a barrier.
template <int K, bool STREAM>
__device__ __forceinline__ int build_list(const Params& p, Shared<K>& sh,
                                          int win) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int end = min(win + kWindow, p.n_chunks);
  int base = 0;
  __syncthreads();  // every thread is done with the previous list
  for (int c0 = win; c0 < end; c0 += kThreads) {
    const int ci = c0 + threadIdx.x;
    const bool ov = ci < end && overlaps<STREAM>(p, sh.box, ci);
    const unsigned m = __ballot_sync(0xffffffffu, ov);
    if (lane == 0) sh.wcount[warp] = __popc(m);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int nw = sh.wcount[w];
      off += w < warp ? nw : 0;
      total += nw;
    }
    if (ov) sh.list[off + __popc(m & ((1u << lane) - 1u))] = ci;
    base += total;
    __syncthreads();  // the list is complete, wcount free again
  }
  return base;
}

// The kernel body. STREAM: K5's cull (world and screen, the list width);
// else K7's (world only). CULL_BACK: the back-face cull.
template <int K, bool STREAM, bool CULL_BACK>
__device__ __forceinline__ void trace_tile(const Params& p) {
  __shared__ Shared<K> sh;
  const Tail tail = p.tail;
  for (int i = threadIdx.x; i < tail.lut_n; i += kThreads)
    sh.lut[i] = p.lut[i];
  if (threadIdx.x < K + 2) sh.idx[threadIdx.x] = p.idx[threadIdx.x];

  const int ty = blockIdx.x / p.tiles_x, tx = blockIdx.x % p.tiles_x;
  const int x = tx * kTileW + (threadIdx.x & 31);
  const int y = ty * kTileH + (threadIdx.x >> 5);
  const bool in = y < p.grid_h && x < p.grid_w;
  const int r = in ? y * p.grid_w + x : 0;
  const size_t n = (size_t)p.n_rays;
  const float* rr = p.rays + r;
  const Ray ray = in ? Ray{rr[0], rr[n], rr[2 * n], rr[3 * n], rr[4 * n],
                           rr[5 * n], rr[6 * n]}
                     : Ray{0.0f, 0.0f, 0.0f, 0.0f, -1.0f, 0.0f, 0.0f};
  const bool valid = ray.tmax > ray.tmin;
  Box part;
#pragma unroll
  for (int e = 0; e < 12; ++e) part.v[e] = is_min_entry(e) ? kInf : -kInf;
  // the conservative box of the valid segments (rt_cuda.py:
  // build_chunk_lists); a ray with tmax <= tmin adds nothing
  if (valid) {
    const float o[3] = {p.origin[0], p.origin[1], p.origin[2]};
    const float d[3] = {ray.dx, ray.dy, ray.dz};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float a = o[c] + d[c] * ray.tmin;
      const float b = o[c] + d[c] * ray.tmax;
      part.v[c] = fminf(part.v[c], fminf(a, b));
      part.v[3 + c] = fmaxf(part.v[3 + c], fmaxf(a, b));
    }
    if (STREAM && p.rx != nullptr) {
      const float sx = p.rx[r], sy = p.ry[r];
      part.v[6] = fminf(part.v[6], sx);
      part.v[7] = fmaxf(part.v[7], sx);
      part.v[8] = fminf(part.v[8], sy);
      part.v[9] = fmaxf(part.v[9], sy);
      part.v[10] = fminf(part.v[10], ray.tmin);
      part.v[11] = fmaxf(part.v[11], ray.tmax);
    }
  }
  block_box<K>(part, sh);

  int slots[K];
#pragma unroll
  for (int s = 0; s < K; ++s) slots[s] = kInvalid;
  int count = 0;

  // K5: more overlaps than the list width walks every chunk
  const bool full = STREAM && p.n_chunks > p.list_w &&
                    count_overlaps<K, STREAM>(p, sh) > p.list_w;
  bool stop = false;
  for (int win = 0; win < p.n_chunks && !stop; win += kWindow) {
    const int n_list = full ? min(kWindow, p.n_chunks - win)
                            : build_list<K, STREAM>(p, sh, win);
    for (int j = 0; j < n_list; ++j) {
      // every thread is done with the previous chunk; under a MaxCount the
      // block stops once every live ray has counted it
      if (tail.max_count > 0) {
        if (__syncthreads_and(!valid || count >= tail.max_count)) {
          stop = true;
          break;
        }
      } else {
        __syncthreads();
      }
      stage_chunk(sh.tri, p.tri, full ? win + j : sh.list[j]);
      __syncthreads();
      visit_chunk<K, CULL_BACK>(sh.tri, ray, tail, sh.lut, sh.idx, slots,
                                count);
    }
  }
  if (in) {
#pragma unroll
    for (int s = 0; s < K; ++s) p.out[(size_t)r * K + s] = slots[s];
  }
}

template <int K, bool CULL_BACK>
__global__ void __launch_bounds__(kThreads)
    sd_trace_kernel(const Params p) {
  trace_tile<K, true, CULL_BACK>(p);
}

template <int K, bool CULL_BACK>
__global__ void __launch_bounds__(kThreads)
    sd_trace_resident_kernel(const Params p) {
  trace_tile<K, false, CULL_BACK>(p);
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

bool valid_args(int k, int mode, int lut_n) {
  return k >= 1 && k <= 8 && mode >= 0 && mode <= kModeCoverage &&
         lut_n >= 0 && lut_n <= kMaxLut;
}

template <bool STREAM, int K, bool CB>
void launch_k(const Params& p, int n_tiles, cudaStream_t stream) {
  if constexpr (STREAM)
    sd_trace_kernel<K, CB><<<n_tiles, kThreads, 0, stream>>>(p);
  else
    sd_trace_resident_kernel<K, CB><<<n_tiles, kThreads, 0, stream>>>(p);
}

template <bool STREAM>
void launch(const Params& p, int n_tiles, int k, int cull_back,
            cudaStream_t stream) {
  switch (k * 2 + (cull_back ? 1 : 0)) {
#define RTSDM_TRACE_CASE(KK)                                  \
  case KK * 2:                                                \
    launch_k<STREAM, KK, false>(p, n_tiles, stream);          \
    break;                                                    \
  case KK * 2 + 1:                                            \
    launch_k<STREAM, KK, true>(p, n_tiles, stream);           \
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

Params make_params(const float* tri, const float* aabb, const float* origin,
                   const float* rays, int n_rays, int grid_h, int grid_w,
                   int n_chunks, int mode, int max_count, float ak,
                   const int* lut, int lut_n, const int* idx, int* out) {
  Params p;
  p.tri = reinterpret_cast<const float4*>(tri);
  p.aabb = aabb;
  p.origin = origin;
  p.rays = rays;
  p.rx = nullptr;
  p.ry = nullptr;
  p.n_rays = n_rays;
  p.grid_h = grid_h;
  p.grid_w = grid_w;
  p.tiles_x = (grid_w + kTileW - 1) / kTileW;
  p.n_chunks = n_chunks;
  p.list_w = n_chunks;
  p.tail.mode = mode;
  p.tail.max_count = max_count;
  p.tail.ak = ak;
  p.tail.lut_n = lut_n;
  p.lut = lut;
  p.idx = idx;
  p.out = out;
  return p;
}

}  // namespace

// K5. tri: [n_chunks, 128, 16] float (prep_triangles_packed); aabb:
// [12, n_chunks] (world min xyz, max xyz, then chunk_screen_rows), or [>=6,
// n_chunks] with rx = ry = null (no screen test); origin [3]; rays: [7,
// nb*256] (dx, dy, dz, tmin, tmax, za, zb) in 8x32-tile order; rx, ry:
// [nb*256] signed texel coordinates in the same order; list_w: the list
// width (LIST_CAP when n_chunks > 2 * LIST_CAP, else n_chunks); mode 0
// default, 1 kbuffer, 2 coverage; ak = alpha * k; lut [lut_n] and idx
// [k + 2]: stratified_coverage_tables(k); out: [nb*256, k].
extern "C" int rtsdm_sd_trace(const float* tri, const float* aabb,
                              const float* origin, const float* rays,
                              const float* rx, const float* ry, int nb,
                              int n_chunks, int list_w, int k, int cull_back,
                              int mode, int max_count, float ak,
                              const int* lut, int lut_n, const int* idx,
                              int* out, cudaStream_t stream) {
  if (!valid_args(k, mode, lut_n) || (rx == nullptr) != (ry == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(tri, aabb, origin, rays, nb * kTileH * kTileW,
                         nb * kTileH, kTileW, n_chunks, mode, max_count, ak,
                         lut, lut_n, idx, out);
  p.rx = rx;
  p.ry = ry;
  p.list_w = list_w;
  if (nb > 0) launch<true>(p, nb, k, cull_back, stream);
  return (int)cudaGetLastError();
}

// K7. rays: [7, n_rays] in row-major order over a grid_h x grid_w SD grid
// (grid_h * grid_w <= n_rays); aabb: [6, n_chunks] chunk AABBs; origin: [3],
// the rays' shared origin; out: [grid_h * grid_w, k].
extern "C" int rtsdm_sd_trace_resident(const float* tri, const float* aabb,
                                       const float* origin,
                                       const float* rays, int n_rays,
                                       int grid_h, int grid_w, int n_chunks,
                                       int k, int cull_back, int mode,
                                       int max_count, float ak,
                                       const int* lut, int lut_n,
                                       const int* idx, int* out,
                                       cudaStream_t stream) {
  if (!valid_args(k, mode, lut_n) || grid_h < 0 || grid_w < 0 ||
      (long long)grid_h * grid_w > n_rays)
    return (int)cudaErrorInvalidValue;
  const Params p = make_params(tri, aabb, origin, rays, n_rays, grid_h,
                               grid_w, n_chunks, mode, max_count, ak, lut,
                               lut_n, idx, out);
  const int n_tiles = p.tiles_x * ((grid_h + kTileH - 1) / kTileH);
  if (n_tiles > 0) launch<false>(p, n_tiles, k, cull_back, stream);
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
