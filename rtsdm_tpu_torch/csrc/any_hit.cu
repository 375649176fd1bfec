// Shadow-ray any-hit (K8).
//
// Replaces rtsdm_tpu/ops/rt_pallas.py:any_hit_pallas, which runs the
// streaming SD kernel (_sd_stream_kernel, :482) with classic=True,
// num_samples=1, cull_back=False and early_exit=True. Every ray has its own
// origin (a shaded surface point), so the per-triangle shared-origin rows
// of the SD trace do not apply: each chunk holds raw v0/e1/e2 rows and the
// Moller-Trumbore cross products are formed per ray-triangle pair.
//
// Rays come in 8x32 tiles; each tile has a list of 128-triangle chunks,
// ordered near to far along the mean ray direction, whose AABBs meet the
// tile's segment bundle. Bounded by arithmetic (fp32 operations per pair
// tested), so the design tests fewer pairs and spends less on each:
//
// * Per-ray cull. Every chunk has four boxes of 32 triangles
//   (ops/rt_cuda.py:any_hit_boxes, padded so that no triangle the pair test
//   below can accept lies outside its box, rounding included). Each lane
//   slab-tests its own segment against them; a warp stages and walks only
//   the boxes some lane meets, and a lane tests only the triangles of the
//   boxes it meets. A toward-the-sun segment is far thinner than its
//   tile's bundle, so most of a tile's list is culled per ray.
// * Hoisting. When every live ray of a warp has the same direction (bit for
//   bit: a directional light), d x e2, det, its sign, 1/det and the face
//   flags are computed once per triangle while the 32 triangles of a box
//   are staged: the same expressions on the same operands, so every pair
//   rounds as before. Other warps (point lights, mixed) form them per pair.
// * Independent warps. A block is two warps, each owning one row of 32
//   rays of a tile; a warp walks the tile's list on its own, stages a box
//   in its own slice of shared memory (__syncwarp only), and stops once its
//   live rays have all hit. No warp waits for another.
// * Early exits. The pair test checks each face condition as soon as its
//   operands exist (u*det, then v*det, then t*det); neighbouring rays
//   mostly fail the same triangle at the same condition, so the warp
//   leaves together.
//
// Per-pair math follows rt_pallas.py:_classic_origin_math (:238-295) with
// k = 1, no culling and back faces accepted (any_hit_pallas sets the
// accept-back flag for every triangle): unnormalized spu, spv, stp against
// adet; stp in (tmin adet, tmax adet); the reject flag; then the baked 4x4
// alpha bit at the cell of u = pu inv, v = pv inv. A hit is any accepted
// pair (the 1-slot reservoir holds a value below INVALID); it is an OR, so
// the order of the walk and a conservative cull cannot change it. Each
// thread writes how many pairs its ray tested, up to and including the one
// that hit. Built with --fmad=false and no fast math, so every expression
// rounds like the plain PyTorch version in ops/rt_cuda.py.
#include <cuda_runtime.h>

namespace {

constexpr int kTileRays = 256;  // 8x32 ray tile (one chunk list)
constexpr int kTileRows = 8;
constexpr int kTC = 128;        // triangles per chunk
constexpr int kSub = 32;        // triangles per cull box (one per lane)
constexpr int kNSub = kTC / kSub;
constexpr int kRows = 12;       // v0(3) e1(3) e2(3), acc-back, reject, mask
constexpr int kWarps = 2;       // warps (tile rows) per block
constexpr float kEpsDet = 1e-9f;
constexpr float kFlat = 1e-30f;  // ops/rt_cuda.py:FLAT_DIR
constexpr unsigned kAll = 0xffffffffu;
constexpr int kAccBack = 1 << 16;  // bits of a staged triangle
constexpr int kKeep = 1 << 17;     // not rejected
constexpr int kOk = 1 << 18;       // hoisted det and face flags pass

// One staged triangle, read as four 16-byte broadcasts:
// a = (v0x, v0y, v0z, e1x), b = (e1y, e1z, e2x, e2y),
// c = (e2z, px, py, pz), e = (adet, sign, 1/det, bits); p, adet, sign,
// 1/det and kOk only when hoisted. bits: alpha mask (0-15), kAccBack, kKeep,
// kOk.
struct __align__(16) Tri {
  float4 a, b, c, e;
};

struct Ray {
  float o[3], d[3], inv[3], tmin, tmax;
  bool flat[3];
};

// ops/rt_cuda.py:segment_overlaps: the same operations in the same order
__device__ __forceinline__ bool meets(const Ray& r, const float* box, int k) {
  float tn = r.tmin, tf = r.tmax;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = __ldg(box + c * kNSub + k);
    const float hi = __ldg(box + (3 + c) * kNSub + k);
    const float t0 = (lo - r.o[c]) * r.inv[c];
    const float t1 = (hi - r.o[c]) * r.inv[c];
    const bool inside = r.o[c] >= lo && r.o[c] <= hi;
    const float a =
        r.flat[c] ? (inside ? -INFINITY : INFINITY) : fminf(t0, t1);
    const float b = r.flat[c] ? INFINITY : fmaxf(t0, t1);
    tn = fmaxf(tn, a);
    tf = fminf(tf, b);
  }
  return tn <= tf;
}

// Does the pair (ray, staged triangle) pass? kHoisted: p, adet, sign and
// 1/det come from the stage (the warp's rays share r.d).
template <bool kHoisted>
__device__ __forceinline__ bool accepts(const Ray& r, const Tri& t) {
  const int bits = __float_as_int(t.e.w);
  if (!(bits & kKeep)) return false;
  if (kHoisted && !(bits & kOk)) return false;
  const float e1x = t.a.w, e1y = t.b.x, e1z = t.b.y;
  const float e2x = t.b.z, e2y = t.b.w, e2z = t.c.x;
  const float dx = r.d[0], dy = r.d[1], dz = r.d[2];
  float px, py, pz, det, s, adet, inv;
  if (kHoisted) {
    px = t.c.y;
    py = t.c.z;
    pz = t.c.w;
    adet = t.e.x;
    s = t.e.y;
    inv = t.e.z;
  } else {
    px = dy * e2z - dz * e2y;
    py = dz * e2x - dx * e2z;
    pz = dx * e2y - dy * e2x;
    det = e1x * px + e1y * py + e1z * pz;
    if (!(fabsf(det) > kEpsDet) || !((det > 0.0f) || (bits & kAccBack)))
      return false;
    s = det >= 0.0f ? 1.0f : -1.0f;
    adet = det * s;
    inv = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);
  }
  // the face test's conditions one at a time, each as soon as its operands
  // exist (the same values as evaluating them all; a NaN fails each as it
  // fails the conjunction): neighbouring rays mostly leave together
  const float tvx = r.o[0] - t.a.x;
  const float tvy = r.o[1] - t.a.y;
  const float tvz = r.o[2] - t.a.z;
  const float pu = tvx * px + tvy * py + tvz * pz;
  const float spu = pu * s;
  if (!(spu >= 0.0f)) return false;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float pv = dx * qx + dy * qy + dz * qz;
  const float spv = pv * s;
  if (!((spv >= 0.0f) && (spu + spv <= adet))) return false;
  const float tp = e2x * qx + e2y * qy + e2z * qz;
  const float stp = tp * s;
  if (!((stp > r.tmin * adet) && (stp < r.tmax * adet))) return false;
  const float u = pu * inv;
  const float v = pv * inv;
  const int cell = __float2int_rz(fminf(fmaxf(u * 4.0f, 0.0f), 3.0f)) +
                   4 * __float2int_rz(fminf(fmaxf(v * 4.0f, 0.0f), 3.0f));
  return ((bits >> cell) & 1) != 0;
}

// The lane's ray tests the staged box in order until its first hit; returns
// the pairs it tested.
template <bool kHoisted>
__device__ __forceinline__ int walk_box(const Ray& r, const Tri* st,
                                        bool& hit) {
  for (int i = 0; i < kSub; ++i) {
    if (accepts<kHoisted>(r, st[i])) {
      hit = true;
      return i + 1;
    }
  }
  return kSub;
}

__global__ void __launch_bounds__(kWarps * 32)
    any_hit_kernel(const float* __restrict__ tri_packed,
                   const float* __restrict__ boxes,
                   const int* __restrict__ lists,
                   const int* __restrict__ counts,
                   const float* __restrict__ rays, int n_rays, int n_chunks,
                   int list_w, unsigned char* __restrict__ hit_out,
                   int* __restrict__ pairs_out) {
  __shared__ Tri stage[kWarps][kSub];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kBlocksPerTile = kTileRows / kWarps;
  const int b = blockIdx.x / kBlocksPerTile;  // tile
  const int row = (blockIdx.x % kBlocksPerTile) * kWarps + warp;
  const int ri = b * kTileRays + row * 32 + lane;
  Ray r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.o[c] = rays[c * (size_t)n_rays + ri];
    r.d[c] = rays[(3 + c) * (size_t)n_rays + ri];
    r.flat[c] = fabsf(r.d[c]) < kFlat;
    r.inv[c] = r.flat[c] ? 0.0f : 1.0f / r.d[c];
  }
  r.tmin = rays[6 * (size_t)n_rays + ri];
  r.tmax = rays[7 * (size_t)n_rays + ri];
  const bool live = r.tmax > r.tmin;

  // hoist when every live ray of the warp has the lead ray's direction
  const unsigned live_mask = __ballot_sync(kAll, live);
  const int lead = live_mask ? __ffs(live_mask) - 1 : 0;
  const float lx = __shfl_sync(kAll, r.d[0], lead);
  const float ly = __shfl_sync(kAll, r.d[1], lead);
  const float lz = __shfl_sync(kAll, r.d[2], lead);
  const bool hoisted = __all_sync(
      kAll, !live || (__float_as_uint(r.d[0]) == __float_as_uint(lx) &&
                      __float_as_uint(r.d[1]) == __float_as_uint(ly) &&
                      __float_as_uint(r.d[2]) == __float_as_uint(lz)));

  Tri* st = stage[warp];
  bool hit = false;
  int pairs = 0;
  const int raw = counts[b];
  const bool full = raw > list_w;
  const int cnt = full ? n_chunks : raw;
  for (int j = 0; j < cnt; ++j) {
    if (!__any_sync(kAll, live && !hit)) break;
    const int ci = full ? j : __ldg(lists + (size_t)b * list_w + j);
    const float* box = boxes + (size_t)ci * 6 * kNSub;
    const float* src = tri_packed + (size_t)ci * kRows * kTC;
    for (int k = 0; k < kNSub; ++k) {
      const bool mine = live && !hit && meets(r, box, k);
      if (!__any_sync(kAll, mine)) continue;
      // stage the box: lane l takes triangle 32 k + l
      float v[kRows];
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        v[q] = __ldg(src + q * kTC + k * kSub + lane);
      int bits = __float2int_rz(v[11]) & 0xFFFF;
      if (v[9] > 0.0f) bits |= kAccBack;
      if (v[10] == 0.0f) bits |= kKeep;
      Tri t;
      t.a = make_float4(v[0], v[1], v[2], v[3]);
      t.b = make_float4(v[4], v[5], v[6], v[7]);
      float px = 0.0f, py = 0.0f, pz = 0.0f, adet = 0.0f, s = 0.0f,
            inv = 0.0f;
      if (hoisted) {
        px = ly * v[8] - lz * v[7];
        py = lz * v[6] - lx * v[8];
        pz = lx * v[7] - ly * v[6];
        const float det = v[3] * px + v[4] * py + v[5] * pz;
        if ((fabsf(det) > kEpsDet) && ((det > 0.0f) || (bits & kAccBack)))
          bits |= kOk;
        s = det >= 0.0f ? 1.0f : -1.0f;
        adet = det * s;
        inv = 1.0f / (fabsf(det) < kEpsDet ? 1.0f : det);
      }
      t.c = make_float4(v[8], px, py, pz);
      t.e = make_float4(adet, s, inv, __int_as_float(bits));
      __syncwarp();  // the previous box is no longer read
      st[lane] = t;
      __syncwarp();
      if (mine)
        pairs += hoisted ? walk_box<true>(r, st, hit)
                         : walk_box<false>(r, st, hit);
    }
  }
  hit_out[ri] = hit ? 1 : 0;
  pairs_out[ri] = pairs;
}

}  // namespace

// boxes: [n_chunks, 6, 4] float (ops/rt_cuda.py:any_hit_boxes); rays:
// [8, nb*256] float (ox, oy, oz, dx, dy, dz, tmin, tmax); hit: [nb*256]
// uint8; pairs: [nb*256] int (ray-triangle pairs each ray tested).
extern "C" int rtsdm_any_hit(const float* tri_packed, const float* boxes,
                             const int* lists, const int* counts,
                             const float* rays, int nb, int n_chunks,
                             int list_w, unsigned char* hit, int* pairs,
                             cudaStream_t stream) {
  if (nb > 0)
    any_hit_kernel<<<nb * (kTileRows / kWarps), kWarps * 32, 0, stream>>>(
        tri_packed, boxes, lists, counts, rays, nb * kTileRays, n_chunks,
        list_w, hit, pairs);
  return (int)cudaGetLastError();
}
