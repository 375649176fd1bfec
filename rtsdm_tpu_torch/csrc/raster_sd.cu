// k-slot stochastic-depth raster (K9).
//
// Replaces rtsdm_tpu/ops/raster_pallas.py:_raster_sd_kernel (driver
// raster_stochastic_pallas), the raster stochastic depth map of the
// reference StochasticDepthMap (StochasticDepth.ps.slang): every fragment
// behind the first depth layer and inside the per-pixel ray interval
// writes its linear view depth into a pseudo-random subset of the k slots
// (a stratified coverage mask), and each slot keeps its minimum.
//
// Bounded by operations: the pixel-triangle pairs it evaluates (the three
// edge functions and the w plane). K1's design (raster.cu) applies, since
// K9 walks the same 8x32-tile chunk lists of the same [n_chunks, 17, 128]
// coefficient chunks:
// * per-triangle cull: at every visit a warp tests the chunk's 128 cull
//   boxes ([n_chunks, 4, 128], ops/raster_cuda.py:cull_boxes) against its
//   half tile (32 x 4 pixels) with the strict comparisons of
//   build_chunk_lists_2d, compacts the survivors in ascending lane order
//   (ballot and popcount) and evaluates only them. Exact: a box encloses
//   every point at which K1's fragment test accepts the triangle
//   (e >= -1e-5 * sum|e|, wd > 0, 0 <= z <= 1), and K9's test is stricter
//   (e >= 0 with no tolerance, the same wd and z tests), so a culled
//   triangle holds no fragment K9 keeps. Invalid and padding lanes have
//   empty boxes, so the valid row needs no test. tests/
//   test_torch_raster_sd.py holds the plain K9 restricted to the survivors
//   equal to the unrestricted one;
// * a staged survivor is K1's four float4 (c0x c0y c0z c1x | c1y c1z c2x
//   c2y | c2z zcx zcy zcz | wcx wcy wcz id), read as warp broadcasts;
// * each thread owns one column of four rows of the tile, so the x
//   products of each plane serve four pixels, and keeps 4 x k slot minima
//   in registers (k is a template parameter);
// * the edges and wd > 0 are tested first; the depth, the interval, the
//   hash and the mask follow only for a fragment that passes;
// * a tile's walk may be split over `parts` warps per half tile (visits j
//   = part, part + parts, ...), so that the few hundred tiles of an SD
//   grid fill the card. A slot's value is a minimum, which does not depend
//   on the order of the visits, and every stored value is a positive float
//   (vd = wd / esum with wd > 0 and esum >= 0, 1 where it is 0; NaN never
//   passes vd > first; the empty 3e38), so the parts merge exactly by
//   atomicMin on the bit patterns read as int into an output filled with
//   3e38. With one part the warp stores its slots.
//
// Semantics follow the Pallas kernel exactly (raster_pallas.py:247-292):
// edges >= 0 with no tolerance (unlike K1), wd > 0, 0 <= zn / wd <= 1,
// view depth wd / esum (esum = e0 + e1 + e2, 1 where it is 0) >
// first + 0.01, (rmin == 0 or view depth >= rmin), rmax != 0 and view
// depth <= rmax. The fragment's draws come from an int32 hash of the
// truncated pixel centre and the triangle's original id (wrapping
// multiplies, arithmetic >>, floor mod of |hb| with |INT_MIN| wrapping);
// the mask is utils/sampling.coverage_mask_select's: floor(alpha*k + rng)
// bits (a float32 add), the group member picked by a truncated float32
// product. Empty slots hold 3e38. Built with --fmad=false and no fast
// math, so every expression rounds like the plain PyTorch version in
// ops/raster_cuda.py.
#include <cuda_runtime.h>

#include "int_hash.cuh"

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kTC = 128;                 // triangles per chunk
constexpr int kRows = 17;                // c0 c1 c2 zc wc (3 each), valid, id
constexpr int kPix = 4;                  // rows of a tile per thread
constexpr int kWarps = 4;                // warps per block
constexpr int kMaxLut = 256;             // 2^k masks for k <= 8
constexpr float kEmpty = 3e38f;
constexpr unsigned kGolden = 0x9E3779B1u;
constexpr unsigned kAll = 0xffffffffu;

template <int K>
__global__ void __launch_bounds__(kWarps * 32)
    raster_sd_kernel(const float* __restrict__ coef,
                     const float* __restrict__ boxes,
                     const int* __restrict__ lists,
                     const int* __restrict__ counts,
                     const float* __restrict__ first_img,
                     const float* __restrict__ rmin_img,
                     const float* __restrict__ rmax_img, int n_chunks,
                     int list_w, int n_tasks, int parts, int nbx, int img_w,
                     int img_h, float ak, const int* __restrict__ lut_g,
                     int lut_n, const int* __restrict__ idx_g,
                     float* __restrict__ out) {
  __shared__ float4 staged[kWarps][4][32];
  __shared__ int lut[kMaxLut];
  __shared__ int idx[K + 2];
  for (int i = threadIdx.x; i < lut_n; i += kWarps * 32) lut[i] = lut_g[i];
  if (threadIdx.x < K + 2) idx[threadIdx.x] = idx_g[threadIdx.x];
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + warp;  // (tile, part, half)
  if (task >= n_tasks) return;  // the whole warp
  const int half = task & 1;
  const int b = (task >> 1) / parts;  // tile
  const int part = (task >> 1) - b * parts;
  const int by = b / nbx;
  const int bx = b - by * nbx;
  const int x = bx * kTileW + lane;
  const int y0 = by * kTileH + half * kPix;
  // the warp's rectangle: its half of the tile
  const float tx0 = (float)(bx * kTileW), tx1 = tx0 + (float)kTileW;
  const float ty0 = (float)y0, ty1 = ty0 + (float)kPix;
  const float px = (float)x + 0.5f;
  float py[kPix], first[kPix], rmin[kPix], rmax[kPix];
  int hxy[kPix];
  float slots[kPix][K];
#pragma unroll
  for (int r = 0; r < kPix; ++r) {
    const int o = (y0 + r) * img_w + x;
    py[r] = (float)(y0 + r) + 0.5f;
    first[r] = first_img[o] + 0.01f;
    rmin[r] = rmin_img[o];
    rmax[r] = rmax_img[o];
    // the hash's pixel terms: truncation of the pixel centre, wrapping
    // multiplies
    hxy[r] = (int)((unsigned)__float2int_rz(px) * 374761393u) ^
             (int)((unsigned)__float2int_rz(py[r]) * 668265263u);
#pragma unroll
    for (int s = 0; s < K; ++s) slots[r][s] = kEmpty;
  }
  float4* mine = &staged[warp][0][0];

  const int raw = counts[b];
  const bool full = raw > list_w;
  const int cnt = full ? n_chunks : raw;
  for (int j = part; j < cnt; j += parts) {
    const int ci = full ? j : lists[b * list_w + j];
    const float* box = boxes + ci * 4 * kTC;
    float bb[4][4];  // [group][x0 y0 x1 y1], all loads in flight at once
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < 4; ++r) bb[g][r] = box[r * kTC + g * 32 + lane];
    unsigned keep[4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      keep[g] = __ballot_sync(kAll, (bb[g][0] < tx1) & (bb[g][2] > tx0) &
                                        (bb[g][1] < ty1) & (bb[g][3] > ty0));
    const float* src = coef + ci * kRows * kTC;
    for (int g = 0; g < 4; ++g) {
      if (keep[g] == 0u) continue;
      if ((keep[g] >> lane) & 1u) {  // stage this lane at its rank
        const int l = g * 32 + lane;
        const int pos = __popc(keep[g] & ((1u << lane) - 1u));
        float v[16];
#pragma unroll
        for (int i = 0; i < 15; ++i) v[i] = src[i * kTC + l];
        v[15] = src[16 * kTC + l];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mine[q * 32 + pos] =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      }
      __syncwarp();
      const int ns = __popc(keep[g]);
      for (int s = 0; s < ns; ++s) {
        const float4 A = mine[s];       // c0x c0y c0z c1x
        const float4 B = mine[32 + s];  // c1y c1z c2x c2y
        const float4 C = mine[64 + s];  // c2z zcx zcy zcz
        const float4 D = mine[96 + s];  // wcx wcy wcz id
        const float x0 = A.x * px, x1 = A.w * px, x2 = B.z * px;
        const float xw = D.x * px;
        const int oid = __float2int_rz(D.w);
#pragma unroll
        for (int r = 0; r < kPix; ++r) {
          const float e0 = (x0 + A.y * py[r]) + A.z;
          const float e1 = (x1 + B.x * py[r]) + B.y;
          const float e2 = (x2 + B.w * py[r]) + C.x;
          const float wd = (xw + D.y * py[r]) + D.z;
          if (!((e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) &&
                (wd > 0.0f)))
            continue;
          // wd > 0 here: the 1 of wd == 0 never applies
          const float z = ((C.y * px + C.z * py[r]) + C.w) / wd;
          if (!((z >= 0.0f) && (z <= 1.0f))) continue;
          float esum = e0 + e1 + e2;
          esum = esum == 0.0f ? 1.0f : esum;
          const float vd = wd / esum;
          // first-layer discard and ray interval (ps.slang:65-85; rmax ==
          // 0 doubles as the request mask)
          if (!((vd > first[r]) && ((rmin[r] == 0.0f) || (vd >= rmin[r])) &&
                (rmax[r] != 0.0f) && (vd <= rmax[r])))
            continue;
          int hb = hxy[r] ^ (int)((unsigned)oid << 7);
          hb = (int)((unsigned)(hb ^ (hb >> 13)) * kGolden);
          hb = hb ^ (hb >> 16);
          const float rng = (float)key15_of(hb) * kInv32767;
          const int h2 = (hb ^ (int)((unsigned)oid * kGolden)) ^ (hb >> 5);
          const float rng2 = (float)key15_of(h2) * kInv32767;
          const int mask = coverage_mask<K>(ak, rng, rng2, lut, lut_n, idx);
#pragma unroll
          for (int q = 0; q < K; ++q)
            if ((mask >> q) & 1) slots[r][q] = fminf(slots[r][q], vd);
        }
      }
      __syncwarp();  // the lanes are done with this group's survivors
    }
  }
  const int plane = img_h * img_w;
#pragma unroll
  for (int r = 0; r < kPix; ++r) {
    const int o = (y0 + r) * img_w + x;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (parts == 1)
        out[q * plane + o] = slots[r][q];
      else if (slots[r][q] < kEmpty)
        atomicMin(reinterpret_cast<int*>(out) + q * plane + o,
                  __float_as_int(slots[r][q]));
    }
  }
}

template <int K>
void launch_sd(const float* coef, const float* boxes, const int* lists,
               const int* counts, const float* first, const float* rmin,
               const float* rmax, int n_chunks, int list_w, int nby, int nbx,
               int parts, float ak, const int* lut, int lut_n,
               const int* idx, float* out, cudaStream_t stream) {
  const int n_tasks = 2 * parts * nby * nbx;  // half tiles x parts
  raster_sd_kernel<K><<<(n_tasks + kWarps - 1) / kWarps, kWarps * 32, 0,
                        stream>>>(coef, boxes, lists, counts, first, rmin,
                                  rmax, n_chunks, list_w, n_tasks, parts,
                                  nbx, nbx * kTileW, nby * kTileH, ak, lut,
                                  lut_n, idx, out);
}

}  // namespace

// boxes: [n_chunks, 4, 128] per-triangle cull boxes (pack_tri_boxes);
// first / rmin / rmax: [nby*8, nbx*32] per-pixel floor and interval; ak =
// alpha * k; lut [lut_n] and idx [k + 2]: stratified_coverage_tables(k);
// out: [k, nby*8, nbx*32] slot minima (3e38 where empty), filled with 3e38
// beforehand where parts > 1; every size below 2^31 elements.
extern "C" int rtsdm_raster_stochastic(
    const float* coef, const float* boxes, const int* lists,
    const int* counts, const float* first, const float* rmin,
    const float* rmax, int n_chunks, int list_w, int nby, int nbx, int parts,
    int k, float ak, const int* lut, int lut_n, const int* idx, float* out,
    cudaStream_t stream) {
  if (lut_n > kMaxLut || parts < 1) return (int)cudaErrorInvalidValue;
  if (nby * nbx > 0) {
    switch (k) {
#define RTSDM_SD_CASE(KK)                                                   \
  case KK:                                                                  \
    launch_sd<KK>(coef, boxes, lists, counts, first, rmin, rmax, n_chunks,  \
                  list_w, nby, nbx, parts, ak, lut, lut_n, idx, out,        \
                  stream);                                                  \
    break;
      RTSDM_SD_CASE(1)
      RTSDM_SD_CASE(2)
      RTSDM_SD_CASE(3)
      RTSDM_SD_CASE(4)
      RTSDM_SD_CASE(5)
      RTSDM_SD_CASE(6)
      RTSDM_SD_CASE(7)
      RTSDM_SD_CASE(8)
#undef RTSDM_SD_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
