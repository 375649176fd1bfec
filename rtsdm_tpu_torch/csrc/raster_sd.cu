// k-slot stochastic-depth raster (K9).
//
// Replaces rtsdm_tpu/ops/raster_pallas.py:_raster_sd_kernel (driver
// raster_stochastic_pallas), the raster stochastic depth map of the
// reference StochasticDepthMap (StochasticDepth.ps.slang): every fragment
// behind the first depth layer and inside the per-pixel ray interval
// writes its linear view depth into a pseudo-random subset of the k slots
// (a stratified coverage mask), and each slot keeps its minimum.
//
// Same skeleton as K1 (raster.cu): each block owns one 8x32-pixel tile (one
// thread per pixel) and walks the tile's ascending list of 128-triangle
// coefficient chunks (every chunk when the list overflowed), staging each
// 17x128 chunk in shared memory; the k slot minima live in registers (K is
// a template parameter). Bounded by arithmetic: a visited chunk costs each
// pixel 128 edge/depth evaluations; the tail (view depth, interval tests,
// hash, mask) runs only for fragments inside the triangle.
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
constexpr int kBlock = kTileH * kTileW;  // pixels per tile
constexpr int kTC = 128;                 // triangles per chunk
constexpr int kRows = 17;                // c0 c1 c2 zc wc (3 each), valid, id
constexpr int kMaxLut = 256;             // 2^k masks for k <= 8
constexpr float kEmpty = 3e38f;
constexpr unsigned kGolden = 0x9E3779B1u;

template <int K>
__global__ void raster_sd_kernel(
    const float* __restrict__ coef, const int* __restrict__ lists,
    const int* __restrict__ counts, const float* __restrict__ first_img,
    const float* __restrict__ rmin_img, const float* __restrict__ rmax_img,
    int n_chunks, int list_w, int nbx, int img_w, int img_h, float ak,
    const int* __restrict__ lut_g, int lut_n, const int* __restrict__ idx_g,
    float* __restrict__ out) {
  __shared__ float tri[kRows * kTC];
  __shared__ int lut[kMaxLut];
  __shared__ int idx[K + 2];
  const int b = blockIdx.x;
  const int by = b / nbx;
  const int bx = b - by * nbx;
  const int t = threadIdx.x;
  for (int i = t; i < lut_n; i += kBlock) lut[i] = lut_g[i];
  if (t < K + 2) idx[t] = idx_g[t];
  const int y = by * kTileH + t / kTileW;
  const int x = bx * kTileW + t % kTileW;
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const size_t o = (size_t)y * img_w + x;
  const float first = first_img[o] + 0.01f;
  const float rmin = rmin_img[o];
  const float rmax = rmax_img[o];
  // the hash's pixel terms: truncation of the pixel centre, wrapping
  // multiplies
  const int hxy = (int)((unsigned)__float2int_rz(px) * 374761393u) ^
                  (int)((unsigned)__float2int_rz(py) * 668265263u);

  float slots[K];
#pragma unroll
  for (int s = 0; s < K; ++s) slots[s] = kEmpty;

  const int raw = counts[b];
  const bool full = raw > list_w;
  const int cnt = full ? n_chunks : raw;
  for (int j = 0; j < cnt; ++j) {
    const int ci = full ? j : lists[(size_t)b * list_w + j];
    const float* src = coef + (size_t)ci * kRows * kTC;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = t; i < kRows * kTC; i += kBlock) tri[i] = src[i];
    __syncthreads();

    for (int l = 0; l < kTC; ++l) {
      const float e0 = tri[0 * kTC + l] * px + tri[1 * kTC + l] * py +
                       tri[2 * kTC + l];
      const float e1 = tri[3 * kTC + l] * px + tri[4 * kTC + l] * py +
                       tri[5 * kTC + l];
      const float e2 = tri[6 * kTC + l] * px + tri[7 * kTC + l] * py +
                       tri[8 * kTC + l];
      const float wd = tri[12 * kTC + l] * px + tri[13 * kTC + l] * py +
                       tri[14 * kTC + l];
      if (!((e0 >= 0.0f) && (e1 >= 0.0f) && (e2 >= 0.0f) && (wd > 0.0f) &&
            (tri[15 * kTC + l] > 0.0f)))
        continue;
      const float zn = tri[9 * kTC + l] * px + tri[10 * kTC + l] * py +
                       tri[11 * kTC + l];
      const float z = zn / wd;  // wd > 0 here: the 1 of wd == 0 never applies
      if (!((z >= 0.0f) && (z <= 1.0f))) continue;
      float esum = e0 + e1 + e2;
      esum = esum == 0.0f ? 1.0f : esum;
      const float vd = wd / esum;
      // first-layer discard and ray interval (ps.slang:65-85; rmax == 0
      // doubles as the request mask)
      if (!((vd > first) && ((rmin == 0.0f) || (vd >= rmin)) &&
            (rmax != 0.0f) && (vd <= rmax)))
        continue;

      const int oid = __float2int_rz(tri[16 * kTC + l]);
      int hb = hxy ^ (int)((unsigned)oid << 7);
      hb = (int)((unsigned)(hb ^ (hb >> 13)) * kGolden);
      hb = hb ^ (hb >> 16);
      const float rng = (float)key15_of(hb) * kInv32767;
      const int h2 = (hb ^ (int)((unsigned)oid * kGolden)) ^ (hb >> 5);
      const float rng2 = (float)key15_of(h2) * kInv32767;
      const int mask = coverage_mask<K>(ak, rng, rng2, lut, lut_n, idx);
#pragma unroll
      for (int s = 0; s < K; ++s)
        if ((mask >> s) & 1) slots[s] = fminf(slots[s], vd);
    }
  }
  const size_t plane = (size_t)img_h * img_w;
#pragma unroll
  for (int s = 0; s < K; ++s) out[s * plane + o] = slots[s];
}

template <int K>
void launch_sd(const float* coef, const int* lists, const int* counts,
               const float* first, const float* rmin, const float* rmax,
               int n_chunks, int list_w, int nby, int nbx, float ak,
               const int* lut, int lut_n, const int* idx, float* out,
               cudaStream_t stream) {
  raster_sd_kernel<K><<<nby * nbx, kBlock, 0, stream>>>(
      coef, lists, counts, first, rmin, rmax, n_chunks, list_w, nbx,
      nbx * kTileW, nby * kTileH, ak, lut, lut_n, idx, out);
}

}  // namespace

// first / rmin / rmax: [nby*8, nbx*32] per-pixel floor and interval; ak =
// alpha * k; lut [lut_n] and idx [k + 2]: stratified_coverage_tables(k);
// out: [k, nby*8, nbx*32] slot minima (3e38 where empty).
extern "C" int rtsdm_raster_stochastic(
    const float* coef, const int* lists, const int* counts,
    const float* first, const float* rmin, const float* rmax, int n_chunks,
    int list_w, int nby, int nbx, int k, float ak, const int* lut,
    int lut_n, const int* idx, float* out, cudaStream_t stream) {
  if (lut_n > kMaxLut) return (int)cudaErrorInvalidValue;
  if (nby * nbx > 0) {
    switch (k) {
#define RTSDM_SD_CASE(KK)                                                  \
  case KK:                                                                 \
    launch_sd<KK>(coef, lists, counts, first, rmin, rmax, n_chunks, list_w, \
                  nby, nbx, ak, lut, lut_n, idx, out, stream);             \
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
