// Visibility raster (K1) and G-buffer attribute fetch (K2).
//
// K1 replaces rtsdm_tpu/ops/raster_pallas.py:_raster_kernel (driver
// rasterize_pallas): a sort-middle closest-hit raster. Each block owns one
// 8x32-pixel tile (one thread per pixel) and walks the tile's ascending list
// of 128-triangle coefficient chunks, staging each 17x128 chunk in shared
// memory. Bounded by arithmetic: every visited chunk costs each pixel 128
// edge/depth evaluations (~30 flops each) read from shared memory as warp
// broadcasts, so the design keeps the chunk lists tight (screen-morton
// sorted triangles, per-tile chunk culling on the host) and keeps the
// running (z, id, b1, b2) in registers.
//
// Semantics follow the Pallas kernel exactly (raster_pallas.py:155-190):
// edge test e >= -1e-5 * (|e0| + |e1| + |e2|), wd > 0, 0 <= z <= 1 with
// z = zn / wd; within a chunk the lowest lane among equal minimal z wins;
// a later chunk replaces the running hit only when strictly closer. A tile
// whose chunk count exceeds the list width streams every chunk in order.
//
// K2 replaces rtsdm_tpu/ops/raster_pallas.py:_fetch_kernel (driver
// fetch_attributes_pallas). On the TPU it was a one-hot matrix product per
// chunk because the TPU has no gather; here it is one thread per pixel that
// gathers its winning triangle's row. Bounded by memory: one row read and
// one output row written per pixel; rows of neighbouring pixels mostly hit
// the same triangles, so the reads are served from L2.
//
// Both are built with --fmad=false and without fast math, so every
// expression rounds exactly like the plain PyTorch version in
// ops/raster_cuda.py.
#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kBlock = kTileH * kTileW;  // pixels per tile
constexpr int kTC = 128;                 // triangles per chunk
constexpr int kRows = 17;                // c0 c1 c2 zc wc (3 each), valid, id

struct Edge {
  float e0, e1, e2, zn, wd;
};

__device__ __forceinline__ Edge eval_edges(const float* tri, int l, float px,
                                           float py) {
  Edge r;
  r.e0 = tri[0 * kTC + l] * px + tri[1 * kTC + l] * py + tri[2 * kTC + l];
  r.e1 = tri[3 * kTC + l] * px + tri[4 * kTC + l] * py + tri[5 * kTC + l];
  r.e2 = tri[6 * kTC + l] * px + tri[7 * kTC + l] * py + tri[8 * kTC + l];
  r.zn = tri[9 * kTC + l] * px + tri[10 * kTC + l] * py + tri[11 * kTC + l];
  r.wd = tri[12 * kTC + l] * px + tri[13 * kTC + l] * py + tri[14 * kTC + l];
  return r;
}

__global__ void raster_blocks_kernel(const float* __restrict__ coef,
                                     const int* __restrict__ lists,
                                     const int* __restrict__ counts,
                                     int n_chunks, int list_w, int nbx,
                                     int img_w, float px0, float py0,
                                     float* __restrict__ z_out,
                                     int* __restrict__ id_out,
                                     float* __restrict__ b1_out,
                                     float* __restrict__ b2_out) {
  __shared__ float tri[kRows * kTC];
  const int b = blockIdx.x;
  const int by = b / nbx;
  const int bx = b - by * nbx;
  const int t = threadIdx.x;
  const int y = by * kTileH + t / kTileW;
  const int x = bx * kTileW + t % kTileW;
  const float px = (float)x + px0;
  const float py = (float)y + py0;

  const int raw = counts[b];
  const bool full = raw > list_w;
  const int cnt = full ? n_chunks : raw;

  float best_z = 1.0f, best_b1 = 0.0f, best_b2 = 0.0f;
  int best_id = -1;
  for (int j = 0; j < cnt; ++j) {
    const int ci = full ? j : lists[(size_t)b * list_w + j];
    const float* src = coef + (size_t)ci * kRows * kTC;
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = t; i < kRows * kTC; i += kBlock) tri[i] = src[i];
    __syncthreads();

    float zmin = 2.0f;
    int lane = -1;
    for (int l = 0; l < kTC; ++l) {
      const Edge e = eval_edges(tri, l, px, py);
      const float tol = -1e-5f * (fabsf(e.e0) + fabsf(e.e1) + fabsf(e.e2));
      bool inside = (e.e0 >= tol) && (e.e1 >= tol) && (e.e2 >= tol) &&
                    (e.wd > 0.0f) && (tri[15 * kTC + l] > 0.0f);
      const float z = e.zn / (e.wd == 0.0f ? 1.0f : e.wd);
      inside = inside && (z >= 0.0f) && (z <= 1.0f);
      if (inside && z < zmin) {  // strict: the lowest lane keeps a tie
        zmin = z;
        lane = l;
      }
    }
    if (zmin < best_z && zmin <= 1.0f) {
      const Edge e = eval_edges(tri, lane, px, py);
      float esum = e.e0 + e.e1 + e.e2;
      esum = esum == 0.0f ? 1.0f : esum;
      best_z = zmin;
      best_b1 = e.e1 / esum;
      best_b2 = e.e2 / esum;
      best_id = (int)tri[16 * kTC + lane];
    }
  }
  const size_t o = (size_t)y * img_w + x;
  z_out[o] = best_z;
  id_out[o] = best_id;
  b1_out[o] = best_b1;
  b2_out[o] = best_b2;
}

__global__ void fetch_attributes_kernel(const int* __restrict__ tri_id,
                                        const float* __restrict__ bary,
                                        const float* __restrict__ table,
                                        int n_pix, int nr, int nci, int nflat,
                                        float* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pix) return;
  const int ncout = nci + nflat;
  float* o = out + (size_t)p * ncout;
  const int tid = tri_id[p];
  if (tid < 0) {
    for (int c = 0; c < ncout; ++c) o[c] = 0.0f;
    return;
  }
  const float b1 = bary[2 * (size_t)p];
  const float b2 = bary[2 * (size_t)p + 1];
  const float b0 = 1.0f - b1 - b2;
  const float* a = table + (size_t)tid * nr;
  for (int i = 0; i < nci; ++i)
    o[i] = b0 * a[3 * i] + b1 * a[3 * i + 1] + b2 * a[3 * i + 2];
  for (int f = 0; f < nflat; ++f) o[nci + f] = a[3 * nci + f];
}

}  // namespace

extern "C" int rtsdm_raster_blocks(const float* coef, const int* lists,
                                   const int* counts, int n_chunks,
                                   int list_w, int nby, int nbx, float px0,
                                   float py0, float* z_out, int* id_out,
                                   float* b1_out, float* b2_out,
                                   cudaStream_t stream) {
  const int nb = nby * nbx;
  if (nb > 0)
    raster_blocks_kernel<<<nb, kBlock, 0, stream>>>(
        coef, lists, counts, n_chunks, list_w, nbx, nbx * kTileW, px0, py0,
        z_out, id_out, b1_out, b2_out);
  return (int)cudaGetLastError();
}

extern "C" int rtsdm_fetch_attributes(const int* tri_id, const float* bary,
                                      const float* table, int n_pix, int nr,
                                      int nci, int nflat, float* out,
                                      cudaStream_t stream) {
  const int threads = 256;
  if (n_pix > 0)
    fetch_attributes_kernel<<<(n_pix + threads - 1) / threads, threads, 0,
                              stream>>>(tri_id, bary, table, n_pix, nr, nci,
                                        nflat, out);
  return (int)cudaGetLastError();
}
