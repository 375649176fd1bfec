// Visibility raster (K1) and G-buffer attribute fetch (K2).
//
// K1 replaces rtsdm_tpu/ops/raster_pallas.py:_raster_kernel (driver
// rasterize_pallas): a sort-middle closest-hit raster over 8x32-pixel
// tiles, each walking its ascending list of 128-triangle coefficient
// chunks ([n_chunks, 17, 128]: c0 c1 c2 zc wc (3 each), valid, id; K9
// reads the same chunks).
//
// Bounded by operations: the pixel-triangle pairs it evaluates, about 20
// instructions each. What the design does about it:
// * per-triangle cull: each triangle's cull box comes in as its own
//   array [n_chunks, 4, 128] (x0, y0, x1, y1; ops/raster_cuda.py:
//   cull_boxes, invalid and padding lanes empty). At every visit a warp
//   tests the chunk's 128 boxes against its half tile (32 x 4 pixels), 32
//   lanes at a time, with the strict comparisons of build_chunk_lists_2d,
//   compacts the survivors in ascending lane order (ballot and popcount)
//   into shared memory, and evaluates only them; the loop over survivors
//   is uniform across the warp. Exact: a cull box encloses every point of
//   the padded image at which this kernel's float32 fragment test can
//   accept the triangle (it is computed from the edge functions with a
//   bound on the tolerance and on their rounding, and never clipped to the
//   viewport), so every pixel centre of a rectangle that misses the box
//   rejects the triangle, padding pixels included. A near-degenerate
//   triangle, whose accepted points need not lie near its vertices, gets
//   the whole plane. tests/test_torch_raster.py holds the plain raster
//   restricted to the survivors equal to the unrestricted one;
// * a staged survivor is four float4 (c0x c0y c0z c1x | c1y c1z c2x c2y |
//   c2z zcx zcy zcz | wcx wcy wcz id), read as warp broadcasts;
// * each thread owns one column of four rows of the tile (a warp owns half
//   a tile), so the x products of each plane serve four pixels;
// * the edges, their tolerance and wd > 0 are tested first; the depth
//   plane, z = zn / wd, the range test and the floor's divide follow only
//   for a fragment that passes;
// * warps work alone (no block barrier): both halves of a tile run in one
//   block, so a chunk's second read hits L1.
//
// Semantics follow the Pallas kernel exactly (raster_pallas.py:155-190):
// edge test e >= -1e-5 * (|e0| + |e1| + |e2|), wd > 0, 0 <= z <= 1 with
// z = zn / wd; within a chunk the lowest lane among equal minimal z wins;
// a later chunk replaces the running hit only when strictly closer (one
// running minimum with a strict comparison, in visit and lane order, is
// the same rule). A tile whose chunk count exceeds the list width streams
// every chunk in order. With a depth floor (depth peeling,
// raster_pallas.py:139-141, :172-174) a fragment is kept only if its
// linear view depth wd / esum (esum = e0 + e1 + e2, 1 where it is 0)
// exceeds floor + min_separation at its pixel; the floor is a pointer that
// is null for the plain raster, and a template parameter of the kernel.
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
constexpr int kTC = 128;        // triangles per chunk
constexpr int kRows = 17;       // c0 c1 c2 zc wc (3 each), valid, id
constexpr int kPix = 4;         // rows of a tile per thread (half a tile)
constexpr int kWarps = 4;       // warps per block, two tiles
constexpr unsigned kAll = 0xffffffffu;

template <bool FLOOR>
__global__ void raster_blocks_kernel(const float* __restrict__ coef,
                                     const float* __restrict__ boxes,
                                     const int* __restrict__ lists,
                                     const int* __restrict__ counts,
                                     int n_chunks, int list_w, int n_tasks,
                                     int nbx, int img_w, float px0,
                                     float py0,
                                     const float* __restrict__ floor_img,
                                     float min_sep,
                                     float* __restrict__ z_out,
                                     int* __restrict__ id_out,
                                     float* __restrict__ b1_out,
                                     float* __restrict__ b2_out) {
  __shared__ float4 staged[kWarps][4][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarps + warp;
  if (task >= n_tasks) return;  // the whole warp
  const int b = task >> 1;      // tile
  const int by = b / nbx;
  const int bx = b - by * nbx;
  const int x = bx * kTileW + lane;
  const int y0 = by * kTileH + (task & 1) * kPix;
  // the warp's rectangle: its half of the tile
  const float tx0 = (float)(bx * kTileW), tx1 = tx0 + (float)kTileW;
  const float ty0 = (float)y0, ty1 = ty0 + (float)kPix;
  const float px = (float)x + px0;
  float py[kPix], fl[kPix], best_z[kPix], best_b1[kPix], best_b2[kPix];
  int best_id[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    py[k] = (float)(y0 + k) + py0;
    fl[k] = FLOOR ? floor_img[(y0 + k) * img_w + x] + min_sep : 0.0f;
    best_z[k] = 1.0f;
    best_b1[k] = 0.0f;
    best_b2[k] = 0.0f;
    best_id[k] = -1;
  }
  float4* mine = &staged[warp][0][0];

  const int raw = counts[b];
  const bool full = raw > list_w;
  const int cnt = full ? n_chunks : raw;
  for (int j = 0; j < cnt; ++j) {
    const int ci = full ? j : lists[(size_t)b * list_w + j];
    const float* box = boxes + (size_t)ci * 4 * kTC;
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
    const float* src = coef + (size_t)ci * kRows * kTC;
    for (int g = 0; g < 4; ++g) {
      if (keep[g] == 0u) continue;
      if ((keep[g] >> lane) & 1u) {  // stage this lane at its rank
        const int l = g * 32 + lane;
        const int pos = __popc(keep[g] & ((1u << lane) - 1u));
        float r[16];
#pragma unroll
        for (int i = 0; i < 15; ++i) r[i] = src[i * kTC + l];
        r[15] = src[16 * kTC + l];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          mine[q * 32 + pos] =
              make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
      }
      __syncwarp();
      const int ns = __popc(keep[g]);
      for (int s = 0; s < ns; ++s) {
        const float4 A = mine[s];           // c0x c0y c0z c1x
        const float4 B = mine[32 + s];      // c1y c1z c2x c2y
        const float4 C = mine[64 + s];      // c2z zcx zcy zcz
        const float4 D = mine[96 + s];      // wcx wcy wcz id
        const float x0 = A.x * px, x1 = A.w * px, x2 = B.z * px;
        const float xw = D.x * px;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          const float e0 = (x0 + A.y * py[k]) + A.z;
          const float e1 = (x1 + B.x * py[k]) + B.y;
          const float e2 = (x2 + B.w * py[k]) + C.x;
          const float wd = (xw + D.y * py[k]) + D.z;
          const float tol = -1e-5f * (fabsf(e0) + fabsf(e1) + fabsf(e2));
          if (e0 >= tol && e1 >= tol && e2 >= tol && wd > 0.0f) {
            const float z = ((C.y * px + C.z * py[k]) + C.w) / wd;
            if (z >= 0.0f && z < best_z[k]) {  // strict: the first keeps a tie
              float esum = e0 + e1 + e2;
              esum = esum == 0.0f ? 1.0f : esum;
              if (!FLOOR || wd / esum > fl[k]) {
                best_z[k] = z;
                best_b1[k] = e1 / esum;
                best_b2[k] = e2 / esum;
                best_id[k] = (int)D.w;
              }
            }
          }
        }
      }
      __syncwarp();  // the lanes are done with this group's survivors
    }
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const size_t o = (size_t)(y0 + k) * img_w + x;
    z_out[o] = best_z[k];
    id_out[o] = best_id[k];
    b1_out[o] = best_b1[k];
    b2_out[o] = best_b2[k];
  }
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

// boxes: [n_chunks, 4, 128] per-triangle screen boxes (pack_tri_boxes).
// floor_img: null, or the [nby*8, nbx*32] linear-depth floor (padding
// pixels hold 3e38).
extern "C" int rtsdm_raster_blocks(const float* coef, const float* boxes,
                                   const int* lists, const int* counts,
                                   int n_chunks, int list_w, int nby,
                                   int nbx, float px0, float py0,
                                   const float* floor_img, float min_sep,
                                   float* z_out, int* id_out, float* b1_out,
                                   float* b2_out, cudaStream_t stream) {
  const int n_tasks = 2 * nby * nbx;  // half tiles, one per warp
  const int blocks = (n_tasks + kWarps - 1) / kWarps;
  if (n_tasks > 0) {
    if (floor_img != nullptr)
      raster_blocks_kernel<true><<<blocks, kWarps * 32, 0, stream>>>(
          coef, boxes, lists, counts, n_chunks, list_w, n_tasks, nbx,
          nbx * kTileW, px0, py0, floor_img, min_sep, z_out, id_out, b1_out,
          b2_out);
    else
      raster_blocks_kernel<false><<<blocks, kWarps * 32, 0, stream>>>(
          coef, boxes, lists, counts, n_chunks, list_w, n_tasks, nbx,
          nbx * kTileW, px0, py0, floor_img, min_sep, z_out, id_out, b1_out,
          b2_out);
  }
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
