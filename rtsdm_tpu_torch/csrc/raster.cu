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
// gathers its winning triangle's row. Bounded by memory: the output rows
// are nearly all its bytes (rows of neighbouring pixels mostly hit the
// same triangles, so the table reads are served from L2). What the design
// does about it:
// * a block takes 256 consecutive pixels, whose output rows are one
//   contiguous region of 256 * ncout floats; each thread stages its row in
//   shared memory, and the block then writes the region as float4s in
//   address order, so every warp store is whole 128-byte lines (a thread
//   storing its own 48-byte row touched 32 sectors a warp store);
// * a thread reads its barycentrics as one float2 and, for the G-buffer's
//   (nci, nflat) = (8, 4) (a template: its 28-float row and 12 outputs
//   live in registers; 0.0441 against 0.0491 ms on the device at
//   SunTemple 1920x1080 for the run-time widths, H100 80GB HBM3 at
//   700 W), its row as seven float4s when the table is 16-byte aligned
//   (scalar loads otherwise) and stages its outputs as three float4s
//   (conflict-free: eight threads' 48-byte rows cover the 32 banks once);
//   other widths read and stage scalars.
//
// Both are built with --fmad=false and without fast math, so every
// expression rounds exactly like the plain PyTorch version in
// ops/raster_cuda.py.
#include <cuda_runtime.h>

#include <cstdint>

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

constexpr int kFetchPix = 256;   // K2's block: pixels, one a thread

// NCI > 0: (nci, nflat) = (NCI, NFLAT) at compile time; NCI = 0: at run
// time. vec: the table is 16-byte aligned (read as float4s when the row
// length is a multiple of 4).
template <int NCI, int NFLAT>
__global__ void __launch_bounds__(kFetchPix)
    fetch_attributes_kernel(const int* __restrict__ tri_id,
                            const float2* __restrict__ bary,
                            const float* __restrict__ table, int n_pix,
                            int nci, int nflat, bool vec,
                            float* __restrict__ out) {
  // the block's [kFetchPix, ncout] rows
  extern __shared__ __align__(16) float staged[];
  if (NCI > 0) nci = NCI, nflat = NFLAT;
  const int ncout = nci + nflat, nr = 3 * nci + nflat;
  const int first = blockIdx.x * kFetchPix;
  const int n_here = min(kFetchPix, n_pix - first);
  const int p = first + threadIdx.x;
  float* o = staged + threadIdx.x * ncout;
  if (threadIdx.x < n_here) {
    const int tid = tri_id[p];
    if constexpr (NCI > 0) {
      constexpr int kNr = 3 * NCI + NFLAT, kOut = NCI + NFLAT;
      float r[kOut];
      if (tid < 0) {
#pragma unroll
        for (int c = 0; c < kOut; ++c) r[c] = 0.0f;
      } else {
        const float2 b = bary[p];
        const float b0 = 1.0f - b.x - b.y;
        float a[kNr];
        const float* row = table + (size_t)tid * kNr;
        if (kNr % 4 == 0 && vec) {   // the row starts 16-byte aligned
#pragma unroll
          for (int j = 0; j < kNr / 4; ++j) {
            const float4 v = reinterpret_cast<const float4*>(row)[j];
            a[4 * j] = v.x, a[4 * j + 1] = v.y;
            a[4 * j + 2] = v.z, a[4 * j + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kNr; ++j) a[j] = row[j];
        }
#pragma unroll
        for (int i = 0; i < NCI; ++i)
          r[i] = b0 * a[3 * i] + b.x * a[3 * i + 1] + b.y * a[3 * i + 2];
#pragma unroll
        for (int f = 0; f < NFLAT; ++f) r[NCI + f] = a[3 * NCI + f];
      }
      if (kOut % 4 == 0) {
#pragma unroll
        for (int j = 0; j < kOut / 4; ++j)
          reinterpret_cast<float4*>(o)[j] =
              make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < kOut; ++c) o[c] = r[c];
      }
    } else if (tid < 0) {
      for (int c = 0; c < ncout; ++c) o[c] = 0.0f;
    } else {
      const float2 b = bary[p];
      const float b0 = 1.0f - b.x - b.y;
      const float* a = table + (size_t)tid * nr;
      for (int i = 0; i < nci; ++i)
        o[i] = b0 * a[3 * i] + b.x * a[3 * i + 1] + b.y * a[3 * i + 2];
      for (int f = 0; f < nflat; ++f) o[nci + f] = a[3 * nci + f];
    }
  }
  __syncthreads();
  // the block's region in address order: float4s (the region starts at a
  // multiple of 1024 bytes), then the last few floats of a partial block
  const int n_f = n_here * ncout;
  float* dst = out + (size_t)first * ncout;
  for (int j = threadIdx.x; j < n_f / 4; j += kFetchPix)
    reinterpret_cast<float4*>(dst)[j] =
        reinterpret_cast<const float4*>(staged)[j];
  for (int j = (n_f & ~3) + threadIdx.x; j < n_f; j += kFetchPix)
    dst[j] = staged[j];
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

// tri_id [n_pix]; bary [n_pix, 2] (8-byte aligned); table [T, 3 * nci +
// nflat]; out [n_pix, nci + nflat] (16-byte aligned); (nci + nflat) * 256
// floats within 48 KB of shared memory.
extern "C" int rtsdm_fetch_attributes(const int* tri_id, const float* bary,
                                      const float* table, int n_pix, int nci,
                                      int nflat, float* out,
                                      cudaStream_t stream) {
  if (n_pix > 0) {
    const int blocks = (n_pix + kFetchPix - 1) / kFetchPix;
    const size_t smem = (size_t)kFetchPix * (nci + nflat) * sizeof(float);
    const bool vec = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
    const float2* b = reinterpret_cast<const float2*>(bary);
    if (nci == 8 && nflat == 4)
      fetch_attributes_kernel<8, 4><<<blocks, kFetchPix, smem, stream>>>(
          tri_id, b, table, n_pix, nci, nflat, vec, out);
    else
      fetch_attributes_kernel<0, 0><<<blocks, kFetchPix, smem, stream>>>(
          tri_id, b, table, n_pix, nci, nflat, vec, out);
  }
  return (int)cudaGetLastError();
}
