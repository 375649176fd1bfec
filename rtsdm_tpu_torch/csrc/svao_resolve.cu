// SVAO phase 2's per-direction resolve (K12, wrapper
// ops/resolve_cuda.svao_resolve).
//
// K12 replaces no TPU kernel: the JAX package resolves phase 2 with XLA
// code (rtsdm_tpu/passes/svao_shift.py, the direction loop of
// svao_phase2_shift over _sample_dir_q and _sd_eval_deint). In PyTorch
// that loop is about 270 elementwise launches a ring direction, each
// waiting on the host; it stays as K12's contract
// (passes/svao_shift.svao_resolve_plain). For every texel (class c,
// quarter texel q) of the [16, qh, qw] deinterleaved planes and every ring
// direction d of the launch, in order, one thread computes the quantized
// radius level and sample offset, the sphere slab, the visibility of K3's
// fetched depth, the k stochastic-depth samples' visibility (K4's 16-bit
// pairs at divisor 4, up to 16 directions a launch; K11's float slots at
// divisors 1 and 2, one direction a launch), and adds vis - old_vis where
// stencil bit d is set; delta_out = delta_in (0 when absent) + the
// launch's directions' corrections, summed in direction order.
//
// Bounded by memory: each setup plane, K3 plane, SD value, stencil and
// delta texel is read or written once, and the few dozen float operations
// a direction take far less than the bytes. Threads run over the texels in
// address order (every read of a warp a 128-byte line). The ring's
// constants (per direction, the level bounds and radii, the SD jitter)
// travel in the launch's arguments, so a frame neither uploads nor keeps
// a table; a block copies them to shared memory.
//
// The same result bit for bit as the plain loop on the card: the build
// keeps --fmad=false; every expression is written in the loop's operation
// order, one rounding per PyTorch operation; the host hands over each
// constant the loop passes PyTorch as a Python number, rounded to float32
// as PyTorch rounds it (sin and cos of the direction angle, the class
// screen directions, the level radii from the host's exp, HBAO's pdf,
// 1 + thickness, radius^2; a literal of the loop is cast from double here
// as PyTorch casts it); true_div is an IEEE division; the loop's
// division by float(divisor) is PyTorch's multiply by the reciprocal;
// clamp, minimum and maximum pass a NaN on as PyTorch's kernels do.
#include <cuda_runtime.h>

#include <cstddef>

constexpr int kMaxBounds = 63;      // rtsdm_tpu_torch/ops/resolve_cuda.py
constexpr int kMaxLaunchDirs = 16;  // directions a launch: the arguments
                                    // stay within 4 KB
constexpr int kDirConsts = 36;      // sin, cos, radius fraction, HBAO pdf,
                                    // the 16 classes' screen x, then y

// Arguments, as ops/resolve_cuda.ResolveArgs lays them out. The setup
// planes, K3's planes, the stencil and delta are [16, qh, qw] slices;
// sx, sy, depth_range and near_z 0-d device tensors. The ring's constants
// travel in the launch's arguments, not in device memory.
struct ResolveArgs {
  const float* radius_px;
  const float* radius;
  const float* pos_len;
  const float* ax;
  const float* ay;
  const float* az;
  const float* nox;
  const float* noy;
  const float* noz;
  const float* px;       // HBAO only
  const float* py;
  const float* pz;
  const float* nx;
  const float* ny;
  const float* nz;
  const float* fetched;  // K3's [nd, 16, qh, qw]
  const void* sd;        // direction d0's SD values (int32 or float)
  const int* stencil;
  const float* delta_in;  // null: 0
  float* delta_out;
  const float* sx;
  const float* sy;
  const float* depth_range;
  const float* near_z;
  int d0, d1;            // the launch's directions, at most kMaxLaunchDirs
  int k;                 // SD samples a texel
  int sd_dir_stride;     // elements from one direction's SD values to the
  int sd_class_stride;   // next's, and from one class's to the next's
  int n_levels, qh, qw;
  int w, h, low_w, low_h;
  float thick1;          // 1 + thickness
  float radius2;         // radius^2 (HBAO)
  float inv_divisor;     // 1 / stochMapDivisor
  float jitter[32];      // [4, 4, 2] (x, y) by (qy % 4, qx % 4)
  float bounds[kMaxBounds];           // n_levels - 1, ascending
  float level_radius[kMaxBounds + 1];  // n_levels
  float dir_consts[kMaxLaunchDirs * kDirConsts];  // directions d0..d1 - 1
};

// ResolveArgs' size, then each field's offset in the order above, into
// out[0..n): the wrapper holds ops/resolve_cuda.ResolveArgs to it when it
// builds a launch's arguments. Returns the number of fields.
#define OFF(f) offsetof(ResolveArgs, f)
extern "C" int rtsdm_svao_resolve_layout(long long* out, int n) {
  const size_t layout[] = {
      sizeof(ResolveArgs), OFF(radius_px), OFF(radius), OFF(pos_len), OFF(ax),
      OFF(ay), OFF(az), OFF(nox), OFF(noy), OFF(noz), OFF(px), OFF(py),
      OFF(pz), OFF(nx), OFF(ny), OFF(nz), OFF(fetched), OFF(sd), OFF(stencil),
      OFF(delta_in), OFF(delta_out), OFF(sx), OFF(sy), OFF(depth_range),
      OFF(near_z), OFF(d0), OFF(d1), OFF(k), OFF(sd_dir_stride),
      OFF(sd_class_stride), OFF(n_levels), OFF(qh), OFF(qw), OFF(w), OFF(h),
      OFF(low_w), OFF(low_h), OFF(thick1), OFF(radius2), OFF(inv_divisor),
      OFF(jitter), OFF(bounds), OFF(level_radius), OFF(dir_consts)};
  const int m = static_cast<int>(sizeof(layout) / sizeof(layout[0]));
  for (int i = 0; i < m && i < n; ++i)
    out[i] = static_cast<long long>(layout[i]);
  return m - 1;
}
#undef OFF

namespace {

constexpr int kThreads = 256;

// the loop's literals as PyTorch rounds a Python number to float32
constexpr float kRadiusPxMin = static_cast<float>(1e-4);
constexpr float kDiscMax = static_cast<float>(0.999);
constexpr float kTiny = static_cast<float>(1e-12);
constexpr float kNonzero = static_cast<float>(1e-4);
constexpr float kNdotvBias = static_cast<float>(0.1);

// PyTorch's CUDA kernels: clamp and its one-sided forms return a NaN input
// as it is (torch.clamp's bounds, tensors or numbers, go through fmaxf and
// then fminf); minimum and maximum return a NaN operand (a != a)
__device__ __forceinline__ float clamp_min_(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp_max_(float v, float hi) {
  return v != v ? v : fminf(v, hi);
}
__device__ __forceinline__ float clamp_(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float minimum_(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
__device__ __forceinline__ float maximum_(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}

// #{b : r > bounds[b]} of n_b <= 63 ascending bounds (K3's level_of):
// r > bounds[b] holds for a prefix of them (for none when r is NaN)
__device__ __forceinline__ int level_of(float r, const float* sb, int n_b) {
  int lvl = 0;
  for (int step = 32; step > 0; step >>= 1) {
    const int i = lvl + step;
    if (i <= n_b && r > sb[i - 1]) lvl = i;
  }
  return lvl;
}

// the texel's setup planes
struct Texel {
  float radius, pos_len, ax, ay, az, px, py, pz, nx, ny, nz;
};

// the depth-affine coefficients of a sample through screen point (cx, cy)
// (svao_shift._sample_coeffs)
struct Coeffs {
  float oz_a, qa, qb, na, np_;
};

template <bool kVao>
__device__ __forceinline__ Coeffs sample_coeffs(const Texel& p, float cx,
                                                float cy) {
  Coeffs co;
  co.oz_a = cx * p.ax + cy * p.ay - p.az;
  if (!kVao) {
    co.qa = cx * cx + cy * cy + 1.0f;
    co.qb = -2.0f * (cx * p.px + cy * p.py - p.pz);
    co.na = p.nx * cx + p.ny * cy - p.nz;
    co.np_ = p.nx * p.px + p.ny * p.py + p.nz * p.pz;
  }
  return co;
}

// calcVisibility (svao_shift._visibility_vao)
__device__ __forceinline__ float visibility_vao(float oz, float s_start,
                                                float s_end, float pdf,
                                                float radius, float thick1) {
  const float sphere = clamp_min_(s_start - maximum_(s_end, oz), 0.0f) / pdf;
  const float halo = clamp_((oz - thick1 * radius) / s_start, 0.0f, 1.0f) *
                     (s_start - s_end) / pdf;
  return sphere + halo;
}

// HBAOKernel through the affine coefficients (svao_shift._hbao_affine)
__device__ __forceinline__ float hbao_affine(const Coeffs& co, float z,
                                             float pos_len, float pdf,
                                             float radius2) {
  const float vv =
      clamp_min_((z * co.qa + co.qb) * z + pos_len * pos_len, kTiny);
  const float ndotv = (z * co.na - co.np_) / sqrtf(vv);
  const float angle = clamp_(ndotv - kNdotvBias, 0.0f, 1.0f);
  const float dist = clamp_(1.0f - vv / radius2, 0.0f, 1.0f);
  return clamp_(angle * dist / pdf, 0.0f, 1.0f);
}

// the visibility of depth z at a sample (svao_shift._eval_depth_affine)
template <bool kVao>
__device__ __forceinline__ float eval_depth(const Texel& p, const Coeffs& co,
                                            float z, float s_start,
                                            float s_end, float pdf,
                                            float thick1, float radius2) {
  if (kVao)
    return visibility_vao(z * co.oz_a + p.pos_len, s_start, s_end, pdf,
                          p.radius, thick1);
  return hbao_affine(co, z, p.pos_len, pdf, radius2);
}

// kPacked: K4's planes, layer j in the 16 bits (j % 2) of int32 plane
// j / 2, over 65535 (ops/fetch_cuda.unpack_sd16); else K11's float slots
template <bool kVao, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    svao_resolve_kernel(const __grid_constant__ ResolveArgs a) {
  __shared__ float sb[kMaxBounds];
  __shared__ float slr[kMaxBounds + 1];
  __shared__ float sdir[kMaxLaunchDirs * kDirConsts];
  const int nd = a.d1 - a.d0;
  const int n_b = a.n_levels - 1;
  for (int i = threadIdx.x; i < n_b; i += kThreads) sb[i] = a.bounds[i];
  for (int i = threadIdx.x; i < a.n_levels; i += kThreads)
    slr[i] = a.level_radius[i];
  for (int i = threadIdx.x; i < nd * kDirConsts; i += kThreads)
    sdir[i] = a.dir_consts[i];
  __syncthreads();
  const int plane = a.qh * a.qw;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= 16 * plane) return;
  const int c = t / plane;
  const int q = t - c * plane;
  const int qy = q / a.qw;
  const int qx = q - qy * a.qw;

  Texel p;
  const float radius_px = a.radius_px[t];
  p.radius = a.radius[t];
  p.pos_len = a.pos_len[t];
  p.ax = a.ax[t];
  p.ay = a.ay[t];
  p.az = a.az[t];
  if (!kVao) {
    p.px = a.px[t];
    p.py = a.py[t];
    p.pz = a.pz[t];
    p.nx = a.nx[t];
    p.ny = a.ny[t];
    p.nz = a.nz[t];
  }
  const float nox = a.nox[t], noy = a.noy[t], noz = a.noz[t];
  const int stencil = a.stencil[t];
  const float sx = *a.sx, sy = *a.sy;
  const float depth_range = *a.depth_range, near_z = *a.near_z;
  // full-res pixel of the texel (svao_shift._class_grids) and its SD
  // jitter (utils/sampling.jitter_grid: the 4x4 table by quarter texel)
  const float xg = (float)(4 * qx + (c & 3));
  const float yg = (float)(4 * qy + (c >> 2));
  const int jit = ((qy & 3) * 4 + (qx & 3)) * 2;
  const float jqx = a.jitter[jit], jqy = a.jitter[jit + 1];
  // the loop's per-direction terms that depend on the texel alone
  const float rpx_safe = clamp_min_(radius_px, kRadiusPxMin);
  const float radius_sq = p.radius * p.radius;
  const float noz_a = clamp_min_(fabsf(noz), kNonzero);   // make_nonzero
  const float noz_nz = noz >= 0.0f ? noz_a : -noz_a;

  float delta = a.delta_in != nullptr ? a.delta_in[t] : 0.0f;
  for (int d = a.d0; d < a.d1; ++d) {
    const float* dc = sdir + (d - a.d0) * kDirConsts;
    // _sample_dir_q: the quantized radius and the sample's shift
    const float r_eff = slr[level_of(radius_px * dc[2], sb, n_b)];
    const float off_x = nearbyintf(r_eff * dc[4 + c]);
    const float off_y = nearbyintf(r_eff * dc[20 + c]);
    const float r_disc = clamp_max_(r_eff / rpx_safe, kDiscMax) * p.radius;
    const float sxp = xg + off_x;
    const float syp = yg + off_y;
    const bool in_screen = sxp >= 0.0f && sxp < (float)a.w &&
                           syp >= 0.0f && syp < (float)a.h;
    const float uqx = (clamp_(sxp, 0.0f, (float)(a.w - 1)) + 0.5f) /
                      (float)a.w;
    const float uqy = (clamp_(syp, 0.0f, (float)(a.h - 1)) + 0.5f) /
                      (float)a.h;
    const float sphere_h =
        sqrtf(clamp_min_(radius_sq - r_disc * r_disc, kTiny));
    const float pdf = kVao ? 2.0f * sphere_h : dc[3];
    const float dxy_x = r_disc * dc[0];
    const float dxy_y = r_disc * dc[1];
    const float z_int = -(dxy_x * nox + dxy_y * noy) / noz_nz;
    // torch.clamp(z_int, min=-sphere_h, max=sphere_h)
    const float s_end =
        z_int != z_int ? z_int : fminf(fmaxf(z_int, -sphere_h), sphere_h);
    const float cx = (2.0f * uqx - 1.0f) * sx;
    const float cy = (1.0f - 2.0f * uqy) * sy;
    const Coeffs co = sample_coeffs<kVao>(p, cx, cy);
    const float z = a.fetched[d * 16 * plane + t];
    const float old_vis = eval_depth<kVao>(p, co, z, sphere_h, s_end, pdf,
                                           a.thick1, a.radius2);
    float vis = in_screen ? old_vis : (kVao ? 1.0f : 0.0f);

    // _sd_eval_deint: the SD texel's jittered screen point, k samples
    const float tex_x = floorf((xg + off_x) * a.inv_divisor);
    const float tex_y = floorf((yg + off_y) * a.inv_divisor);
    const float suv_x = (tex_x + jqx) / (float)a.low_w;
    const float suv_y = (tex_y + jqy) / (float)a.low_h;
    const float cxs = (2.0f * suv_x - 1.0f) * sx;
    const float cys = (1.0f - 2.0f * suv_y) * sy;
    const Coeffs cos_ = sample_coeffs<kVao>(p, cxs, cys);
    const int sd_at =
        (d - a.d0) * a.sd_dir_stride + c * a.sd_class_stride + q;
    float vis_sd = 0.0f;
    for (int j = 0; j < a.k; ++j) {
      float sd_val;
      if (kPacked) {
        const int pk =
            static_cast<const int*>(a.sd)[sd_at + (j >> 1) * plane];
        const int field = (j & 1) ? ((pk >> 16) & 0xFFFF) : (pk & 0xFFFF);
        sd_val = (float)field / 65535.0f;
      } else {
        sd_val = static_cast<const float*>(a.sd)[sd_at + j * plane];
      }
      const float lin = sd_val * depth_range + near_z;
      float v;
      if (kVao) {
        v = visibility_vao(lin * cos_.oz_a + p.pos_len, sphere_h, s_end, pdf,
                           p.radius, a.thick1);
        vis_sd = j == 0 ? v : minimum_(vis_sd, v);
      } else {
        v = hbao_affine(cos_, lin, p.pos_len, pdf, a.radius2);
        vis_sd = j == 0 ? v : maximum_(vis_sd, v);
      }
    }
    vis = kVao ? minimum_(vis, vis_sd) : maximum_(vis, vis_sd);
    // (stencil >> d) & 1 as PyTorch shifts an int32: by 31 at most
    const int bit = (stencil >> (d < 31 ? d : 31)) & 1;
    delta = delta + (bit ? vis - old_vis : 0.0f);
  }
  a.delta_out[t] = delta;
}

template <bool kVao>
void launch_resolve(const ResolveArgs& a, bool packed, int blocks,
                    cudaStream_t stream) {
  if (packed)
    svao_resolve_kernel<kVao, true><<<blocks, kThreads, 0, stream>>>(a);
  else
    svao_resolve_kernel<kVao, false><<<blocks, kThreads, 0, stream>>>(a);
}

}  // namespace

// args as ResolveArgs above; vao 1 for the VAO kernel, 0 for HBAO; packed 1
// for K4's int32 pairs, 0 for float slots. n_levels - 1 <= 63, d1 - d0 <=
// 16, every size below 2^31 elements.
extern "C" int rtsdm_svao_resolve(const ResolveArgs* args, int vao,
                                  int packed, cudaStream_t stream) {
  const ResolveArgs a = *args;
  const int n = 16 * a.qh * a.qw;
  if (n > 0 && a.d1 > a.d0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    if (vao)
      launch_resolve<true>(a, packed != 0, blocks, stream);
    else
      launch_resolve<false>(a, packed != 0, blocks, stream);
  }
  return (int)cudaGetLastError();
}
