// Helpers shared by the stochastic-depth kernels (K5, K7, K9): the int32
// hash's floor mod and the stratified coverage mask.
#pragma once

constexpr float kInv32767 = (float)(1.0 / 32767.0);

// floor mod 32767 of |hb| in int32 arithmetic, where |INT_MIN| wraps to
// INT_MIN (jnp.abs) and % is a floor mod (jnp's % on int32): the 15-bit
// key of the SD trace's reservoir and the uniform draws of its coverage
// insertion and of K9's fragments.
__device__ __forceinline__ int key15_of(int hb) {
  const int a = hb < 0 ? (int)(0u - (unsigned)hb) : hb;  // |INT_MIN| wraps
  const int r = a % 32767;
  return r < 0 ? r + 32767 : r;
}

// utils/sampling.coverage_mask_select: floor(alpha*k + rng) set bits (ak =
// alpha * k rounded to float32, then a float32 add), the mask picked from
// the popcount group of stratified_coverage_tables(K) (lut, idx) by a
// truncated float32 product with rng2.
template <int K>
__device__ __forceinline__ int coverage_mask(float ak, float rng, float rng2,
                                             const int* lut, int lut_n,
                                             const int* idx) {
  const int r_cnt = min(max(__float2int_rz(floorf(ak + rng)), 0), K);
  if (r_cnt == 0) return 0;
  if (r_cnt >= K) return (1 << K) - 1;
  const int lo = idx[r_cnt], hi = idx[r_cnt + 1];
  const int sel = lo + __float2int_rz(rng2 * (float)(hi - lo));
  return (sel >= 0 && sel < lut_n) ? lut[sel] : 0;
}
