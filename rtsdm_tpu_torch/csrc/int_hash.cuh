// int32 hash helpers shared by the stochastic-depth kernels (K5, K9).
#pragma once

// floor mod 32767 of |hb| in int32 arithmetic, where |INT_MIN| wraps to
// INT_MIN (jnp.abs) and % is a floor mod (jnp's % on int32): the 15-bit
// key of K5's reservoir and the uniform draw of K9's fragments.
__device__ __forceinline__ int key15_of(int hb) {
  const int a = hb < 0 ? (int)(0u - (unsigned)hb) : hb;  // |INT_MIN| wraps
  const int r = a % 32767;
  return r < 0 ? r + 32767 : r;
}
