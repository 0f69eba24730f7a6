// Shared by the bounded warp kernels K7 (warp_matrix.cu) and K8
// (warp_field.cu): explicitly rounded float arithmetic (both), a defined
// float -> int conversion and the TPU kernels' tap-window rule for a
// two-tap linear interpolation (K7; every tap of a frame K8 warps lies
// inside the window).
//
// The TPU kernels resample a bounded residual as sums of 2 max_px + 2
// masked shifted views (pallas_warp_field.py:151-175, :394-411): with
// floor i and phase f, the (1 - f) tap is counted for i in
// [-max_px, max_px + 1] and the f tap for i in [-max_px - 1, max_px].
// Computing only the two live taps per pixel, with that rule, is the same
// function, including for pixels whose residual leaves the window.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace kcmc {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// int of a float clamped to +-lim (NaN -> lim): the value is only used
// where it is in range, and the conversion is then always defined.
__device__ __forceinline__ int clamp_int(float v, float lim) {
  return (int)(isnan(v) ? lim : fminf(fmaxf(v, -lim), lim));
}

// 0 + (1 - f) v0 + f v1 with each tap only inside its window
__device__ __forceinline__ float lerp(int i, float f, float v0, float v1,
                                      int mp) {
  const float a = (i >= -mp && i <= mp + 1) ? mul(sub(1.0f, f), v0) : 0.0f;
  const float b = (i >= -mp - 1 && i <= mp) ? mul(f, v1) : 0.0f;
  return add(a, b);
}

}  // namespace kcmc
