// K7 warp_batch_matrix: affine/projective warp of a frame batch with one
// bilinear interpolation, computed directly per output pixel.
//
// Replaces kcmc_tpu/ops/pallas_warp_field.py::warp_batch_matrix_pallas
// (_make_matrix_kernel, pallas_warp_field.py:323/:425). The TPU kernel
// rolls a VMEM window of each row strip by the integer centre shift,
// builds a canvas of x-resampled rows (x-phase taken at each canvas row's
// consumer, two fixed-point iterations) as a sum of 2 max_px + 2 masked
// shifted views, then y-resamples it the same way. Here each output pixel
// (x, y) computes only what it reads:
//   * the source map s(x, y), residual (ux, uy) = s - (x, y) - (tcx, tcy),
//     my = floor(uy), fy = uy - my;
//   * canvas rows yb = y + my and yb + 1: consumer row yc by two
//     fixed-point steps, x-residual rx = s_x(x, yc) - x - tcx, and the
//     two-tap x-lerp of the edge-clamped source at row yb + tcy, columns
//     x + floor(rx) + tcx + {0, 1};
//   * the y-lerp of the two rows.
// A tap counts only where the TPU's masked sums include it: floor in
// [-max_px, max_px + 1] for the (1 - f) tap, [-max_px - 1, max_px] for
// the f tap (warp_taps.cuh, shared with K8). The per-frame prologue
// (the wrapper's `prep`: normalization by M[2,2], round-half-even centre
// shift, the +-PAD `exact` flag and the degenerate-M[2,2] flag) runs
// once per block into shared memory. The in-frame residual maximum is reduced per warp
// and combined per frame with atomicMax on the float's bits (values are
// >= 0); a second small kernel sets ok = okm & exact & max <= max_px - 0.5
// and zeroes the frames it clears. Every float operation is an explicitly
// rounded intrinsic in the plain version's order (IEEE divisions,
// rintf for the half-even rounding, --fmad=false), so kernel and plain
// version agree bit for bit.
//
// Bound on the H100: memory. At B=32, 512x512 it reads 33.6 MB and
// writes 33.6 MB, ~20 us at 3.35 TB/s. The arithmetic is ~7 source-map
// evaluations (14 IEEE divisions) per pixel, ~1 GFLOP per batch; the
// four source reads per pixel are gathers around the pixel's own
// neighbourhood, served by L1/L2.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_taps.cuh"

namespace {

using kcmc::add;
using kcmc::clamp_int;
using kcmc::lerp;
using kcmc::mul;
using kcmc::sub;

constexpr int PAD = 128;
constexpr int NTHREADS = 256;

struct Scal {
  float m00, m01, m02, m10, m11, m12, g, h, tcx, tcy;
  int tx, ty;
  bool exact, okm;
};

__device__ Scal prologue(const float* M, int H, int W) {
  Scal s;
  const float m22 = M[8];
  s.okm = fabsf(m22) > 1e-6f;
  const float den = s.okm ? m22 : 1.0f;
  s.m00 = __fdiv_rn(M[0], den);
  s.m01 = __fdiv_rn(M[1], den);
  s.m02 = __fdiv_rn(M[2], den);
  s.m10 = __fdiv_rn(M[3], den);
  s.m11 = __fdiv_rn(M[4], den);
  s.m12 = __fdiv_rn(M[5], den);
  s.g = __fdiv_rn(M[6], den);
  s.h = __fdiv_rn(M[7], den);
  const float cx = (float)(W - 1) * 0.5f, cy = (float)(H - 1) * 0.5f;
  float w0 = add(add(mul(s.g, cx), mul(s.h, cy)), 1.0f);
  if (fabsf(w0) < 1e-6f) w0 = 1.0f;
  const float sx0 = __fdiv_rn(add(add(mul(s.m00, cx), mul(s.m01, cy)), s.m02), w0);
  const float sy0 = __fdiv_rn(add(add(mul(s.m10, cx), mul(s.m11, cy)), s.m12), w0);
  s.tcx = rintf(sub(sx0, cx));  // round half to even, as jnp.round
  s.tcy = rintf(sub(sy0, cy));
  s.exact = s.tcy >= -PAD && s.tcy <= PAD && s.tcx >= -PAD && s.tcx <= PAD;
  s.tx = clamp_int(s.tcx, PAD + 1.0f);
  s.ty = clamp_int(s.tcy, PAD + 1.0f);
  return s;
}

__device__ __forceinline__ void smap(const Scal& s, float x, float y,
                                     float* sx, float* sy) {
  float wq = add(add(mul(s.g, x), mul(s.h, y)), 1.0f);
  if (fabsf(wq) < 1e-6f) wq = wq < 0.0f ? -1e-6f : 1e-6f;
  *sx = __fdiv_rn(add(add(mul(s.m00, x), mul(s.m01, y)), s.m02), wq);
  *sy = __fdiv_rn(add(add(mul(s.m10, x), mul(s.m11, y)), s.m12), wq);
}

__global__ void __launch_bounds__(NTHREADS)
warp_kernel(const float* __restrict__ frames, const float* __restrict__ mats,
            float* __restrict__ out, int* __restrict__ maxr, int H, int W,
            int mp) {
  __shared__ Scal S;
  const int b = blockIdx.z, y = blockIdx.y;
  if (threadIdx.x == 0) S = prologue(mats + b * 9, H, W);
  __syncthreads();
  const Scal s = S;
  const int x = blockIdx.x * NTHREADS + threadIdx.x;
  float r = 0.0f;
  if (x < W) {
    const float* src = frames + (size_t)b * H * W;
    const float xf = (float)x, yf = (float)y;
    const float lim = (float)(mp + 2);
    float sxo, syo;
    smap(s, xf, yf, &sxo, &syo);
    const float ux = sub(sub(sxo, xf), s.tcx);
    const float uy = sub(sub(syo, yf), s.tcy);
    const float fly = floorf(uy);
    const int myi = clamp_int(fly, lim);
    const float fy = sub(uy, fly);
    float rows[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int k = myi + j;  // both taps' windows, in terms of the row
      if (k < -mp || k > mp + 1) continue;
      const int yb = y + k;
      const float ybf = (float)yb;
      float yc = ybf, sxc, syc;
      for (int it = 0; it < 2; ++it) {
        smap(s, xf, yc, &sxc, &syc);
        yc = sub(ybf, sub(sub(syc, yc), s.tcy));
      }
      smap(s, xf, yc, &sxc, &syc);
      const float rx = sub(sub(sxc, xf), s.tcx);
      const float flx = floorf(rx);
      const int mxi = clamp_int(flx, lim);
      const float fx = sub(rx, flx);
      const float* row = src + (size_t)min(max(yb + s.ty, 0), H - 1) * W;
      const int c0 = min(max(x + mxi + s.tx, 0), W - 1);
      const int c1 = min(max(x + mxi + 1 + s.tx, 0), W - 1);
      rows[j] = lerp(mxi, fx, row[c0], row[c1], mp);
    }
    const float acc = lerp(myi, fy, rows[0], rows[1], mp);
    const bool inb = sxo >= 0.0f && sxo <= (float)W - 1.0f && syo >= 0.0f &&
                     syo <= (float)H - 1.0f;
    out[((size_t)b * H + y) * W + x] = inb ? acc : 0.0f;
    r = inb ? fmaxf(fabsf(ux), fabsf(uy)) : 0.0f;
  }
  // per-warp maximum, one atomic per warp (non-negative floats order
  // like their bit patterns as ints)
  for (int o = 16; o > 0; o >>= 1) r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, o));
  if ((threadIdx.x & 31) == 0) atomicMax(maxr + b, __float_as_int(r));
}

__global__ void __launch_bounds__(NTHREADS)
finalize_kernel(const float* __restrict__ mats, float* __restrict__ out,
                bool* __restrict__ ok, const int* __restrict__ maxr, int H,
                int W, int mp) {
  const int b = blockIdx.y;
  const Scal s = prologue(mats + b * 9, H, W);
  const bool good = s.okm && s.exact &&
                    __int_as_float(maxr[b]) <= (float)mp - 0.5f;
  if (blockIdx.x == 0 && threadIdx.x == 0) ok[b] = good;
  if (good) return;
  float* o = out + (size_t)b * H * W;
  const size_t n = (size_t)H * W;
  for (size_t i = (size_t)blockIdx.x * NTHREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * NTHREADS)
    o[i] = 0.0f;
}

}  // namespace

// frames (B, H, W) f32, mats (B, 3, 3) f32 -> out (B, H, W) f32, ok (B,)
// bool, with maxr (B,) int32 scratch, on `stream`. Returns
// cudaGetLastError() after the launches.
extern "C" int kcmc_warp_batch_matrix(const float* frames, const float* mats,
                                      float* out, bool* ok, int* maxr, int B,
                                      int H, int W, int max_px, void* stream) {
  if (B < 1 || H < 1 || W < 1 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(maxr, 0, sizeof(int) * B, st);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + NTHREADS - 1) / NTHREADS, H, B);
  warp_kernel<<<grid, NTHREADS, 0, st>>>(frames, mats, out, maxr, H, W, max_px);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid2(64, B);
  finalize_kernel<<<grid2, NTHREADS, 0, st>>>(mats, out, ok, maxr, H, W, max_px);
  return (int)cudaGetLastError();
}
