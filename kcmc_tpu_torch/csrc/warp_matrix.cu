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
// the f tap (warp_taps.cuh, shared with K8). Every float operation is an
// explicitly rounded intrinsic in the plain version's order (IEEE
// divisions, rintf for the half-even rounding, --fmad=false), so kernel
// and plain version agree bit for bit.
//
// Bound on the H100: memory. At B=32, 512x512 it reads 33.6 MB and
// writes 33.6 MB, ~20 us at 3.35 TB/s. What costs is arithmetic: a
// pixel evaluates the source map up to seven times, and on projective
// frames each evaluation's IEEE division is a reciprocal, Newton steps
// and a slow-path check. The design keeps the work to what the function
// needs:
//   * the per-frame prologue (the wrapper's `prep`: normalization by
//     M[2,2], round-half-even centre shift, the +-PAD `exact` flag, the
//     degenerate-M[2,2] flag) is computed by each warp's 32 lanes
//     together, eight normalizations side by side: two division latencies
//     and no block barrier or serial thread;
//   * exact affine branch: where the normalized g and h are both +-0,
//     wq = (g x + h y) + 1 is exactly 1 for every finite x and y, and a
//     division by 1 is the identity, so the kernel skips wq and every
//     division with the same bits. Where a fixed-point row yc is not
//     finite (wq would be NaN), both forms give a non-finite x-residual,
//     whose clamped floor (+-(max_px + 2)) lies outside both tap windows,
//     so the pixel is the same 0. The branch is per frame, uniform in a
//     block;
//   * projective pixels divide only for the halves they use: the two
//     fixed-point steps need s_y, the last step s_x, the first
//     evaluation both;
//   * a canvas row is a function of (row, x) alone, and output rows y and
//     y + 1 share one whenever their my agree. Each thread takes one
//     column x and 8 consecutive output rows and reuses the row above's
//     second canvas row as its first, so a pixel computes ~1.1 canvas
//     rows instead of 2 (on projective frames ~5.4 divisions, not 14); a
//     warp's 32 columns make its loads and stores contiguous;
//   * a frame that is flagged for sure is not warped: okm or exact off, or
//     one of 32 pixels on a ring inside its border with a residual beyond
//     the window (evaluated by every warp, so the frame's blocks agree);
//   * each block writes its residual maximum to its own scratch slot (no
//     atomics, nothing to zero); finalize_kernel reduces a frame's slots,
//     sets ok = okm & exact & max <= max_px - 0.5 and zeroes the frames it
//     clears. Two launches per call.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "warp_taps.cuh"

namespace {

using kcmc::add;
using kcmc::clamp_int;
using kcmc::lerp;
using kcmc::mul;
using kcmc::sub;

constexpr int PAD = 128;
constexpr int RPT = 8;                 // output rows per thread, one column
constexpr int NTHREADS = 128;          // consecutive columns per block
constexpr int FIN_BLOCKS = 16;         // finalize blocks per frame
constexpr int FIN_THREADS = 256;

enum : int { EXACT = 1, OKM = 2, AFFINE = 4 };

// One frame's prologue (the wrapper's `prep`).
struct Scal {
  float m00, m01, m02, m10, m11, m12, g, h, tcx, tcy;
  int tx, ty, flags;
};

// The prologue, computed by the 32 lanes of a warp together: lanes 0-7
// normalize one entry of M each, lanes 0 and 1 map the frame centre; two
// division latencies, no barrier. Every lane returns the whole result.
__device__ __forceinline__ Scal prologue(const float* __restrict__ M, int H, int W,
                                         int lane) {
  Scal s;
  const float m22 = __ldg(M + 8);
  const bool okm = fabsf(m22) > 1e-6f;
  const float den = okm ? m22 : 1.0f;
  const float v = __fdiv_rn(__ldg(M + (lane & 7)), den);
  s.m00 = __shfl_sync(0xffffffffu, v, 0);
  s.m01 = __shfl_sync(0xffffffffu, v, 1);
  s.m02 = __shfl_sync(0xffffffffu, v, 2);
  s.m10 = __shfl_sync(0xffffffffu, v, 3);
  s.m11 = __shfl_sync(0xffffffffu, v, 4);
  s.m12 = __shfl_sync(0xffffffffu, v, 5);
  s.g = __shfl_sync(0xffffffffu, v, 6);
  s.h = __shfl_sync(0xffffffffu, v, 7);
  const float cx = (float)(W - 1) * 0.5f, cy = (float)(H - 1) * 0.5f;
  float w0 = add(add(mul(s.g, cx), mul(s.h, cy)), 1.0f);
  if (fabsf(w0) < 1e-6f) w0 = 1.0f;
  const float num = (lane & 1) ? add(add(mul(s.m10, cx), mul(s.m11, cy)), s.m12)
                               : add(add(mul(s.m00, cx), mul(s.m01, cy)), s.m02);
  const float q = __fdiv_rn(num, w0);
  const float sx0 = __shfl_sync(0xffffffffu, q, 0);
  const float sy0 = __shfl_sync(0xffffffffu, q, 1);
  s.tcx = rintf(sub(sx0, cx));  // round half to even, as jnp.round
  s.tcy = rintf(sub(sy0, cy));
  const bool exact = s.tcy >= -PAD && s.tcy <= PAD && s.tcx >= -PAD && s.tcx <= PAD;
  s.tx = clamp_int(s.tcx, PAD + 1.0f);
  s.ty = clamp_int(s.tcy, PAD + 1.0f);
  // exact zeros only (either sign): g = 1e-30 takes the divisions
  s.flags = (exact ? EXACT : 0) | (okm ? OKM : 0) |
            (s.g == 0.0f && s.h == 0.0f ? AFFINE : 0);
  return s;
}

// An integer floor clamped to +-lim, one comparison cheaper than
// clamp_int: NaN goes to -lim where clamp_int gives +lim. Both lie outside
// both tap windows, so the pixel is the same.
__device__ __forceinline__ int floor_window(float fl, float lim) {
  return (int)fminf(fmaxf(fl, -lim), lim);
}

// wq at (x, y) from its two products, clamped away from 0 as the
// reference does
__device__ __forceinline__ float wq_of(float gx, float hy) {
  const float wq = add(add(gx, hy), 1.0f);
  return fabsf(wq) < 1e-6f ? (wq < 0.0f ? -1e-6f : 1e-6f) : wq;
}

// The source map at output pixel (x, y): its y-residual uy, whether the
// source lies in the frame, and the pixel's residual term (max(|ux|,
// |uy|) there, else 0). m00x, m10x, gx: the column's products.
template <bool AFF>
__device__ __forceinline__ bool source_px(const Scal& s, int H, int W, float xf, float yf,
                                          float m00x, float m10x, float gx, float* uy,
                                          float* res) {
  const float nx = add(add(m00x, mul(s.m01, yf)), s.m02);
  const float ny = add(add(m10x, mul(s.m11, yf)), s.m12);
  float sxo = nx, syo = ny;
  if (!AFF) {
    const float wq = wq_of(gx, mul(s.h, yf));
    sxo = __fdiv_rn(nx, wq);
    syo = __fdiv_rn(ny, wq);
  }
  const float ux = sub(sub(sxo, xf), s.tcx);
  *uy = sub(sub(syo, yf), s.tcy);
  const bool inb = sxo >= 0.0f && sxo <= (float)W - 1.0f && syo >= 0.0f &&
                   syo <= (float)H - 1.0f;
  *res = inb ? fmaxf(fabsf(ux), fabsf(*uy)) : 0.0f;
  return inb;
}

// Canvas row yb at column x: its consumer row yc by two fixed-point
// steps, the x-residual at (x, yc) and the two-tap x-lerp of the source
// row yb + ty. A function of (yb, x) alone, so output rows that share a
// canvas row share its value. m00x, m10x, gx: the column's products.
template <bool AFF>
__device__ __forceinline__ float canvas(const Scal& s, const float* __restrict__ src,
                                        int H, int W, int mp, int x, float xf,
                                        float m00x, float m10x, float gx, int yb) {
  const float ybf = (float)yb;
  float yc = ybf;
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    float syc = add(add(m10x, mul(s.m11, yc)), s.m12);
    if (!AFF) syc = __fdiv_rn(syc, wq_of(gx, mul(s.h, yc)));
    yc = sub(ybf, sub(sub(syc, yc), s.tcy));
  }
  float sxc = add(add(m00x, mul(s.m01, yc)), s.m02);
  if (!AFF) sxc = __fdiv_rn(sxc, wq_of(gx, mul(s.h, yc)));
  const float rx = sub(sub(sxc, xf), s.tcx);
  const float flx = floorf(rx);
  const int mxi = floor_window(flx, (float)(mp + 2));
  const float fx = sub(rx, flx);
  const int row = min(max(yb + s.ty, 0), H - 1) * W;  // H W < 2^31
  const int c0 = min(max(x + mxi + s.tx, 0), W - 1);
  const int c1 = min(max(x + mxi + 1 + s.tx, 0), W - 1);
  return lerp(mxi, fx, __ldg(src + row + c0), __ldg(src + row + c1), mp);
}

// Column x, output rows y0 .. y0 + RPT - 1 of one frame; returns the
// largest residual term. Output row y reads canvas rows yb = y + my and
// yb + 1; where my is the row above's, yb is the row above's yb + 1, so
// each output pixel computes one new canvas row. A canvas row outside
// its tap's window is computed all the same: the y-lerp takes 0 for that
// tap whatever its value.
template <bool AFF>
__device__ __forceinline__ float warp_col(const Scal& s, const float* __restrict__ src,
                                          float* __restrict__ dst, int H, int W,
                                          int mp, int x, int y0) {
  const float xf = (float)x;
  const float m00x = mul(s.m00, xf), m10x = mul(s.m10, xf);
  const float gx = AFF ? 0.0f : mul(s.g, xf);
  const float lim = (float)(mp + 2);
  int last_yb = INT_MIN;
  float last_v = 0.0f, r = 0.0f;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int y = y0 + i;
    if (y >= H) break;
    const float yf = (float)y;
    float uy, res;
    const bool inb = source_px<AFF>(s, H, W, xf, yf, m00x, m10x, gx, &uy, &res);
    const float fly = floorf(uy);
    const int myi = floor_window(fly, lim);
    const float fy = sub(uy, fly);
    const int yb = y + myi;
    float v0;
    if (yb == last_yb) {
      v0 = last_v;
    } else {
      v0 = canvas<AFF>(s, src, H, W, mp, x, xf, m00x, m10x, gx, yb);
    }
    const float v1 = canvas<AFF>(s, src, H, W, mp, x, xf, m00x, m10x, gx, yb + 1);
    last_yb = yb + 1;
    last_v = v1;
    const float acc = lerp(myi, fy, v0, v1, mp);
    dst[y * W + x] = inb ? acc : 0.0f;
    r = fmaxf(r, res);
  }
  return r;
}

// The largest residual term of 32 pixels on a ring max_px + 2 inside the
// frame's border, 8 along each side, by the operations warp_col uses; every
// lane gets it. Where it leaves the window the frame is flagged for sure.
template <bool AFF>
__device__ __forceinline__ float ring_residual(const Scal& s, int H, int W, int mp,
                                              int lane) {
  const int in = mp + 2;
  const int x0 = min(in, W - 1), x1 = max(W - 1 - in, 0);
  const int y0 = min(in, H - 1), y1 = max(H - 1 - in, 0);
  const int k = lane & 7;
  int px, py;
  switch (lane >> 3) {
    case 0: px = x0 + (x1 - x0) * k / 8; py = y0; break;
    case 1: px = x1; py = y0 + (y1 - y0) * k / 8; break;
    case 2: px = x1 - (x1 - x0) * k / 8; py = y1; break;
    default: px = x0; py = y1 - (y1 - y0) * k / 8; break;
  }
  const float xf = (float)px;
  float uy, res;
  source_px<AFF>(s, H, W, xf, (float)py, mul(s.m00, xf), mul(s.m10, xf),
                 AFF ? 0.0f : mul(s.g, xf), &uy, &res);
  for (int o = 16; o > 0; o >>= 1) res = fmaxf(res, __shfl_xor_sync(0xffffffffu, res, o));
  return res;
}

// One block: NTHREADS columns x RPT rows of frame blockIdx.z. Its
// residual maximum goes to its own slot of the frame's scratch row
// part[b] = {flags, one maximum per block} (no atomics, nothing to zero).
__global__ void __launch_bounds__(NTHREADS)
warp_kernel(const float* __restrict__ frames, const float* __restrict__ mats,
            float* __restrict__ out, int* __restrict__ part, int H, int W, int mp) {
  __shared__ float wmax[NTHREADS / 32];
  const int b = blockIdx.z;
  const int x = blockIdx.x * NTHREADS + threadIdx.x;
  const int y0 = blockIdx.y * RPT;
  const int lane = threadIdx.x & 31;
  const Scal s = prologue(mats + b * 9, H, W, lane);
  const bool aff = s.flags & AFFINE;
  // A frame flagged for sure (okm or exact off, or a ring pixel beyond the
  // window) is not warped: every warp of the frame comes to the same
  // decision, and finalize_kernel zeroes and flags the frame.
  float r = 0.0f;
  if ((s.flags & OKM) && (s.flags & EXACT)) {
    r = aff ? ring_residual<true>(s, H, W, mp, lane) : ring_residual<false>(s, H, W, mp, lane);
    if (r <= (float)mp - 0.5f && x < W) {
      const float* src = frames + (size_t)b * H * W;
      float* dst = out + (size_t)b * H * W;
      r = aff ? warp_col<true>(s, src, dst, H, W, mp, x, y0)
              : warp_col<false>(s, src, dst, H, W, mp, x, y0);
    }
  }
  for (int o = 16; o > 0; o >>= 1) r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, o));
  if (lane == 0) wmax[threadIdx.x >> 5] = r;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = wmax[0];
#pragma unroll
    for (int w = 1; w < NTHREADS / 32; ++w) m = fmaxf(m, wmax[w]);
    const int nbf = gridDim.x * gridDim.y;
    const int blk = blockIdx.y * gridDim.x + blockIdx.x;
    int* pf = part + (size_t)b * (1 + nbf);
    pf[1 + blk] = __float_as_int(m);
    if (blk == 0) pf[0] = s.flags;
  }
}

// ok[b] = okm & exact & (largest residual <= max_px - 0.5); the frames it
// clears are zeroed, gridDim.x blocks a frame.
__global__ void __launch_bounds__(FIN_THREADS)
finalize_kernel(const int* __restrict__ part, float* __restrict__ out,
                bool* __restrict__ ok, int H, int W, int mp, int nbf) {
  __shared__ float wmax[FIN_THREADS / 32];
  const int b = blockIdx.y;
  const int* pf = part + (size_t)b * (1 + nbf);
  float m = 0.0f;  // non-negative block maxima
  for (int i = threadIdx.x; i < nbf; i += FIN_THREADS) m = fmaxf(m, __int_as_float(pf[1 + i]));
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < FIN_THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
  const int flags = pf[0];
  const bool good = (flags & OKM) && (flags & EXACT) && m <= (float)mp - 0.5f;
  if (blockIdx.x == 0 && threadIdx.x == 0) ok[b] = good;
  if (good) return;
  float* o = out + (size_t)b * H * W;
  const size_t n = (size_t)H * W;
  const size_t stride = (size_t)gridDim.x * FIN_THREADS;
  size_t i = (size_t)blockIdx.x * FIN_THREADS + threadIdx.x;
  if ((((uintptr_t)o) & 15) == 0) {  // 16-byte stores, then the tail
    for (; i < n / 4; i += stride) reinterpret_cast<float4*>(o)[i] = make_float4(0, 0, 0, 0);
    i = n / 4 * 4 + (size_t)blockIdx.x * FIN_THREADS + threadIdx.x;
  }
  for (; i < n; i += stride) o[i] = 0.0f;
}

}  // namespace

// int32 words of scratch kcmc_warp_batch_matrix needs for (B, H, W)
extern "C" long long kcmc_warp_batch_matrix_scratch(int B, int H, int W) {
  const long long nbf = (long long)((W + NTHREADS - 1) / NTHREADS) * ((H + RPT - 1) / RPT);
  return (long long)B * (1 + nbf);
}

// frames (B, H, W) f32, mats (B, 3, 3) f32 -> out (B, H, W) f32, ok (B,)
// bool, with `scratch` int32 words of kcmc_warp_batch_matrix_scratch,
// on `stream`. Returns cudaGetLastError() after the launches.
extern "C" int kcmc_warp_batch_matrix(const float* frames, const float* mats,
                                      float* out, bool* ok, void* scratch, int B,
                                      int H, int W, int max_px, void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535 || (H + RPT - 1) / RPT > 65535 ||
      (long long)H * W > INT_MAX)  // frame offsets are 32-bit
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((W + NTHREADS - 1) / NTHREADS, (H + RPT - 1) / RPT, B);
  warp_kernel<<<grid, NTHREADS, 0, st>>>(frames, mats, out, (int*)scratch, H, W, max_px);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid2(FIN_BLOCKS, B);
  finalize_kernel<<<grid2, FIN_THREADS, 0, st>>>((const int*)scratch, out, ok, H, W,
                                                 max_px, grid.x * grid.y);
  return (int)cudaGetLastError();
}
