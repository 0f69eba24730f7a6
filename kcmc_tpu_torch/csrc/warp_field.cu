// K8 warp_batch_field: piecewise warp of a frame batch through cell-centred
// (B, gh, gw, 2) displacement fields, one bilinear interpolation computed
// directly per output pixel.
//
// Replaces kcmc_tpu/ops/pallas_warp_field.py::warp_batch_field
// (_make_kernel, pallas_warp_field.py:82/:196). The TPU kernel rolls a
// VMEM window of each row strip by the field's integer mean, upsamples the
// residual field in-kernel (column interpolation as one matmul with hat
// weights, row interpolation as gh broadcast multiply-adds), builds a
// canvas of x-resampled rows whose x-phase is taken at each canvas row's
// consumer (two fixed-point iterations), and y-resamples it at the output
// pixel's own phase. Here:
//   * field_prologue (one block per frame): t = round-half-even(mean of the
//     field over its cells, summed sequentially row-major), the residual
//     maximum max |field - t|, exact = |t| <= PAD and maxr <= max_px - 0.5,
//     and ok = exact;
//   * field_warp (one thread per output pixel): the frame's residual field
//     in shared memory; the upsampled residual at (x, y) from its two live
//     column cells and two live row cells (the hat weights of every other
//     cell are exactly 0, so the TPU's full sums add only zeros to these
//     two terms); the two consumer rows, the two-tap x-lerp of the
//     edge-clamped source shifted by t, and the y-lerp, each tap only
//     inside the TPU's window (warp_taps.cuh, shared with K7); zero where
//     the true sample leaves the frame or exact is 0.
// Every float operation is an explicitly rounded intrinsic in the plain
// version's order (rintf for the half-even rounding, --fmad=false), so
// kernel and plain version agree bit for bit; the TPU kernel's interpret
// mode contracts some multiply-adds and agrees to ~1e-6.
//
// Bound on the H100: memory. At B=32, 512x512 it must read 33.6 MB of
// frames and write 33.6 MB, ~20 us at 3.35 TB/s; the fields are 16 KB.
// The function needs ~80 float operations per pixel (chip_smoke.py's
// field_warp_ops counts each column, row and canvas-row term once), ~10 us
// at 67 TFLOP/s. This kernel recomputes the column weights and both canvas
// rows for every output pixel, ~220 operations per pixel; the four source
// reads per pixel are gathers around the pixel's own neighbourhood, served
// by L1/L2. No canvas, strips or halo in memory, so the frame size is not
// gated.

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

// scal per frame: {tx, ty, exact}
__global__ void __launch_bounds__(NTHREADS)
field_prologue(const float* __restrict__ fields, float* __restrict__ scal,
               bool* __restrict__ ok, int gh, int gw, int mp) {
  extern __shared__ float cells[];  // gh * gw * 2
  __shared__ float t[2];
  __shared__ int bad;
  const int b = blockIdx.x;
  const int n = gh * gw * 2;
  const float* f = fields + (size_t)b * n;
  for (int i = threadIdx.x; i < n; i += NTHREADS) cells[i] = f[i];
  if (threadIdx.x == 0) bad = 0;
  __syncthreads();
  if (threadIdx.x < 2) {
    float s = 0.0f;
    for (int c = 0; c < gh * gw; ++c) s = add(s, cells[2 * c + threadIdx.x]);
    t[threadIdx.x] = rintf(__fdiv_rn(s, (float)(gh * gw)));
  }
  __syncthreads();
  // residual bound: every |field - t| <= max_px - 0.5 (NaN fails it)
  const float lim = (float)mp - 0.5f;
  for (int i = threadIdx.x; i < n; i += NTHREADS) {
    const float r = fabsf(sub(cells[i], t[i & 1]));
    if (!(r <= lim)) bad = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float tx = t[0], ty = t[1];
    const bool exact = !bad && ty >= -PAD && ty <= PAD && tx >= -PAD &&
                       tx <= PAD;
    scal[b * 3 + 0] = tx;
    scal[b * 3 + 1] = ty;
    scal[b * 3 + 2] = exact ? 1.0f : 0.0f;
    ok[b] = exact;
  }
}

struct Grid {
  const float* res;  // (gh, gw, 2) residual cells in shared memory
  int gh, gw;
  float rh, rw;  // float32(gh / H), float32(gw / W)
};

// the column-interpolated residual of cell row c, channel ch, at the
// column with live cells d0, d0 + 1 and hat weights h0, h1
__device__ __forceinline__ float inner(const Grid& g, int c, int ch, int d0,
                                       float h0, float h1) {
  const float a = mul(g.res[(c * g.gw + d0) * 2 + ch], h0);
  if (d0 + 1 >= g.gw) return a;
  return add(a, mul(g.res[(c * g.gw + d0 + 1) * 2 + ch], h1));
}

// row interpolation of channel ch at cell-space row coordinate u
__device__ __forceinline__ float interp(const Grid& g, float u, int ch,
                                        int d0, float h0, float h1) {
  const int c0 = (int)floorf(u);
  const float w0 = fmaxf(sub(1.0f, fabsf(sub(u, (float)c0))), 0.0f);
  const float a = mul(w0, inner(g, c0, ch, d0, h0, h1));
  if (c0 + 1 >= g.gh) return a;
  const float w1 = fmaxf(sub(1.0f, fabsf(sub(u, (float)(c0 + 1)))), 0.0f);
  return add(a, mul(w1, inner(g, c0 + 1, ch, d0, h0, h1)));
}

__device__ __forceinline__ float urow_of(const Grid& g, float y) {
  return fminf(fmaxf(sub(mul(add(y, 0.5f), g.rh), 0.5f), 0.0f),
               (float)(g.gh - 1));
}

__global__ void __launch_bounds__(NTHREADS)
field_warp(const float* __restrict__ frames, const float* __restrict__ fields,
           const float* __restrict__ scal, float* __restrict__ out, int H,
           int W, int gh, int gw, float rh, float rw, int mp) {
  extern __shared__ float res[];  // gh * gw * 2
  const int b = blockIdx.z, y = blockIdx.y;
  const float tx = scal[b * 3 + 0], ty = scal[b * 3 + 1];
  const bool exact = scal[b * 3 + 2] > 0.5f;
  const int n = gh * gw * 2;
  if (exact) {
    const float* f = fields + (size_t)b * n;
    for (int i = threadIdx.x; i < n; i += NTHREADS)
      res[i] = sub(f[i], (i & 1) ? ty : tx);
  }
  __syncthreads();
  const int x = blockIdx.x * NTHREADS + threadIdx.x;
  if (x >= W) return;
  float* o = out + ((size_t)b * H + y) * W + x;
  if (!exact) {
    *o = 0.0f;
    return;
  }
  const Grid g{res, gh, gw, rh, rw};
  const float xf = (float)x, yf = (float)y;
  // the column's two live cells and hat weights
  const float ucol =
      fminf(fmaxf(sub(mul(add(xf, 0.5f), rw), 0.5f), 0.0f), (float)(gw - 1));
  const int d0 = (int)floorf(ucol);
  const float h0 = fmaxf(sub(1.0f, fabsf(sub(ucol, (float)d0))), 0.0f);
  const float h1 = fmaxf(sub(1.0f, fabsf(sub(ucol, (float)(d0 + 1)))), 0.0f);

  const float uro = urow_of(g, yf);
  const float ry = interp(g, uro, 1, d0, h0, h1);
  const float rx = interp(g, uro, 0, d0, h0, h1);
  const float lim = (float)(mp + 2);
  const float fly = floorf(ry);
  const int myi = clamp_int(fly, lim);
  const float fy = sub(ry, fly);
  const int itx = (int)tx, ity = (int)ty;
  const float* src = frames + (size_t)b * H * W;
  float rows[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = myi + j;
    if (k < -mp || k > mp + 1) continue;
    const int yb = y + k;
    const float ybf = (float)yb;
    float yc = ybf;
    for (int it = 0; it < 2; ++it) yc = sub(ybf, interp(g, urow_of(g, yc), 1, d0, h0, h1));
    const float rxc = interp(g, urow_of(g, yc), 0, d0, h0, h1);
    const float flx = floorf(rxc);
    const int mxi = clamp_int(flx, lim);
    const float fx = sub(rxc, flx);
    const float* row = src + (size_t)min(max(yb + ity, 0), H - 1) * W;
    const int c0 = min(max(x + mxi + itx, 0), W - 1);
    const int c1 = min(max(x + mxi + 1 + itx, 0), W - 1);
    rows[j] = lerp(mxi, fx, row[c0], row[c1], mp);
  }
  const float acc = lerp(myi, fy, rows[0], rows[1], mp);
  const float sy = add(add(yf, ty), ry);
  const float sx = add(add(xf, tx), rx);
  const bool inb = sy >= 0.0f && sy <= (float)H - 1.0f && sx >= 0.0f &&
                   sx <= (float)W - 1.0f;
  *o = inb ? acc : 0.0f;
}

}  // namespace

// frames (B, H, W) f32, fields (B, gh, gw, 2) f32 -> out (B, H, W) f32 and
// ok (B,) bool, with scal (B, 3) f32 scratch, on `stream`. rh, rw are
// float32(gh / H) and float32(gw / W). Returns cudaGetLastError() after
// the launches.
extern "C" int kcmc_warp_batch_field(const float* frames, const float* fields,
                                     float* out, bool* ok, float* scal, int B,
                                     int H, int W, int gh, int gw, float rh,
                                     float rw, int max_px, void* stream) {
  if (B < 1 || H < 1 || W < 1 || H > 65535 || B > 65535 || gh < 1 ||
      gw < 1 || gh * gw * 2 * (int)sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = gh * gw * 2 * (int)sizeof(float);
  field_prologue<<<B, NTHREADS, smem, st>>>(fields, scal, ok, gh, gw, max_px);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((W + NTHREADS - 1) / NTHREADS, H, B);
  field_warp<<<grid, NTHREADS, smem, st>>>(frames, fields, scal, out, H, W, gh,
                                           gw, rh, rw, max_px);
  return (int)cudaGetLastError();
}
