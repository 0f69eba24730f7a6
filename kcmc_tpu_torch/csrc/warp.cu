// K3 warp_translation: gather-free bilinear warp of a frame batch under
// pure per-frame translations.
//
// Replaces kcmc_tpu/ops/pallas_warp.py::warp_batch_translation
// (_warp_kernel), and with it the row-strip variant
// (warp_batch_translation_strips / _warp_kernel_strip) the TPU needed
// for 1024^2-2048^2 frames: this kernel has no size gate.
//
// Each thread first runs the per-frame prologue of the TPU wrapper
// (pallas_warp._shift_scalars, mirrored by cuda_warp.shift_scalars) on
// its frame's (3, 3) matrix: the window origin (oy, ox) into the frame
// edge-padded by PAD = 128 and the scalars (fy, fx, ty, tx, exact); the
// first thread of each frame also writes its ok flag. Output pixel (r, c)
// blends the four source pixels at padded (oy + r, ox + c) .. (+1, +1);
// clamping the source index to the frame reproduces the edge padding
// without materialising it. Weights and the four-term sum follow the
// TPU order (pallas_warp.py:92-101):
//   out = ((w00*a + w01*b) + w10*c) + w11*d,  w00 = (1-fy)*(1-fx), ...
// masked to 0 where the true source (r + ty, c + tx) leaves the frame,
// and for the whole frame when the shift is outside +-PAD (exact = 0).
// All products and sums are explicitly rounded (no FMA), so the kernel
// matches its plain version bit for bit.
//
// Bound on the H100: memory. At B=32, 512x512 it reads 33.6 MB and
// writes 33.6 MB, about 20 us at 3.35 TB/s. Each thread computes four
// adjacent output pixels of one row and stores them as one 16-byte
// vector; the source reads of neighbouring threads are contiguous and
// the one-pixel overlap between them is served from L1.

#include <cuda_runtime.h>

namespace {

constexpr int PAD = 128;
constexpr int NTHREADS = 256;
constexpr int VEC = 4;

// Window origin into the PAD-padded frame: floor of the shift plus PAD,
// clamped to [0, 2 * PAD - 1] (computed in float first, NaN as 0, so the
// int conversion is always defined; the value only matters when exact).
__device__ __forceinline__ int origin(float v0) {
  float v = isnan(v0) ? 0.0f : fminf(fmaxf(v0, -PAD - 1.0f), (float)PAD);
  return min(max((int)v + PAD, 0), 2 * PAD - 1);
}

__global__ void __launch_bounds__(NTHREADS)
warp_kernel(const float* __restrict__ frames, const float* __restrict__ mats,
            float* __restrict__ out, bool* __restrict__ ok, int H, int W) {
  const int b = blockIdx.y;
  const float tx = mats[b * 9 + 2], ty = mats[b * 9 + 5];
  const float x0f = floorf(tx), y0f = floorf(ty);
  const float fx = __fsub_rn(tx, x0f), fy = __fsub_rn(ty, y0f);
  const bool exact = y0f >= -PAD && y0f <= PAD - 1 && x0f >= -PAD &&
                     x0f <= PAD - 1;
  const int oy = origin(y0f), ox = origin(x0f);
  if (blockIdx.x == 0 && threadIdx.x == 0) ok[b] = exact;

  const int groups = (W + VEC - 1) / VEC;
  const int g = blockIdx.x * NTHREADS + threadIdx.x;
  if (g >= H * groups) return;
  const int r = g / groups;
  const int c0 = (g % groups) * VEC;
  const float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
  const float w00 = __fmul_rn(gy, gx), w01 = __fmul_rn(gy, fx);
  const float w10 = __fmul_rn(fy, gx), w11 = __fmul_rn(fy, fx);

  const float* src = frames + (size_t)b * H * W;
  const int ry0 = min(max(oy + r - PAD, 0), H - 1);
  const int ry1 = min(max(oy + r + 1 - PAD, 0), H - 1);
  const float* row0 = src + (size_t)ry0 * W;
  const float* row1 = src + (size_t)ry1 * W;
  const float rowf = __fadd_rn((float)r, ty);
  const bool row_in = exact && rowf >= 0.0f && rowf <= (float)H - 1.0f;

  float v[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = c0 + i;
    const int cx0 = min(max(ox + c - PAD, 0), W - 1);
    const int cx1 = min(max(ox + c + 1 - PAD, 0), W - 1);
    float s = __fmul_rn(w00, row0[cx0]);
    s = __fadd_rn(s, __fmul_rn(w01, row0[cx1]));
    s = __fadd_rn(s, __fmul_rn(w10, row1[cx0]));
    s = __fadd_rn(s, __fmul_rn(w11, row1[cx1]));
    const float colf = __fadd_rn((float)c, tx);
    const bool inb = row_in && colf >= 0.0f && colf <= (float)W - 1.0f;
    v[i] = inb ? s : 0.0f;
  }
  float* dst = out + (size_t)b * H * W + (size_t)r * W;
  if (c0 + VEC <= W && (W % VEC) == 0) {
    *reinterpret_cast<float4*>(dst + c0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < VEC && c0 + i < W; ++i) dst[c0 + i] = v[i];
  }
}

}  // namespace

// frames (B, H, W) f32, mats (B, 3, 3) f32 -> out (B, H, W) f32 and ok
// (B,) bool on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int kcmc_warp_translation(const float* frames, const float* mats,
                                     float* out, bool* ok, int B, int H, int W,
                                     void* stream) {
  const long long n = (long long)H * ((W + VEC - 1) / VEC);
  if (n > 0x7fffffffLL - NTHREADS) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((n + NTHREADS - 1) / NTHREADS), B);
  warp_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(frames, mats, out,
                                                           ok, H, W);
  return (int)cudaGetLastError();
}
