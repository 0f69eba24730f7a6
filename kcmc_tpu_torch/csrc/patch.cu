// K2 extract_blended: per-keypoint patch cut plus separable bilinear
// blend, keypoint-first, bf16 in and out; with moments (K6), also the
// ORB intensity-centroid moments of each raw patch.
//
// Replaces kcmc_tpu/ops/pallas_patch.py::extract_blended
// (extract_blended_planes / _blended_kernel, with_moments=False as K2 and
// with_moments=True as K6),
// and with it the banded (_extract_blended_planes_banded) and slab
// (_extract_blended_planes_slab) layouts that the TPU needed for frames
// past its VMEM budget: this kernel reads from device memory directly
// and has no size gate.
//
// For keypoint (x, y) it reads the P x P window of the edge-padded frame
// at (floor(y) + 1, floor(x) + 1) (reads past the padded frame clamp to
// its edge, as the Pallas wrapper's extra edge padding does) and writes
//   yb[i][j]  = (1 - fy) * p[i][j] + fy * p[i+1][j]
//   out[i][j] = bf16((1 - fx) * yb[i][j] + fx * yb[i][j+1])
// for the (P-1) x (P-1) output, in float32 on the bf16 pixel values,
// rounded as two fused multiply-adds:
//   yb  = fma(fy, p[i+1][j], (1 - fy) * p[i][j])
//   out = fma(1 - fx, yb[i][j], (fx * yb[i][j+1]))
// That is how the reference evaluates the expression on the CPU (XLA
// contracts it into exactly these FMAs; the uncontracted form differs
// from the reference in ~25% of the float32 results). Descriptor bits
// are order comparisons of the bf16 outputs, so the kernel must match
// its plain version bit for bit: the FMAs are explicit __fmaf_rn and
// every other operation an explicitly rounded __fmul_rn / __fsub_rn,
// and the build adds --fmad=false so the compiler contracts nothing else.
//
// Bound on the H100: memory. At B=32, K=512, 512x512 (padded 540x540)
// it must read 18.7 MB of frames and write 23.9 MB of patches, about
// 13 us at 3.35 TB/s; the arithmetic is ~95 MFLOP. One block takes
// KPB keypoints of one frame: it stages each P x P window once in shared
// memory (the four taps of every output read it four times) and writes
// each keypoint's (P-1)^2 outputs as one contiguous run.
//
// K6 (WITH_MOMENTS): per keypoint also
//   m10 = sum patch * dx,  m01 = sum patch * dy
// over the MOMENT_RADIUS disc of the RAW staged window, centred at window
// index c + (qx, qy), c = (P - 2) / 2, q = (frac >= 0.5): the reference's
// `_moment_maps(P)` weights (pallas_patch.py:222). Each product of a bf16
// value and an integer |w| <= 7 is exact in float32 and in float64, so one
// thread per keypoint accumulates the 15 x 15 box in float64, row-major,
// and rounds once to float32; the plain version does the same, and the two
// agree bit for bit (the TPU kernel sums in float32 in XLA's order, which
// interpret mode matches to a few ulps). At config 4 (B=32, K=512, P=32,
// 544^2 frames) K6 must read 18.9 MB and write 31.5 MB + 0.13 MB of
// moments, ~15 us at 3.35 TB/s; the moment sums are 450 float64 adds per
// keypoint, one long thread per keypoint after the block's blend.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int KPB = 4;  // keypoints per block
constexpr int MAXP = 64;
constexpr int MR = 7;  // MOMENT_RADIUS

template <bool WITH_MOMENTS>
__global__ void __launch_bounds__(NTHREADS)
blend_kernel(const __nv_bfloat16* __restrict__ padded,
             const float* __restrict__ xy, __nv_bfloat16* __restrict__ out,
             float* __restrict__ m10, float* __restrict__ m01,
             int K, int Hp, int Wp, int P) {
  extern __shared__ float win[];  // KPB x P x P
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * KPB;
  const int PP = P * P, Pb = P - 1;
  const __nv_bfloat16* frame = padded + (size_t)b * Hp * Wp;

  __shared__ float fxs[KPB], fys[KPB];
  __shared__ int oys[KPB], oxs[KPB];
  if (threadIdx.x < KPB) {
    int k = k0 + threadIdx.x;
    float x = 0.f, y = 0.f;
    if (k < K) {
      x = xy[((size_t)b * K + k) * 2 + 0];
      y = xy[((size_t)b * K + k) * 2 + 1];
    }
    float flx = floorf(x), fly = floorf(y);
    fxs[threadIdx.x] = __fsub_rn(x, flx);
    fys[threadIdx.x] = __fsub_rn(y, fly);
    oxs[threadIdx.x] = (int)flx + 1;
    oys[threadIdx.x] = (int)fly + 1;
  }
  __syncthreads();

  for (int e = threadIdx.x; e < KPB * PP; e += NTHREADS) {
    int j = e / PP, q = e % PP;
    int r = min(max(oys[j] + q / P, 0), Hp - 1);
    int c = min(max(oxs[j] + q % P, 0), Wp - 1);
    win[e] = __bfloat162float(frame[(size_t)r * Wp + c]);
  }
  __syncthreads();

  const int n_out = Pb * Pb;
  for (int e = threadIdx.x; e < KPB * n_out; e += NTHREADS) {
    int j = e / n_out, q = e % n_out;
    int k = k0 + j;
    if (k >= K) continue;
    int i = q / Pb, c = q % Pb;
    const float* w = win + j * PP;
    float fx = fxs[j], fy = fys[j];
    float gy = __fsub_rn(1.0f, fy), gx = __fsub_rn(1.0f, fx);
    float yb0 = __fmaf_rn(fy, w[(i + 1) * P + c], __fmul_rn(gy, w[i * P + c]));
    float yb1 =
        __fmaf_rn(fy, w[(i + 1) * P + c + 1], __fmul_rn(gy, w[i * P + c + 1]));
    float v = __fmaf_rn(gx, yb0, __fmul_rn(fx, yb1));
    out[((size_t)b * K + k) * n_out + q] = __float2bfloat16_rn(v);
  }
  if (WITH_MOMENTS && threadIdx.x % 32 == 0 && threadIdx.x / 32 < KPB) {
    const int j = threadIdx.x / 32;
    const int k = k0 + j;
    if (k < K) {
      const int c = (P - 2) / 2;
      const int cy = c + (fys[j] >= 0.5f ? 1 : 0);
      const int cx = c + (fxs[j] >= 0.5f ? 1 : 0);
      const float* w = win + j * PP;
      double sx = 0.0, sy = 0.0;
      for (int dy = -MR; dy <= MR; ++dy) {
        for (int dx = -MR; dx <= MR; ++dx) {
          if (dx * dx + dy * dy > MR * MR) continue;
          const double v = (double)w[(cy + dy) * P + cx + dx];
          sx = __dadd_rn(sx, __dmul_rn(v, (double)dx));
          sy = __dadd_rn(sy, __dmul_rn(v, (double)dy));
        }
      }
      m10[(size_t)b * K + k] = __double2float_rn(sx);
      m01[(size_t)b * K + k] = __double2float_rn(sy);
    }
  }
}

}  // namespace

// padded (B, Hp, Wp) bf16, xy (B, K, 2) f32 -> out (B, K, P-1, P-1) bf16
// and, when m10 and m01 are not null, the (B, K) f32 moments (K6; needs
// P >= 2 * MR + 3 so the disc fits the window), on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int kcmc_extract_blended(const void* padded, const float* xy,
                                    void* out, float* m10, float* m01,
                                    int B, int K, int Hp, int Wp, int P,
                                    void* stream) {
  if (P < 2 || P > MAXP) return (int)cudaErrorInvalidValue;
  const bool mom = m10 != nullptr && m01 != nullptr;
  if (mom && P < 2 * MR + 3) return (int)cudaErrorInvalidValue;
  const int smem = KPB * P * P * (int)sizeof(float);
  dim3 grid((K + KPB - 1) / KPB, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (mom)
    blend_kernel<true><<<grid, NTHREADS, smem, st>>>(
        (const __nv_bfloat16*)padded, xy, (__nv_bfloat16*)out, m10, m01, K,
        Hp, Wp, P);
  else
    blend_kernel<false><<<grid, NTHREADS, smem, st>>>(
        (const __nv_bfloat16*)padded, xy, (__nv_bfloat16*)out, nullptr,
        nullptr, K, Hp, Wp, P);
  return (int)cudaGetLastError();
}
