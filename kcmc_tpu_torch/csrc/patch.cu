// K2 extract_blended: per-keypoint patch cut plus separable bilinear
// blend, keypoint-first, bf16 in and out.
//
// Replaces kcmc_tpu/ops/pallas_patch.py::extract_blended
// (extract_blended_planes / _blended_kernel with with_moments=False),
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int KPB = 4;  // keypoints per block
constexpr int MAXP = 64;

__global__ void __launch_bounds__(NTHREADS)
blend_kernel(const __nv_bfloat16* __restrict__ padded,
             const float* __restrict__ xy, __nv_bfloat16* __restrict__ out,
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
}

}  // namespace

// padded (B, Hp, Wp) bf16, xy (B, K, 2) f32 -> out (B, K, P-1, P-1) bf16
// on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int kcmc_extract_blended(const void* padded, const float* xy,
                                    void* out, int B, int K, int Hp, int Wp,
                                    int P, void* stream) {
  if (P < 2 || P > MAXP) return (int)cudaErrorInvalidValue;
  const int smem = KPB * P * P * (int)sizeof(float);
  dim3 grid((K + KPB - 1) / KPB, B);
  blend_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)padded, xy, (__nv_bfloat16*)out, K, Hp, Wp, P);
  return (int)cudaGetLastError();
}
