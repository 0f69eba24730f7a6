// K11 extract_patches: raw (P, P) float32 patches at integer origins.
//
// Replaces kcmc_tpu/ops/pallas_patch.py::extract_patches (_patch_kernel):
//   patches[b, k, i, j] = padded[b, oy[b, k] + i, ox[b, k] + j]
// for (B, Hp, Wp) float32 frames and (B, K) int32 origins, output
// (B, K, P, P) float32. The contract covers 0 <= oy <= Hp - P and
// 0 <= ox <= Wp - P; the kernel clamps each origin into that range, so it
// never reads out of bounds. The TPU kernel's K padding to 8, its aligned
// slab reads and its SMEM batch chunking are layout: this kernel takes any
// B and K in one launch. A copy has no rounding, so the kernel, its plain
// version and interpret mode agree bit for bit.
//
// Bound on the H100: memory. It writes B * K * P^2 * 4 bytes (51.4 MB at
// B=32, K=512, P=28, ~15 us at 3.35 TB/s) and reads the distinct padded
// pixels the origins cover. One block takes KPB keypoints of one frame;
// its threads walk the KPB windows element by element in output order, so
// the writes are one contiguous coalesced run and the reads coalesce
// along each window row.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int KPB = 8;  // keypoints per block

__global__ void __launch_bounds__(NTHREADS)
patch_kernel(const float* __restrict__ padded, const int* __restrict__ oy,
             const int* __restrict__ ox, float* __restrict__ out, int K,
             int Hp, int Wp, int P) {
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * KPB;
  const int nk = min(KPB, K - k0);
  __shared__ int oys[KPB], oxs[KPB];
  if (threadIdx.x < nk) {
    const size_t s = (size_t)b * K + k0 + threadIdx.x;
    oys[threadIdx.x] = min(max(oy[s], 0), Hp - P);
    oxs[threadIdx.x] = min(max(ox[s], 0), Wp - P);
  }
  __syncthreads();
  const float* frame = padded + (size_t)b * Hp * Wp;
  const int PP = P * P;
  float* dst = out + ((size_t)b * K + k0) * PP;
  for (int e = threadIdx.x; e < nk * PP; e += NTHREADS) {
    const int j = e / PP, q = e % PP;
    const int i = q / P, c = q % P;
    dst[e] = frame[(size_t)(oys[j] + i) * Wp + oxs[j] + c];
  }
}

}  // namespace

// padded (B, Hp, Wp) f32, oy and ox (B, K) i32 -> out (B, K, P, P) f32, on
// `stream` (needs 1 <= P <= Hp and P <= Wp). Returns cudaGetLastError()
// after the launch.
extern "C" int kcmc_extract_patches(const float* padded, const int* oy,
                                    const int* ox, float* out, int B, int K,
                                    int Hp, int Wp, int P, void* stream) {
  if (P < 1 || P > Hp || P > Wp) return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return (int)cudaSuccess;
  dim3 grid((K + KPB - 1) / KPB, B);
  patch_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      padded, oy, ox, out, K, Hp, Wp, P);
  return (int)cudaGetLastError();
}
