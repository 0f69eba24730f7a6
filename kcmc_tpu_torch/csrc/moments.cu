// K4 moment_maps: ORB intensity-centroid disc moments (m10, m01) at every
// pixel of an edge-padded bf16 batch.
//
// Replaces kcmc_tpu/ops/pallas_patch.py::moment_maps (the strip kernel of
// the bins-first oriented describe route, pallas_patch.py:1214/:1276).
// Output (i, j) is the disc of radius MR = 7 centred on padded pixel
// (i + MR, j + MR):
//   m10 = sum dx * p[i+MR+dy][j+MR+dx],  m01 = sum dy * p[...]
// over dx^2 + dy^2 <= 49, i.e. the VALID correlation with
// describe._MOMENT_KERNELS.
//
// Summation order. The TPU kernel walks the disc as bands of rows of equal
// half-width w (ascending w; within a band ascending dy). For each band
// row it forms the dx-weighted sum hx and the box sum sx over
// dx = -w..w in ascending order, then m10 += hx and m01 += dy * sx. This
// kernel evaluates exactly that sequence for each output pixel (table
// BANDS below, in the same order), so it matches its plain version
// (cuda_moments.moment_maps_plain) bit for bit:
//   * dx * v is exact (a bf16 value times an integer <= 7), so hx and sx
//     are plain rounded adds;
//   * m01 += dy * sx is a fused multiply-add: the reference's CPU
//     evaluation contracts it (the uncontracted form differs from
//     interpret mode in ~1 of 10^4 outputs), so it is an explicit
//     __fmaf_rn here and the build's --fmad=false contracts nothing else.
//
// Bound on the H100: memory. At B=32 and 544x544 padded input it reads
// 18.9 MB of bf16 and writes 2 x 36 MB of float32 maps: ~27 us at
// 3.35 TB/s. The arithmetic is ~450 float32 operations per output pixel
// (the band sums are recomputed per output to keep the reference's
// order), ~4 GFLOP per batch. Each block stages a TH x TW output tile
// plus its 7-px halo in shared memory once (converted to float32), so
// device memory is read about (TH+14)(TW+14)/(TH*TW) = 2.3 times; the
// band sums then read shared memory, conflict-free across a warp, which
// is what bounds this first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MR = 7;
constexpr int TW = 64;  // output tile width (threads in x)
constexpr int TH = 16;  // output tile height
constexpr int TY = 4;   // threads in y; each thread computes TH / TY rows
constexpr int SW = TW + 2 * MR;
constexpr int SH = TH + 2 * MR;
constexpr int NBAND = 2 * MR + 1;

// (half-width w, dy) of the disc's rows in the reference's order:
// ascending w, ascending dy within a width (pallas_patch
// _moment_band_structure).
__constant__ int BANDS[NBAND][2] = {
    {0, -7}, {0, 7}, {3, -6}, {3, 6}, {4, -5}, {4, 5}, {5, -4}, {5, 4},
    {6, -3}, {6, -2}, {6, -1}, {6, 1}, {6, 2}, {6, 3}, {7, 0},
};

__global__ void __launch_bounds__(TW * TY)
moments_kernel(const __nv_bfloat16* __restrict__ padded,
               float* __restrict__ m10, float* __restrict__ m01, int Hp,
               int Wp) {
  __shared__ float tile[SH][SW];
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int Hm = Hp - 2 * MR, Wm = Wp - 2 * MR;
  const __nv_bfloat16* src = padded + (size_t)b * Hp * Wp;
  const int tid = threadIdx.y * TW + threadIdx.x;
  for (int e = tid; e < SH * SW; e += TW * TY) {
    const int r = i0 + e / SW, c = j0 + e % SW;
    tile[e / SW][e % SW] =
        (r < Hp && c < Wp) ? __bfloat162float(src[(size_t)r * Wp + c]) : 0.0f;
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  if (j >= Wm) return;
  for (int k = threadIdx.y; k < TH; k += TY) {
    const int i = i0 + k;
    if (i >= Hm) break;
    float a10 = 0.0f, a01 = 0.0f;
#pragma unroll
    for (int n = 0; n < NBAND; ++n) {
      const int w = BANDS[n][0], dy = BANDS[n][1];
      const float* row = &tile[k + MR + dy][threadIdx.x + MR];
      float hx = 0.0f, sx = 0.0f;
      for (int dx = -w; dx <= w; ++dx) {
        const float v = row[dx];
        sx = __fadd_rn(sx, v);
        if (dx) hx = __fadd_rn(hx, __fmul_rn((float)dx, v));
      }
      a10 = __fadd_rn(a10, hx);
      if (dy) a01 = __fmaf_rn((float)dy, sx, a01);
    }
    const size_t o = ((size_t)b * Hm + i) * Wm + j;
    m10[o] = a10;
    m01[o] = a01;
  }
}

}  // namespace

// padded (B, Hp, Wp) bf16 -> m10, m01 (B, Hp - 14, Wp - 14) f32 on
// `stream`. Returns cudaGetLastError() after the launch.
extern "C" int kcmc_moment_maps(const void* padded, float* m10, float* m01,
                                int B, int Hp, int Wp, void* stream) {
  const int Hm = Hp - 2 * MR, Wm = Wp - 2 * MR;
  if (B < 1 || Hm < 1 || Wm < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((Wm + TW - 1) / TW, (Hm + TH - 1) / TH, B);
  dim3 block(TW, TY);
  moments_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)padded, m10, m01, Hp, Wp);
  return (int)cudaGetLastError();
}
