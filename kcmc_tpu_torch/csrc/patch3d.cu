// K10 extract_blended_3d: per-keypoint trilinear 3D patches,
// keypoint-first, float32.
//
// Replaces kcmc_tpu/ops/pallas_patch.py::extract_blended_3d
// (_blended3d_kernel). For keypoint (x, y, z) of volume b it reads the
// (Pz, Pxy, Pxy) slab of the edge-padded blur at origin
// (floor(z) + 1, floor(y) + 1, floor(x) + 1) (reads past the padded volume
// clamp to its edge, as the Pallas wrapper's extra edge padding does) and
// writes the (Pz-1, Pxy-1, Pxy-1) trilinear resample at the fractional
// part, grouped as the Pallas kernel groups it (pallas_patch.py:925-937):
// a y-lerp of each slice, then an x-lerp, then a z-lerp of adjacent
// blended slices. The reference's CPU evaluation (interpret mode) contracts
// the three lerps into these fused multiply-adds (0 of 80k float32 outputs
// differ):
//   yb  = fma(fy, s[z][y+1][x], (1 - fy) * s[z][y][x])
//   xb  = fma(1 - fx, yb[z][y][x], fx * yb[z][y][x+1])
//   out = fma(1 - fz, xb[z][y][x], fz * xb[z+1][y][x])
// so the kernel issues them as explicit __fmaf_rn, every other operation
// as an explicitly rounded __fmul_rn / __fsub_rn, and the build adds
// --fmad=false: kernel, plain version and interpret mode agree bit for bit.
//
// Bound on the H100: memory. At config 5 (B=8, K=512, Pz=8, Pxy=20) it
// writes 41.4 MB of patches and reads the union of the slabs (about 30 MB
// on config 5's scenes), ~0.02 ms at 3.35 TB/s; the arithmetic is ~0.1
// GFLOP. One block per keypoint stages its 12.8 KB slab in shared memory
// once (every output reads eight of its voxels) and writes the keypoint's
// outputs as one contiguous coalesced run.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
blend3d_kernel(const float* __restrict__ padded, const float* __restrict__ xyz,
               float* __restrict__ out, int K, int Dp, int Hp, int Wp, int Pz,
               int Pxy) {
  extern __shared__ float slab[];  // Pz x Pxy x Pxy
  const int k = blockIdx.x, b = blockIdx.y;
  const float* p = xyz + ((size_t)b * K + k) * 3;
  const float x = p[0], y = p[1], z = p[2];
  const float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  const float fx = __fsub_rn(x, flx), fy = __fsub_rn(y, fly);
  const float fz = __fsub_rn(z, flz);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const float gz = __fsub_rn(1.0f, fz);
  const int ox = (int)flx + 1, oy = (int)fly + 1, oz = (int)flz + 1;
  const float* vol = padded + (size_t)b * Dp * Hp * Wp;

  const int PP = Pxy * Pxy;
  for (int e = threadIdx.x; e < Pz * PP; e += NTHREADS) {
    const int zz = min(max(oz + e / PP, 0), Dp - 1);
    const int yy = min(max(oy + (e % PP) / Pxy, 0), Hp - 1);
    const int xx = min(max(ox + e % Pxy, 0), Wp - 1);
    slab[e] = vol[((size_t)zz * Hp + yy) * Wp + xx];
  }
  __syncthreads();

  const int Pb = Pxy - 1;
  const int n_out = (Pz - 1) * Pb * Pb;
  float* o = out + ((size_t)b * K + k) * n_out;
  for (int e = threadIdx.x; e < n_out; e += NTHREADS) {
    const int zz = e / (Pb * Pb), r = e % (Pb * Pb);
    const int yy = r / Pb, xx = r % Pb;
    float xb[2];
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
      const float* s0 = slab + (zz + dz) * PP + yy * Pxy + xx;  // row y
      const float* s1 = s0 + Pxy;                               // row y+1
      const float yb0 = __fmaf_rn(fy, s1[0], __fmul_rn(gy, s0[0]));
      const float yb1 = __fmaf_rn(fy, s1[1], __fmul_rn(gy, s0[1]));
      xb[dz] = __fmaf_rn(gx, yb0, __fmul_rn(fx, yb1));
    }
    o[e] = __fmaf_rn(gz, xb[0], __fmul_rn(fz, xb[1]));
  }
}

}  // namespace

// padded (B, Dp, Hp, Wp) f32, xyz (B, K, 3) f32 -> out (B, K, Pz-1, Pxy-1,
// Pxy-1) f32 on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int kcmc_extract_blended_3d(const float* padded, const float* xyz,
                                       float* out, int B, int K, int Dp,
                                       int Hp, int Wp, int Pz, int Pxy,
                                       void* stream) {
  if (B < 1 || K < 1 || Pz < 2 || Pxy < 2 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = Pz * Pxy * Pxy * (int)sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(blend3d_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  blend3d_kernel<<<dim3(K, B), NTHREADS, smem, (cudaStream_t)stream>>>(
      padded, xyz, out, K, Dp, Hp, Wp, Pz, Pxy);
  return (int)cudaGetLastError();
}
