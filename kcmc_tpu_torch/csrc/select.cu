// K5 binned_select_rows: each 16-row block of bin-sorted patch rows times
// its own bin's (L, V) selection matrix, float32 accumulation, bf16 out.
//
// Replaces kcmc_tpu/ops/pallas_patch.py::binned_select_rows (the
// scalar-prefetch BlockSpec kernel, pallas_patch.py:1114/:1169):
//   out[b, kb*16 + r, :] = bf16(flat[b, kb*16 + r, :] @ sel[min(ibin[b, kb], nb-1)])
// for a GENERAL sel stack: this is a matrix product, not a gather, even
// though the describe route's sel (describe._SEL_ROT) is one-hot. With a
// one-hot sel every output is one product v * 1 plus zeros, so the result
// is exact in any summation order (bit-identical to the plain version);
// with a dense sel the float32 sums differ from the plain version's only
// in order (within one bf16 ulp after rounding).
//
// Bound on the H100. At the config-2 shapes (B=32, Kp=4368, L=961,
// V=512, nb=16) the function reads 268.6 MB of rows and 15.7 MB of sel
// and writes 143.1 MB: ~0.128 ms at 3.35 TB/s; it is 137.5 GFLOP of
// bf16 products, ~0.139 ms at the 989 TFLOP/s dense bf16 tensor rate.
// So it needs the tensor cores. A 16-row block is exactly the M of
// mma.sync.m16n8k16 (bf16 in, float32 accumulate).
//
// Design. One block of 16 warps takes G = 4 consecutive row blocks of one
// frame and all V columns (in chunks of 512). Runs of equal bins are
// long after the sort, so the G row blocks usually share a bin: the
// block then streams that bin's matrix through shared memory once, in
// 16-row k-slices (coalesced 16-byte loads), and all four row blocks
// multiply against it, a quarter of the sel traffic of one block per
// row block. A group that spans several bins makes one pass per distinct
// bin; in each pass only the warps whose row blocks carry that bin
// multiply. Warp w covers columns [64 (w % 8), +64) of the chunk for row
// blocks 2 (w / 8) and 2 (w / 8) + 1: 2 x 8 accumulator tiles of m16n8.
// A fragments are read straight from device memory (L = 961 is odd, so
// rows are only 2-byte aligned); the eight warps of a row block read the
// same A, which L1 serves. No wgmma/TMA yet: that is for a later PR.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ALIGN = 16;     // rows per block (the MMA's M)
constexpr int G = 4;          // row blocks per CUDA block
constexpr int NWARP = 16;
constexpr int NTHREADS = NWARP * 32;
constexpr int NCHUNK = 512;   // columns per pass over the chunk
constexpr int KS = 16;        // k-slice (the MMA's K)
constexpr int SBW = NCHUNK + 8;  // padded smem row (bank spread)

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(NTHREADS)
select_kernel(const uint16_t* __restrict__ flat, const int* __restrict__ ibin,
              const uint16_t* __restrict__ sel, uint16_t* __restrict__ out,
              int Kp, int L, int V, int nb) {
  __shared__ __align__(16) uint16_t sB[KS][SBW];
  __shared__ int bins[G];
  const int b = blockIdx.y;
  const int nblk = Kp / ALIGN;
  const int kb0 = blockIdx.x * G;
  const int tid = threadIdx.x;
  if (tid < G) {
    const int kb = kb0 + tid;
    bins[tid] = kb < nblk ? min(max(ibin[(size_t)b * nblk + kb], 0), nb - 1) : -1;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int cw = warp % 8;        // 64-column slice of the chunk
  const int r0 = 2 * (warp / 8);  // this warp's row blocks: r0, r0 + 1
  const uint16_t* fb = flat + (size_t)b * Kp * L;

  for (int nc = 0; nc < V; nc += NCHUNK) {
    float acc[2][8][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][j][q] = 0.0f;

    for (int p = 0; p < G; ++p) {
      const int pb = bins[p];
      bool seen = pb < 0;
      for (int q = 0; q < p; ++q) seen |= bins[q] == pb;
      if (seen) continue;  // uniform across the block
      const bool mine0 = bins[r0] == pb, mine1 = bins[r0 + 1] == pb;
      const uint16_t* sb = sel + (size_t)pb * L * V;
      for (int k0 = 0; k0 < L; k0 += KS) {
        __syncthreads();
        // stage sel[pb][k0:k0+16][nc:nc+512] (zero past L and V)
        for (int e = tid; e < KS * (NCHUNK / 8); e += NTHREADS) {
          const int kr = e / (NCHUNK / 8), c8 = (e % (NCHUNK / 8)) * 8;
          const int k = k0 + kr, n = nc + c8;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (k < L && n < V)  // V % 8 == 0: whole vectors
            v = *reinterpret_cast<const uint4*>(sb + (size_t)k * V + n);
          *reinterpret_cast<uint4*>(&sB[kr][c8]) = v;
        }
        __syncthreads();
        if (!(mine0 || mine1)) continue;
        uint32_t bf[8][2];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = cw * 64 + j * 8 + g;
          bf[j][0] = pack2(sB[2 * t][n], sB[2 * t + 1][n]);
          bf[j][1] = pack2(sB[2 * t + 8][n], sB[2 * t + 9][n]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!(r ? mine1 : mine0)) continue;
          const uint16_t* a = fb + (size_t)(kb0 + r0 + r) * ALIGN * L;
          const int ka = k0 + 2 * t, kc = ka + 8;
          auto ld = [&](int row, int k) -> uint16_t {
            return k < L ? a[(size_t)row * L + k] : (uint16_t)0;
          };
          uint32_t af[4];
          af[0] = pack2(ld(g, ka), ld(g, ka + 1));
          af[1] = pack2(ld(g + 8, ka), ld(g + 8, ka + 1));
          af[2] = pack2(ld(g, kc), ld(g, kc + 1));
          af[3] = pack2(ld(g + 8, kc), ld(g + 8, kc + 1));
#pragma unroll
          for (int j = 0; j < 8; ++j) mma16816(acc[r][j], af, bf[j][0], bf[j][1]);
        }
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kb = kb0 + r0 + r;
      if (kb >= nblk) continue;
      uint16_t* o = out + ((size_t)b * Kp + (size_t)kb * ALIGN) * V;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = nc + cw * 64 + j * 8 + 2 * t;
        if (n >= V) continue;
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc[r][j][0], acc[r][j][1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc[r][j][2], acc[r][j][3]);
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)g * V + n) = lo;
        *reinterpret_cast<__nv_bfloat162*>(o + (size_t)(g + 8) * V + n) = hi;
      }
    }
  }
}

}  // namespace

// flat (B, Kp, L) bf16, ibin (B, Kp / 16) int32, sel (nb, L, V) bf16 ->
// out (B, Kp, V) bf16 on `stream`. Kp % 16 == 0 and V % 8 == 0. Returns
// cudaGetLastError() after the launch.
extern "C" int kcmc_binned_select_rows(const void* flat, const int* ibin,
                                       const void* sel, void* out, int B,
                                       int Kp, int L, int V, int nb,
                                       void* stream) {
  if (B < 1 || Kp % ALIGN || V % 8 || L < 1 || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int nblk = Kp / ALIGN;
  dim3 grid((nblk + G - 1) / G, B);
  select_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)flat, ibin, (const uint16_t*)sel, (uint16_t*)out, Kp,
      L, V, nb);
  return (int)cudaGetLastError();
}
