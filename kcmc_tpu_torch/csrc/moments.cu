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
// Summation order (the TPU kernel's, pallas_patch.py:1256-1274, and the
// plain version's, cuda_moments.moment_maps_plain). The disc is walked as
// bands of rows of equal half-width w, ascending w and ascending dy within
// a width (BANDS below). For each input row and width the TPU kernel forms
// once the dx-weighted row sum hx_w and the box row sum sx_w over
// dx = -w..w in ascending order, each from +0.0; then, per output, in
// band order, m10 += hx and m01 = fma(dy, sx, m01), both from +0.0.
// hx_w[r][c] and sx_w[r][c] are the same float whichever output reads
// them, so this kernel also forms each of them once, and the maps match
// the plain version bit for bit:
//   * dx * v is exact (a bf16 value times an integer <= 7); the product
//     of each |dx| is formed once per column and a negative dx subtracts
//     it (h - p is h + (-p) in IEEE arithmetic, signed zeros included);
//   * width 0 gives hx = +0.0, whose two m10 adds leave the +0.0 start
//     as it was, so they are skipped; sx_7 feeds only dy = 0, which m01
//     skips, so it is not formed;
//   * m01's multiply-adds are explicit __fmaf_rn, as the reference's CPU
//     evaluation contracts them; the build's --fmad=false contracts
//     nothing else.
//
// Bound on the H100: memory. At config 2 (B=32, 544x544 padded) it reads
// 18.9 MB of bf16 and writes 2 x 36 MB of float32 maps: ~27 us at 3.35
// TB/s. The function needs 10 row sums per input pixel (103 rounded
// operations) and 27 accumulation steps per output; every operation is
// one rounded instruction. A block of 256 threads owns a 50 x 16 output
// tile. It stages the tile's 64 input rows as float32 (every bf16 load of
// a warp issued before its stores; +0.0 past the frame), then, four
// adjacent columns an item and one item a thread (five 16-byte shared
// loads serve the quad's 18 inputs), forms the 10 row sums of every
// staged row into shared memory, and after one barrier finishes each
// output quad from its 27 sums with 16-byte shared loads at compile-time
// offsets (the BANDS table drives them, as a fold over its indices).
// Widths are template parameters, so every tap loop is unrolled with no
// conversion and no branch, and nothing divides at run time (MUFU.RCP 0
// in the SASS). Per output that is ~159 float32 instructions (the row
// sums of the 14 halo rows included) and ~195 bytes of shared traffic.
// The arithmetic is not what sets its time: the maps' float32 stores (8-
// byte pairs; a row of 530 floats is not 16-byte aligned) and each tile's
// staging latency are.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int MR = 7;
constexpr int TW = 16;  // output tile width: four columns a thread
constexpr int TH = 50;  // output tile height: TH + 14 = 64 staged rows, one item a thread
constexpr int NT = 256;  // threads a block
constexpr int RH = TH + 2 * MR;  // staged input rows
constexpr int QPR = TW / 4;  // column quads a row (a power of two)
// floats a staged row holds: TW + 14 inputs and 2 unread, padded so that
// the 16-byte loads of a quarter warp (two rows at TW = 16) hit 32 banks
constexpr int TSTRIDE = TW == 16 ? 48 : TW + 16;
constexpr int NBAND = 2 * MR + 1;

// (half-width w, dy) of the disc's rows in the reference's order:
// ascending w, ascending dy within a width (pallas_patch
// _moment_band_structure).
constexpr int BANDS[NBAND][2] = {
    {0, -7}, {0, 7}, {3, -6}, {3, 6}, {4, -5}, {4, 5}, {5, -4}, {5, 4},
    {6, -3}, {6, -2}, {6, -1}, {6, 1}, {6, 2}, {6, 3}, {7, 0},
};
__host__ __device__ constexpr int band_w(int n) { return BANDS[n][0]; }
__host__ __device__ constexpr int band_dy(int n) { return BANDS[n][1]; }

// the row sums a staged row keeps, by width: sx_0, (sx_w, hx_w) for
// w = 3..6, hx_7 (width 0's hx is +0.0 and sx_7 feeds only dy = 0)
enum { S0, S3, H3, S4, H4, S5, H5, S6, H6, H7, NVAL };
__host__ __device__ constexpr int sx_of(int w) {
  return w == 0 ? S0 : w == 3 ? S3 : w == 4 ? S4 : w == 5 ? S5 : w == 6 ? S6 : -1;
}
__host__ __device__ constexpr int hx_of(int w) {
  return w == 3 ? H3 : w == 4 ? H4 : w == 5 ? H5 : w == 6 ? H6 : w == 7 ? H7 : -1;
}
constexpr int SMEM_BYTES = (RH * TSTRIDE + NVAL * RH * TW) * (int)sizeof(float);

// sum of v[dx], dx = -W..W ascending, from +0.0
template <int W>
__device__ __forceinline__ float box_sum(const float* v) {
  float s = 0.0f;
#pragma unroll
  for (int dx = -W; dx <= W; ++dx) s = __fadd_rn(s, v[dx]);
  return s;
}

// sum of dx * v[dx], dx = -W..W ascending without 0, from +0.0; pl[k] and
// pr[k] are k * v[-k] and k * v[k]
template <int W>
__device__ __forceinline__ float moment_sum(const float* pl, const float* pr) {
  float h = 0.0f;
#pragma unroll
  for (int k = W; k >= 1; --k) h = __fsub_rn(h, pl[k]);
#pragma unroll
  for (int k = 1; k <= W; ++k) h = __fadd_rn(h, pr[k]);
  return h;
}

__device__ __forceinline__ void add4(float4& a, const float4 h) {
  a.x = __fadd_rn(a.x, h.x);
  a.y = __fadd_rn(a.y, h.y);
  a.z = __fadd_rn(a.z, h.z);
  a.w = __fadd_rn(a.w, h.w);
}

__device__ __forceinline__ void fma4(float4& a, float dy, const float4 s) {
  a.x = __fmaf_rn(dy, s.x, a.x);
  a.y = __fmaf_rn(dy, s.y, a.y);
  a.z = __fmaf_rn(dy, s.z, a.z);
  a.w = __fmaf_rn(dy, s.w, a.w);
}

// band N of an output quad whose row sums start at `base`: m10 += hx
// (width 0 adds +0.0 to the +0.0 start: skipped), m01 = fma(dy, sx, m01)
// (dy = 0 skipped); band dy reads staged row li + dy + MR
template <int N>
__device__ __forceinline__ void band_step(float4& a10, float4& a01, const float* base) {
  constexpr int w = band_w(N), dy = band_dy(N);
  if constexpr (w != 0) {
    static_assert(hx_of(w) >= 0, "a width without hx");
    add4(a10, *reinterpret_cast<const float4*>(base + (hx_of(w) * RH + dy + MR) * TW));
  }
  if constexpr (dy != 0) {
    static_assert(sx_of(w) >= 0, "a width without sx");
    fma4(a01, (float)dy, *reinterpret_cast<const float4*>(base + (sx_of(w) * RH + dy + MR) * TW));
  }
}

template <int... N>
__device__ __forceinline__ void band_steps(std::integer_sequence<int, N...>, float4& a10,
                                           float4& a01, const float* base) {
  (band_step<N>(a10, a01, base), ...);
}

__global__ void __launch_bounds__(NT)
moments_kernel(const __nv_bfloat16* __restrict__ padded,
               float* __restrict__ m10, float* __restrict__ m01, int Hp,
               int Wp) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                 // [RH][TSTRIDE] input rows
  float* sums = smem + RH * TSTRIDE;  // [NVAL][RH][TW] row sums
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * TH, j0 = blockIdx.x * TW;
  const int Hm = Hp - 2 * MR, Wm = Wp - 2 * MR;
  const __nv_bfloat16* src = padded + (size_t)b * Hp * Wp;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // 1. the tile's input rows as float32 (+0.0 past the frame); every
  // load of a warp's rows before any store
  constexpr int NW = NT / 32, RPW = (RH + NW - 1) / NW, CPW = (TW + 16 + 31) / 32;
  float in[RPW][CPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * NW, gr = i0 + r;
#pragma unroll
    for (int m = 0; m < CPW; ++m) {
      const int c = lane + 32 * m, gc = j0 + c;
      in[k][m] = r < RH && c < TW + 16 && gr < Hp && gc < Wp
                     ? __bfloat162float(src[(size_t)gr * Wp + gc]) : 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * NW;
#pragma unroll
    for (int m = 0; m < CPW; ++m) {
      const int c = lane + 32 * m;
      if (r < RH && c < TW + 16) tile[r * TSTRIDE + c] = in[k][m];
    }
  }
  __syncthreads();

  // 2. the row sums of every staged row, four columns an item
  for (int it = threadIdx.x; it < RH * QPR; it += NT) {
    const int r = it / QPR, q = it % QPR;
    float t[20];  // tile columns 4q .. 4q + 19: the quad's 18 inputs
    const float4* tp = reinterpret_cast<const float4*>(tile + r * TSTRIDE + 4 * q);
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const float4 f = tp[m];
      t[4 * m] = f.x;
      t[4 * m + 1] = f.y;
      t[4 * m + 2] = f.z;
      t[4 * m + 3] = f.w;
    }
    float o[NVAL][4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float* v = t + c + MR;  // v[dx], dx = -7..7
      float pl[MR + 1], pr[MR + 1];
      pl[1] = v[-1];
      pr[1] = v[1];
#pragma unroll
      for (int k = 2; k <= MR; ++k) {
        pl[k] = __fmul_rn((float)k, v[-k]);
        pr[k] = __fmul_rn((float)k, v[k]);
      }
      o[S0][c] = __fadd_rn(0.0f, v[0]);
      o[S3][c] = box_sum<3>(v);
      o[H3][c] = moment_sum<3>(pl, pr);
      o[S4][c] = box_sum<4>(v);
      o[H4][c] = moment_sum<4>(pl, pr);
      o[S5][c] = box_sum<5>(v);
      o[H5][c] = moment_sum<5>(pl, pr);
      o[S6][c] = box_sum<6>(v);
      o[H6][c] = moment_sum<6>(pl, pr);
      o[H7][c] = moment_sum<7>(pl, pr);
    }
#pragma unroll
    for (int n = 0; n < NVAL; ++n)
      *reinterpret_cast<float4*>(sums + (n * RH + r) * TW + 4 * q) =
          make_float4(o[n][0], o[n][1], o[n][2], o[n][3]);
  }
  __syncthreads();

  // 3. each output quad from its 27 row sums, in BANDS order
  for (int it = threadIdx.x; it < TH * QPR; it += NT) {
    const int li = it / QPR, q = it % QPR;
    const int i = i0 + li, j = j0 + 4 * q;
    if (i >= Hm || j >= Wm) continue;
    float4 a10 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 a01 = a10;
    band_steps(std::make_integer_sequence<int, NBAND>{}, a10, a01, sums + li * TW + 4 * q);

    const size_t o = ((size_t)b * Hm + i) * Wm + j;
    const float x10[4] = {a10.x, a10.y, a10.z, a10.w};
    const float x01[4] = {a01.x, a01.y, a01.z, a01.w};
    if ((Wm & 1) == 0) {
      // Wm and j even: each pair is whole and 8-byte aligned
#pragma unroll
      for (int c = 0; c < 4; c += 2)
        if (j + c < Wm) {
          *reinterpret_cast<float2*>(m10 + o + c) = make_float2(x10[c], x10[c + 1]);
          *reinterpret_cast<float2*>(m01 + o + c) = make_float2(x01[c], x01[c + 1]);
        }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j + c < Wm) {
          m10[o + c] = x10[c];
          m01[o + c] = x01[c];
        }
    }
  }
}

}  // namespace

// padded (B, Hp, Wp) bf16 -> m10, m01 (B, Hp - 14, Wp - 14) f32 on
// `stream`; the maps 8-byte aligned. Returns cudaGetLastError() after the
// launch (or a refused shared-memory size).
extern "C" int kcmc_moment_maps(const void* padded, float* m10, float* m01,
                                int B, int Hp, int Wp, void* stream) {
  const int Hm = Hp - 2 * MR, Wm = Wp - 2 * MR;
  if (B < 1 || B > 65535 || Hm < 1 || Wm < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Wm + TW - 1) / TW, (Hm + TH - 1) / TH, B);
  moments_kernel<<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)padded, m10, m01, Hp, Wp);
  return (int)cudaGetLastError();
}
