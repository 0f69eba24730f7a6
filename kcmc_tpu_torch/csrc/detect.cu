// K1 detect_response: fused Harris response, NMS and subpixel fields,
// plus the descriptor-stage Gaussian blur computed on the same tile.
//
// Replaces kcmc_tpu/ops/pallas_detect.py::response_fields
// (_detect_kernel). Same semantics, pallas_detect.py:23-42:
//   * correlation-form taps (Sobel smooth _SM, difference _DF, the
//     Gaussian window and blur taps computed in float32 on the host);
//   * SAME zero padding for every convolution: pixels outside the frame
//     read 0, and the gradients are re-masked to the real frame before
//     the window sums;
//   * NMS is a separable max with -inf outside the frame, kept where
//     the response is >= that max;
//   * the subpixel fields are quadratic fits on the zero-extended
//     response, clipped to [-0.5, 0.5].
//
// Bound on the H100: memory. Per frame pixel it reads 4 bytes and
// writes 16 (nms, ox, oy, smooth) and does ~250 flops, so at B=32,
// 512x512 it moves 168 MB, about 50 us at 3.35 TB/s, against ~30 us of
// float32 arithmetic. The design keeps every intermediate on chip: one
// block per (frame, 32x32 output tile) stages the tile plus a 16-pixel
// halo (the reach of the default filters is 10) in shared memory and
// runs all the separable passes there, so device memory sees each input
// pixel about (64/32)^2 = 4 times (mostly from L2) and each output once.
// Every product and sum is an explicitly rounded float32 operation in
// the order of the plain PyTorch version (detect_response_plain), so the
// kernel and its plain version agree bit for bit and NMS near-ties fall
// the same way in both.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;
constexpr int HALO = 16;
constexpr int SL = TILE + 2 * HALO;  // staged slab side
constexpr int NPIX = SL * SL;
constexpr int NBUF = 5;
constexpr int MAXTAP = 17;  // taps of radius <= 8
constexpr int NTHREADS = 256;

struct Params {
  float gauss[MAXTAP];
  float smooth[MAXTAP];
  int gr;  // window radius
  int sr;  // blur radius (0 = no blur output)
  int nlo, nhi;  // NMS window offsets
  float harris_k;
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float at(const float* a, int y, int x) {
  return (y >= 0 && y < SL && x >= 0 && x < SL) ? a[y * SL + x] : 0.f;
}

// One tap chain along rows (VERT) or columns, accumulated in tap order:
// acc = t0*v[-r]; acc += t1*v[-r+1]; ...  Source value is a[p] or, with
// b, the product a[p]*b[p] (the structure-tensor entries).
template <bool VERT>
__device__ __forceinline__ float chain(const float* a, const float* b, int y,
                                       int x, const float* t, int r) {
  float acc = 0.f;
  for (int i = 0; i <= 2 * r; ++i) {
    int yy = VERT ? y - r + i : y;
    int xx = VERT ? x : x - r + i;
    float v = at(a, yy, xx);
    if (b != nullptr) v = fmul(v, at(b, yy, xx));
    float term = fmul(t[i], v);
    acc = (i == 0) ? term : fadd(acc, term);
  }
  return acc;
}

template <bool VERT>
__device__ void pass(const float* a, const float* b, float* dst,
                     const float* t, int r) {
  for (int p = threadIdx.x; p < NPIX; p += NTHREADS)
    dst[p] = chain<VERT>(a, b, p / SL, p % SL, t, r);
}

__global__ void __launch_bounds__(NTHREADS)
detect_kernel(const float* __restrict__ frames, float* __restrict__ nms,
              float* __restrict__ oxo, float* __restrict__ oyo,
              float* __restrict__ smooth, int H, int W, int tiles_x,
              Params prm) {
  extern __shared__ float sm[];
  float* S0 = sm;
  float* S1 = sm + NPIX;
  float* S2 = sm + 2 * NPIX;
  float* S3 = sm + 3 * NPIX;
  float* S4 = sm + 4 * NPIX;
  const float SMT[3] = {0.25f, 0.5f, 0.25f};
  const float DFT[3] = {0.5f, 0.0f, -0.5f};

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_x) * TILE;
  const int ox0 = (blockIdx.x % tiles_x) * TILE;
  const int y0 = oy0 - HALO, x0 = ox0 - HALO;  // frame coords of slab (0, 0)
  const size_t base = (size_t)b * H * W;
  const float* f = frames + base;

  auto real = [&](int sy, int sx) {
    int gy = y0 + sy, gx = x0 + sx;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };

  for (int p = threadIdx.x; p < NPIX; p += NTHREADS) {
    int sy = p / SL, sx = p % SL;
    S0[p] = real(sy, sx) ? f[(size_t)(y0 + sy) * W + (x0 + sx)] : 0.f;
  }
  __syncthreads();

  // free-ride blur: rows then columns, written for the output tile only
  if (prm.sr > 0) {
    pass<true>(S0, nullptr, S1, prm.smooth, prm.sr);
    __syncthreads();
    for (int q = threadIdx.x; q < TILE * TILE; q += NTHREADS) {
      int sy = HALO + q / TILE, sx = HALO + q % TILE;
      int gy = y0 + sy, gx = x0 + sx;
      if (gy < H && gx < W)
        smooth[base + (size_t)gy * W + gx] =
            chain<false>(S1, nullptr, sy, sx, prm.smooth, prm.sr);
    }
    __syncthreads();
  }

  // gx = diff_x(smooth_y(f)), gy = diff_y(smooth_x(f)), both masked
  pass<true>(S0, nullptr, S1, SMT, 1);
  __syncthreads();
  for (int p = threadIdx.x; p < NPIX; p += NTHREADS) {
    int sy = p / SL, sx = p % SL;
    S2[p] = real(sy, sx) ? chain<false>(S1, nullptr, sy, sx, DFT, 1) : 0.f;
  }
  __syncthreads();
  pass<false>(S0, nullptr, S1, SMT, 1);
  __syncthreads();
  for (int p = threadIdx.x; p < NPIX; p += NTHREADS) {
    int sy = p / SL, sx = p % SL;
    S3[p] = real(sy, sx) ? chain<true>(S1, nullptr, sy, sx, DFT, 1) : 0.f;
  }
  __syncthreads();

  // structure tensor under the Gaussian window: ixx -> S0, ixy -> S4,
  // iyy -> S2 (gx dead by then)
  pass<true>(S2, S2, S1, prm.gauss, prm.gr);
  __syncthreads();
  pass<false>(S1, nullptr, S0, prm.gauss, prm.gr);
  __syncthreads();
  pass<true>(S2, S3, S1, prm.gauss, prm.gr);
  __syncthreads();
  pass<false>(S1, nullptr, S4, prm.gauss, prm.gr);
  __syncthreads();
  pass<true>(S3, S3, S1, prm.gauss, prm.gr);
  __syncthreads();
  pass<false>(S1, nullptr, S2, prm.gauss, prm.gr);
  __syncthreads();

  // Harris response -> S3: det - (k * tr) * tr
  for (int p = threadIdx.x; p < NPIX; p += NTHREADS) {
    float ixx = S0[p], ixy = S4[p], iyy = S2[p];
    float det = fsub(fmul(ixx, iyy), fmul(ixy, ixy));
    float tr = fadd(ixx, iyy);
    S3[p] = fsub(det, fmul(fmul(prm.harris_k, tr), tr));
  }
  __syncthreads();

  // NMS, rows: S0 = max of the -inf-masked response over the row window
  auto neg = [&](int sy, int sx) {
    if (sy < 0 || sy >= SL || sx < 0 || sx >= SL || !real(sy, sx))
      return -INFINITY;
    return S3[sy * SL + sx];
  };
  for (int p = threadIdx.x; p < NPIX; p += NTHREADS) {
    int sy = p / SL, sx = p % SL;
    float m = neg(sy, sx);
    for (int d = prm.nlo; d <= prm.nhi; ++d)
      if (d) m = fmaxf(m, neg(sy + d, sx));
    S0[p] = m;
  }
  __syncthreads();

  // output tile: NMS columns, subpixel fits on the zero-extended response
  auto rc = [&](int sy, int sx) {
    return (sy >= 0 && sy < SL && sx >= 0 && sx < SL && real(sy, sx))
               ? S3[sy * SL + sx]
               : 0.f;
  };
  for (int q = threadIdx.x; q < TILE * TILE; q += NTHREADS) {
    int sy = HALO + q / TILE, sx = HALO + q % TILE;
    int gy = y0 + sy, gx = x0 + sx;
    if (gy >= H || gx >= W) continue;
    size_t o = base + (size_t)gy * W + gx;
    float m = S0[sy * SL + sx];
    for (int d = prm.nlo; d <= prm.nhi; ++d)
      if (d) m = fmaxf(m, at(S0, sy, sx + d) /* in-slab: reach < HALO */);
    float v = S3[sy * SL + sx];
    nms[o] = (v >= m) ? v : -INFINITY;

    float c = rc(sy, sx);
    float right = rc(sy, sx + 1), left = rc(sy, sx - 1);
    float dx = fmul(0.5f, fsub(right, left));
    float dxx = fadd(fsub(right, fmul(2.0f, c)), left);
    float ox = fabsf(dxx) > 1e-8f ? __fdiv_rn(-dx, dxx) : 0.f;
    oxo[o] = fminf(fmaxf(ox, -0.5f), 0.5f);
    float down = rc(sy + 1, sx), up = rc(sy - 1, sx);
    float dy = fmul(0.5f, fsub(down, up));
    float dyy = fadd(fsub(down, fmul(2.0f, c)), up);
    float oy = fabsf(dyy) > 1e-8f ? __fdiv_rn(-dy, dyy) : 0.f;
    oyo[o] = fminf(fmaxf(oy, -0.5f), 0.5f);
  }
}

}  // namespace

// frames (B, H, W) f32 -> nms, ox, oy[, smooth] (B, H, W) f32, on `stream`.
// gauss/smooth_taps are host arrays of 2*r+1 floats (smooth may be null
// with sr = 0). Returns cudaGetLastError() after the launch.
extern "C" int kcmc_detect_response(const float* frames, float* nms, float* ox,
                                    float* oy, float* smooth, int B, int H,
                                    int W, const float* gauss, int gr,
                                    const float* smooth_taps, int sr,
                                    int nms_size, float harris_k,
                                    void* stream) {
  if (gr < 1 || gr > (MAXTAP - 1) / 2 || sr < 0 || sr > (MAXTAP - 1) / 2)
    return (int)cudaErrorInvalidValue;
  Params prm;
  for (int i = 0; i < MAXTAP; ++i) {
    prm.gauss[i] = i <= 2 * gr ? gauss[i] : 0.f;
    prm.smooth[i] = (sr > 0 && i <= 2 * sr) ? smooth_taps[i] : 0.f;
  }
  prm.gr = gr;
  prm.sr = smooth != nullptr ? sr : 0;
  prm.nlo = -((nms_size - 1) / 2);
  prm.nhi = nms_size / 2;
  prm.harris_k = harris_k;
  const int smem = NBUF * NPIX * (int)sizeof(float);
  cudaFuncSetAttribute(detect_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles_y = (H + TILE - 1) / TILE;
  dim3 grid(tiles_x * tiles_y, B);
  detect_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      frames, nms, ox, oy, smooth, H, W, tiles_x, prm);
  return (int)cudaGetLastError();
}
