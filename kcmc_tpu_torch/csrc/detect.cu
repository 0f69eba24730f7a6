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
// Every product and sum is an explicitly rounded float32 operation in the
// order of the plain PyTorch version (detect_response_plain): each tap
// chain is acc = t0 v[-r], then acc += t_i v[i] in tap order, and the
// structure-tensor products are formed once per pixel (the same operands,
// the same bits), so kernel and plain version agree bit for bit.
//
// Bound on the H100: memory. Per frame pixel it reads 4 bytes and writes
// 16 (nms, ox, oy, smooth) and the function needs ~230 flops, so at B=32,
// 512x512 it moves 168 MB, ~50 us at 3.35 TB/s, against ~29 us of
// float32 arithmetic. Without fused multiply-adds every tap is a multiply
// and an add, so the arithmetic is what a kernel can hope to approach.
// One block per (frame, TH x TW output tile) stages the tile and a halo
// of the reach that the parameters imply (not a fixed one) in shared
// memory, and computes each stage only on the region the next reads:
//   region          rows x cols (tile coordinates)  stage
//   IN              T +- h                          the staged frame
//   BV, smooth      T x (T +- sr), T                blur, rows then cols
//   G: gx, gy, P    T +- e, e = m + gr              Sobel gradients, the
//                                                   three products, once
//   WV              (T +- m) x (T +- e)             window sums, rows
//   RESP            T +- m, m = max(nms reach, 1)   window sums, cols, and
//                                                   the Harris response
//   RMAX            T x (T +- m)                    NMS, rows
//   outputs         T                               NMS, cols; subpixel
// Each separable pass is a template over its radius (a switch on the
// parameter picks it, once per block): a thread loads a run of NP + 2r
// values into registers and forms NP outputs, so a tap is one multiply
// and one add on registers, every read is inside the staged regions by
// construction, and no tap is bounds-checked. Vertical passes give
// consecutive threads consecutive columns; horizontal passes consecutive
// rows, on odd row strides, so shared-memory reads do not conflict. The
// frame is staged by 16-byte loads where W is a multiple of 4 (whole
// vectors lie inside or outside the frame) and by 4-byte loads otherwise;
// out-of-frame pixels are written as 0, the SAME padding. The outputs
// leave in one coalesced pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 64 x 32 tiles of 512 threads measured fastest on the H100 of the tile
// shapes and block sizes tried (PERF.md)
constexpr int TW = 64;  // output tile columns (a multiple of 4)
constexpr int TH = 32;  // output tile rows (a multiple of 8)
constexpr int NTHREADS = 512;
constexpr int MAXR = 8;  // window and blur radii <= 8
constexpr int MAXTAP = 2 * MAXR + 1;
constexpr int NP = 4;  // outputs per item of a separable pass
constexpr int NG = 8;  // rows per item of the gradient pass
static_assert(TW % 4 == 0 && TH % 8 == 0 && TH >= NP && TH >= NG, "tile shape");

struct Params {
  float gauss[MAXTAP];
  float smooth[MAXTAP];
  int gr;  // window radius
  int sr;  // blur radius (0 = no blur output)
  int nlo, nhi;  // NMS window offsets
  float harris_k;
};

// Shared-memory layout of one block, a function of the parameters alone
// (host and device compute it alike). Offsets and strides in floats.
struct Layout {
  int m, e, h, hx;  // margins: response, gradients; staged halo rows, cols
  int inw, inh;     // staged input (stride inw: 16-byte rows)
  int bvw, s_bv;    // blur row pass: TH x bvw
  int gw, gh, s_g;  // gradient region; the window row pass is rh x gw
  int rw, rh, s_r;  // response region
  int o_p, o_resp;  // region Y: products P, then RESP
  int o_bv, o_sm;   // region Z: BV and the blur output (TH x TW, stride TW + 1)
  int total;        // region X (IN, then WV, then RMAX) at 0
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline Layout layout(const Params& p) {
  Layout L;
  L.m = imax(imax(-p.nlo, p.nhi), 1);
  L.e = L.m + p.gr;
  L.h = imax(p.sr, L.e + 1);
  L.hx = (L.h + 3) & ~3;
  L.inw = TW + 2 * L.hx;
  L.inh = TH + 2 * L.h;
  L.bvw = TW + 2 * p.sr;
  L.s_bv = L.bvw | 1;
  L.gw = TW + 2 * L.e;
  L.gh = TH + 2 * L.e;
  L.s_g = L.gw | 1;
  L.rw = TW + 2 * L.m;
  L.rh = TH + 2 * L.m;
  L.s_r = L.rw | 1;
  const int x = imax(imax(L.inh * L.inw, 3 * L.rh * L.s_g), TH * L.s_r);
  const int y = imax(3 * L.gh * L.s_g, L.rh * L.s_r);
  L.o_p = L.o_resp = (x + 3) & ~3;
  L.o_bv = L.o_p + y;
  L.o_sm = L.o_bv + (p.sr > 0 ? TH * L.s_bv : 0);
  L.total = L.o_sm + (p.sr > 0 ? TH * (TW + 1) : 0);
  return L;
}

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

// NP outputs of one tap chain from NP + 2R values in registers:
// o[j] = t0 v[j], then += t_i v[j + i], each rounded.
template <int R>
__device__ __forceinline__ void chains(const float* t, const float (&v)[NP + 2 * R],
                                       float (&o)[NP]) {
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float acc = fmul(t[0], v[j]);
#pragma unroll
    for (int i = 1; i <= 2 * R; ++i) acc = fadd(acc, fmul(t[i], v[j + i]));
    o[j] = acc;
  }
}

// Row pass: dst(r, c) = chain over src(r + i, c), r < nr, c < nc; src is
// the first tap of dst(0, 0). Items of NP rows of one column, columns
// fastest; the last item of a column overlaps the one before (nr >= NP).
template <int R>
__device__ __forceinline__ void vpass(const float* src, int ss, float* dst, int ds, int nr,
                                      int nc, const float* t) {
  const int nch = (nr + NP - 1) / NP;
  for (int it = threadIdx.x; it < nch * nc; it += NTHREADS) {
    const int c = it % nc;
    const int r0 = min((it / nc) * NP, nr - NP);
    float v[NP + 2 * R], o[NP];
#pragma unroll
    for (int i = 0; i < NP + 2 * R; ++i) v[i] = src[(r0 + i) * ss + c];
    chains<R>(t, v, o);
#pragma unroll
    for (int j = 0; j < NP; ++j) dst[(r0 + j) * ds + c] = o[j];
  }
}

// Column pass: dst(r, c) = chain over src(r, c + i). Items of NP columns
// of one row, rows fastest (odd strides: no bank conflicts).
template <int R>
__device__ __forceinline__ void hpass(const float* src, int ss, float* dst, int ds, int nr,
                                      int nc, const float* t) {
  const int nch = (nc + NP - 1) / NP;
  for (int it = threadIdx.x; it < nch * nr; it += NTHREADS) {
    const int r = it % nr;
    const int c0 = min((it / nr) * NP, nc - NP);
    float v[NP + 2 * R], o[NP];
#pragma unroll
    for (int i = 0; i < NP + 2 * R; ++i) v[i] = src[r * ss + c0 + i];
    chains<R>(t, v, o);
#pragma unroll
    for (int j = 0; j < NP; ++j) dst[r * ds + c0 + j] = o[j];
  }
}

// The window's column pass on the three planes and the Harris response,
// det - (k tr) tr, into RESP.
template <int R>
__device__ __forceinline__ void window_cols(const float* wv, int plane, int sg, float* resp,
                                            int sr_, int nr, int nc, const Params& p) {
  const int nch = (nc + NP - 1) / NP;
  for (int it = threadIdx.x; it < nch * nr; it += NTHREADS) {
    const int r = it % nr;
    const int c0 = min((it / nr) * NP, nc - NP);
    float s[3][NP];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float v[NP + 2 * R];
#pragma unroll
      for (int i = 0; i < NP + 2 * R; ++i) v[i] = wv[q * plane + r * sg + c0 + i];
      chains<R>(p.gauss, v, s[q]);
    }
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      const float ixx = s[0][j], ixy = s[1][j], iyy = s[2][j];
      const float det = fsub(fmul(ixx, iyy), fmul(ixy, ixy));
      const float tr = fadd(ixx, iyy);
      resp[r * sr_ + c0 + j] = fsub(det, fmul(fmul(p.harris_k, tr), tr));
    }
  }
}

#define KCMC_RADIUS_SWITCH(r, CALL) \
  switch (r) {                      \
    case 1: CALL(1); break;         \
    case 2: CALL(2); break;         \
    case 3: CALL(3); break;         \
    case 4: CALL(4); break;         \
    case 5: CALL(5); break;         \
    case 6: CALL(6); break;         \
    case 7: CALL(7); break;         \
    default: CALL(8); break;        \
  }

__global__ void __launch_bounds__(NTHREADS, 1024 / NTHREADS)
detect_kernel(const float* __restrict__ frames, float* __restrict__ nms,
              float* __restrict__ oxo, float* __restrict__ oyo,
              float* __restrict__ smooth, int H, int W, int tiles_x, Params prm) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = layout(prm);
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TH;
  const int tx0 = (blockIdx.x % tiles_x) * TW;
  const size_t base = (size_t)b * H * W;
  const float* f = frames + base;
  auto real = [&](int y, int x) {  // tile coordinates
    return ty0 + y >= 0 && ty0 + y < H && tx0 + x >= 0 && tx0 + x < W;
  };

  // 1. stage IN = T +- (h, hx), zero outside the frame
  float* IN = sm;
  {
    const int gy0 = ty0 - L.h, gx0 = tx0 - L.hx;
    if ((W & 3) == 0 && (((uintptr_t)frames) & 15) == 0) {
      const int nq = L.inw >> 2;
      for (int i = threadIdx.x; i < L.inh * nq; i += NTHREADS) {
        const int r = i / nq, gy = gy0 + r, gx = gx0 + 4 * (i % nq);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = __ldg(reinterpret_cast<const float4*>(f + (size_t)gy * W + gx));
        reinterpret_cast<float4*>(IN)[i] = v;
      }
    } else {
      for (int i = threadIdx.x; i < L.inh * L.inw; i += NTHREADS) {
        const int gy = gy0 + i / L.inw, gx = gx0 + i % L.inw;
        IN[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? __ldg(f + (size_t)gy * W + gx)
                                                         : 0.f;
      }
    }
  }
  __syncthreads();
  auto in_at = [&](int y, int x) { return IN + (y + L.h) * L.inw + (x + L.hx); };

  // 2a. blur, rows: BV(r, c) at tile (r, c - sr)
  float* P = sm + L.o_p;
  float* BV = sm + L.o_bv;
  float* SM = sm + L.o_sm;
#define BLUR_ROWS(R) vpass<R>(in_at(-R, -R), L.inw, BV, L.s_bv, TH, L.bvw, prm.smooth)
  if (prm.sr > 0) KCMC_RADIUS_SWITCH(prm.sr, BLUR_ROWS)
#undef BLUR_ROWS

  // 2b. gradients on G (tile rows and columns -e .. T + e), masked to the
  // frame, and the products P0 = gx gx, P1 = gx gy, P2 = gy gy. Items of
  // NG rows of one column: the 3 x (NG + 2) staged values in registers.
  {
    const int plane = L.gh * L.s_g;
    const int nch = (L.gh + NG - 1) / NG;
    for (int it = threadIdx.x; it < nch * L.gw; it += NTHREADS) {
      const int c = it % L.gw;
      const int r0 = min((it / L.gw) * NG, L.gh - NG);
      const float* a = in_at(r0 - L.e - 1, c - L.e - 1);
      float v[NG + 2][3], smx[NG + 2];
#pragma unroll
      for (int i = 0; i < NG + 2; ++i) {
#pragma unroll
        for (int d = 0; d < 3; ++d) v[i][d] = a[i * L.inw + d];
        // smooth along x: 0.25, 0.5, 0.25
        smx[i] = fadd(fadd(fmul(0.25f, v[i][0]), fmul(0.5f, v[i][1])), fmul(0.25f, v[i][2]));
      }
#pragma unroll
      for (int j = 0; j < NG; ++j) {
        float smy[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)  // smooth along y
          smy[d] = fadd(fadd(fmul(0.25f, v[j][d]), fmul(0.5f, v[j + 1][d])),
                        fmul(0.25f, v[j + 2][d]));
        // difference taps 0.5, 0.0, -0.5 (the zero tap is kept: 0 x inf)
        float gx = fadd(fadd(fmul(0.5f, smy[0]), fmul(0.0f, smy[1])), fmul(-0.5f, smy[2]));
        float gy = fadd(fadd(fmul(0.5f, smx[j]), fmul(0.0f, smx[j + 1])),
                        fmul(-0.5f, smx[j + 2]));
        if (!real(r0 + j - L.e, c - L.e)) gx = gy = 0.f;
        const int o = (r0 + j) * L.s_g + c;
        P[o] = fmul(gx, gx);
        P[plane + o] = fmul(gx, gy);
        P[2 * plane + o] = fmul(gy, gy);
      }
    }
  }
  __syncthreads();

  // 3a. blur, columns -> SM (tile T)
#define BLUR_COLS(R) hpass<R>(BV, L.s_bv, SM, TW + 1, TH, TW, prm.smooth)
  if (prm.sr > 0) KCMC_RADIUS_SWITCH(prm.sr, BLUR_COLS)
#undef BLUR_COLS
  // 3b. window, rows: WV (rh x gw, over IN) from P
  float* WV = sm;
  {
    const int pp = L.gh * L.s_g, pw = L.rh * L.s_g;
#define WIN_ROWS(R)                                                       \
  for (int q = 0; q < 3; ++q)                                             \
    vpass<R>(P + q * pp, L.s_g, WV + q * pw, L.s_g, L.rh, L.gw, prm.gauss)
    KCMC_RADIUS_SWITCH(prm.gr, WIN_ROWS)
#undef WIN_ROWS
  }
  __syncthreads();

  // 4. window, columns, and the response -> RESP (T +- m, over P)
  float* RESP = sm + L.o_resp;
#define WIN_COLS(R) \
  window_cols<R>(WV, L.rh * L.s_g, L.s_g, RESP, L.s_r, L.rh, L.rw, prm)
  KCMC_RADIUS_SWITCH(prm.gr, WIN_COLS)
#undef WIN_COLS
  __syncthreads();

  // 5. NMS, rows: RMAX(r, c) at tile (r, c - m), the max of the -inf-masked
  // response over the row window (over WV)
  float* RMAX = sm;
  auto resp_at = [&](int y, int x) { return RESP[(y + L.m) * L.s_r + (x + L.m)]; };
  // Items of NR rows of one column: the frame test of the column once, of
  // each row by two comparisons.
  {
    constexpr int NR = 8;
    for (int it = threadIdx.x; it < (TH / NR) * L.rw; it += NTHREADS) {
      const int c = it % L.rw, r0 = (it / L.rw) * NR;
      const int gx = tx0 + c - L.m;
      const bool col = gx >= 0 && gx < W;
      const float* rp = RESP + (r0 + L.m) * L.s_r + c;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        auto neg = [&](int d) {
          const int gy = ty0 + r0 + j + d;
          return (col && gy >= 0 && gy < H) ? rp[(j + d) * L.s_r] : -INFINITY;
        };
        float mx = neg(0);
        for (int d = prm.nlo; d <= prm.nhi; ++d)
          if (d) mx = fmaxf(mx, neg(d));
        RMAX[(r0 + j) * L.s_r + c] = mx;
      }
    }
  }
  __syncthreads();

  // 6. the tile: NMS columns, subpixel fits on the zero-extended response,
  // the blur; coalesced stores
  auto rc = [&](int y, int x) { return real(y, x) ? resp_at(y, x) : 0.f; };
  for (int q = threadIdx.x; q < TH * TW; q += NTHREADS) {
    const int y = q / TW, x = q % TW;
    const int gy = ty0 + y, gx = tx0 + x;
    if (gy >= H || gx >= W) continue;
    const size_t o = base + (size_t)gy * W + gx;
    const float* rm = RMAX + y * L.s_r + (x + L.m);
    float mx = rm[0];
    for (int d = prm.nlo; d <= prm.nhi; ++d)
      if (d) mx = fmaxf(mx, rm[d]);
    const float v = resp_at(y, x);
    nms[o] = (v >= mx) ? v : -INFINITY;

    const float c = rc(y, x);
    const float right = rc(y, x + 1), left = rc(y, x - 1);
    const float dx = fmul(0.5f, fsub(right, left));
    const float dxx = fadd(fsub(right, fmul(2.0f, c)), left);
    const float ox = fabsf(dxx) > 1e-8f ? __fdiv_rn(-dx, dxx) : 0.f;
    oxo[o] = fminf(fmaxf(ox, -0.5f), 0.5f);
    const float down = rc(y + 1, x), up = rc(y - 1, x);
    const float dy = fmul(0.5f, fsub(down, up));
    const float dyy = fadd(fsub(down, fmul(2.0f, c)), up);
    const float oy = fabsf(dyy) > 1e-8f ? __fdiv_rn(-dy, dyy) : 0.f;
    oyo[o] = fminf(fmaxf(oy, -0.5f), 0.5f);
    if (prm.sr > 0) smooth[o] = SM[y * (TW + 1) + x];
  }
}

#undef KCMC_RADIUS_SWITCH

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
  if (gr < 1 || gr > MAXR || sr < 0 || sr > MAXR || B < 1 || B > 65535 || H < 1 ||
      W < 1)
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
  const int smem = layout(prm).total * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(detect_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  dim3 grid(tiles_x * tiles_y, B);
  detect_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      frames, nms, ox, oy, smooth, H, W, tiles_x, prm);
  return (int)cudaGetLastError();
}
