// K8 warp_batch_field: piecewise warp of a frame batch through cell-centred
// (B, gh, gw, 2) displacement fields, one bilinear interpolation computed
// directly per output pixel.
//
// Replaces kcmc_tpu/ops/pallas_warp_field.py::warp_batch_field
// (_make_kernel, pallas_warp_field.py:82/:196). The TPU kernel rolls a
// VMEM window of each row strip by the field's integer mean, upsamples the
// residual field in-kernel (column interpolation as one matmul with hat
// weights, row interpolation as gh broadcast multiply-adds), builds a
// canvas of x-resampled rows whose x-phase is taken at each canvas row's
// consumer (two fixed-point iterations), and y-resamples it at the output
// pixel's own phase. The function, per frame:
//   * t = round-half-even(mean of the field over its cells, summed
//     sequentially row-major), exact = |t| <= PAD and every
//     |field - t| <= max_px - 0.5 (NaN fails), ok = exact;
//   * output pixel (x, y): the upsampled residual at (x, y) from its two
//     live column cells and two live row cells (the hat weights of every
//     other cell are exactly 0, so the TPU's full sums add only zeros to
//     these two terms); the two canvas rows, each the two-tap x-lerp of the
//     edge-clamped source shifted by t at the x-phase of its consumer row,
//     and the y-lerp, each tap only inside the TPU's window (the rule of
//     warp_taps.cuh's lerp, as in K7); zero where the true sample leaves
//     the frame or exact is 0.
// Every float operation is an explicitly rounded intrinsic in the plain
// version's order (rintf for the half-even rounding, --fmad=false), so
// kernel and plain version agree bit for bit.
//
// Bound on the H100: memory. At B=32, 512x512 it must read 33.6 MB of
// frames and write 33.6 MB, ~20 us at 3.35 TB/s; the fields are 16 KB.
// The function needs ~80 float operations per pixel (chip_smoke.py's
// field_warp_ops counts each column, row and canvas-row term once), ~10 us
// at 67 TFLOP/s. In practice the kernel is bound by instruction issue and
// latency: the fixed-point row coordinates are long dependent chains of
// rounded operations, selects and clamps (on the card, taking out the
// loads or the stores saves little). The design computes each term about
// once:
//   * one launch: every block derives its frame's t and exact from the
//     cells itself (the block stages the cells in shared memory, two lanes
//     sum the channels in order from there, the block reduces the residual
//     bound with __syncthreads_or); block (0, 0) of a frame writes ok. No
//     scratch, no second launch. The sums are a dependent chain of gh * gw
//     adds that every block runs: ~64 at config 3's 8x8, 6084 at 78x78;
//   * column strips: a thread owns one column x and RPT consecutive output
//     rows; a warp's 32 columns keep the source reads and the stores
//     contiguous. The column's live cells and hat weights are computed once;
//   * the rows a strip reaches: an exact frame's residuals are at most
//     max_px - 0.5, so every row coordinate the strip evaluates lies within
//     2 max_px + 1 rows of it. Where those coordinates span at most two
//     cell rows (every strip of config 3: 64-row cells), c0 is one
//     comparison and the column-interpolated residuals of the three cell
//     rows sit in registers (TwoCell). Otherwise (General) each thread
//     keeps them for NCR cell rows in its own shared-memory slots (no
//     barrier: no other thread reads them) and computes any other cell
//     row from the cells, the same expression;
//   * streamed canvas rows: a canvas row is a function of (row, x) alone,
//     and output row y reads rows y + floor(ry) and the next. Each lane
//     computes at most one new canvas row and emits at most one output row
//     per step, keeping its two newest rows in registers, so a warp runs
//     the canvas code once per step whichever lanes need it, not once per
//     pattern of lanes that need their first or their second row;
//   * an exact frame's residuals stay below max_px, so its floors lie in
//     [-max_px, max_px - 1] and every tap is inside the TPU's window: the
//     lerps skip warp_taps.cuh's window tests (the same operations
//     otherwise). Where the strip's row coordinates need no clamp and every
//     cell row has a successor (TwoCell<true>), neither is tested;
//   * in-frame offsets are 32-bit; a frame that is not exact is only
//     zeroed.
// gh * gw <= 6144 (the wrapper's limit), any max_px, frames of fewer than
// 2^31 pixels: the cells stay in global memory (read through L1), and the
// general path's 8 KB of slots, which the prologue borrows, do not depend
// on them.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include "warp_taps.cuh"

namespace {

using kcmc::add;
using kcmc::mul;
using kcmc::sub;

constexpr int PAD = 128;
constexpr int RPT = 32;           // output rows per thread, one column
constexpr int NTHREADS = 128;     // consecutive columns per block
constexpr int NCR = 8;            // cached cell rows per column (general path)
constexpr int CHUNK = NCR * NTHREADS;  // cells staged at once by the prologue
constexpr int MAX_CELLS = 6144;   // gh * gw, the wrapper's limit

// (1 - f) v0 + f v1: warp_taps.cuh's lerp where both taps lie inside the
// TPU's window, which holds for every tap of an exact frame (its floors
// lie in [-max_px, max_px - 1]); the same operations, without the tests.
__device__ __forceinline__ float lerp_in(float f, float v0, float v1) {
  return add(mul(sub(1.0f, f), v0), mul(f, v1));
}

// One thread's column of one frame: the residual cells and the column's
// live cells and hat weights.
struct Column {
  const float* cells;  // the frame's (gh, gw, 2) field
  float t[2];          // (tx, ty)
  int gh, gw;
  float rh;            // float32(gh / H)
  float ghm1;          // float32(gh - 1)
  int d0;
  bool has1;           // d0 + 1 < gw
  float h0, h1;
};

// The column-interpolated residual of cell row c, channel ch, from the
// cells: the second term is omitted (not added as 0) at the last column.
__device__ __forceinline__ float inner_direct(const Column& k, int c, int ch) {
  const float* f = k.cells + (c * k.gw + k.d0) * 2 + ch;
  const float a = mul(sub(__ldg(f), k.t[ch]), k.h0);
  if (!k.has1) return a;
  return add(a, mul(sub(__ldg(f + 2), k.t[ch]), k.h1));
}

// The cell-space row coordinate of row y, before its clamp to [0, gh - 1]
__device__ __forceinline__ float urow_raw(const Column& k, float y) {
  return sub(mul(add(y, 0.5f), k.rh), 0.5f);
}

__device__ __forceinline__ float urow_of(const Column& k, float y) {
  return fminf(fmaxf(urow_raw(k, y), 0.0f), k.ghm1);
}

// The hat weights of a row coordinate u in [0, gh - 1] and which of its
// cell rows are live: c0 = floor(u) and, where has1, c0 + 1. (float)c0 is
// floor(u) up to the sign of a zero, which |u - c0| does not see. With
// c0 <= u < c0 + 1, u - c0 is exact and both 1 - |u - c| are >= +0, so
// the reference's max(., 0) leaves them as they are and is not taken.
struct RowW {
  int c0;
  bool hi;  // two-cell path: c0 is the strip's second cell row
  bool has1;
  float w0, w1;
};

// General path: any strip. c0 from the row coordinate, the column's inner
// values from its NCR cached cell rows or, beyond them, from the cells.
struct General {
  Column k;
  const float* cache;  // (NCR, 2) slots of this thread, stride NTHREADS
  int clo, ncache;     // cached cell rows clo .. clo + ncache - 1

  __device__ __forceinline__ float urow(float y) const { return urow_of(k, y); }
  __device__ __forceinline__ RowW weights(float u) const {
    RowW r;
    const float c0f = floorf(u);
    r.c0 = (int)c0f;
    r.hi = false;
    r.has1 = r.c0 + 1 < k.gh;
    r.w0 = sub(1.0f, fabsf(sub(u, c0f)));
    r.w1 = sub(1.0f, fabsf(sub(u, add(c0f, 1.0f))));
    return r;
  }
  __device__ __forceinline__ float inner(int c, int ch) const {
    const int i = c - clo;
    if ((unsigned)i < (unsigned)ncache) return cache[(i * 2 + ch) * NTHREADS];
    return inner_direct(k, c, ch);
  }
  // row interpolation of channel ch: the second term omitted at the last row
  __device__ __forceinline__ float interp(const RowW& r, int ch) const {
    const float a = mul(r.w0, inner(r.c0, ch));
    if (!r.has1) return a;
    return add(a, mul(r.w1, inner(r.c0 + 1, ch)));
  }
};

// Two-cell path: every row coordinate the strip evaluates lies in
// [cA, cA + 2), so c0 is cA or cA + 1 (u >= cA + 1), and the inner values
// of cell rows cA .. cA + 2 sit in registers. Same weights, same products.
// INTERIOR: the strip's unclamped row coordinates already lie in
// [0, gh - 1] (the clamp is the identity) and cA + 2 < gh (every c0 has a
// successor), so neither is tested per pixel.
template <bool INTERIOR>
struct TwoCell {
  Column k;
  float ca, cb, cc;  // cA, cA + 1, cA + 2 as floats
  float in[3][2];    // inner(cA + i, ch)

  __device__ __forceinline__ float urow(float y) const {
    return INTERIOR ? urow_raw(k, y) : urow_of(k, y);
  }
  __device__ __forceinline__ RowW weights(float u) const {
    RowW r;
    r.hi = u >= cb;
    const float c0f = r.hi ? cb : ca;
    r.c0 = 0;
    r.has1 = INTERIOR || c0f < k.ghm1;
    r.w0 = sub(1.0f, fabsf(sub(u, c0f)));
    r.w1 = sub(1.0f, fabsf(sub(u, r.hi ? cc : cb)));
    return r;
  }
  __device__ __forceinline__ float interp(const RowW& r, int ch) const {
    const float a = mul(r.w0, r.hi ? in[1][ch] : in[0][ch]);
    if (!r.has1) return a;
    return add(a, mul(r.w1, r.hi ? in[2][ch] : in[1][ch]));
  }
};

// One column's source frame and its shift: in-frame offsets are 32-bit
// (H * W < 2^31, checked at the entry point).
struct Source {
  const float* src;  // the frame
  int H, W, x, itx, ity;
};

// Canvas row yb (ybf = (float)yb) at column x: its consumer row by two
// fixed-point steps, the x-residual there (below max_px: no clamp needed)
// and the two-tap x-lerp of the source row yb + ty.
template <class E>
__device__ __forceinline__ float canvas(const E& e, const Source& s, int yb, float ybf) {
  float yc = ybf;
#pragma unroll
  for (int it = 0; it < 2; ++it) yc = sub(ybf, e.interp(e.weights(e.urow(yc)), 1));
  const float rxc = e.interp(e.weights(e.urow(yc)), 0);
  const float flx = floorf(rxc);
  const int mxi = (int)flx;
  const float fx = sub(rxc, flx);
  const int row = min(max(yb + s.ity, 0), s.H - 1) * s.W;
  const int c = s.x + mxi + s.itx;
  const float v0 = __ldg(s.src + (row + min(max(c, 0), s.W - 1)));
  const float v1 = __ldg(s.src + (row + min(max(c + 1, 0), s.W - 1)));
  return lerp_in(fx, v0, v1);
}

// One stream of output rows of one column. Output row y reads canvas rows
// a = y + floor(ry) and a + 1. Per step the stream computes at most one
// new canvas row (the next its row lacks; rows no output row reads are
// skipped) and emits at most one output row, keeping its two newest canvas
// rows in registers: where floor(ry) moves by at most one from row to row
// (a residual that changes by less than a pixel per row) they are the two
// an output row reads; otherwise both are computed again.
struct Stream {
  int y, yend;     // the pending output row; the stream's end
  float yf;        // (float)y
  float* op;       // its output
  float ry, rx, fy;  // its residual and y-phase
  int a;           // its first canvas row, and (float)a
  float af;
  int nc, nlo;     // the next canvas row to compute; rows nlo .. nc - 1
  float ncf;       // were computed in order; (float)nc
  float v1, v0;    // canvas rows nc - 2 and nc - 1
};

// the pending row's residual and canvas rows (|ry| < max_px: floor(ry) is
// its own window-clamped floor, and small integers add exactly)
template <class E>
__device__ __forceinline__ void enter(const E& e, Stream& t) {
  const RowW r = e.weights(e.urow(t.yf));
  t.ry = e.interp(r, 1);
  t.rx = e.interp(r, 0);
  const float fly = floorf(t.ry);
  t.fy = sub(t.ry, fly);
  t.a = t.y + (int)fly;
  t.af = add(t.yf, fly);
}

template <class E>
__device__ __forceinline__ void start(const E& e, Stream& t, float* o, int W, int y0,
                                      int yend) {
  t.y = y0;
  t.yend = yend;
  t.yf = (float)y0;
  t.op = o + y0 * W;
  enter(e, t);
  t.nc = t.nlo = t.a;
  t.ncf = t.af;
  t.v1 = t.v0 = 0.0f;
}

// One step, without branches on the common path: the canvas row and the
// next row's residual are computed every step (a step that needs neither
// repeats work whose result it drops).
template <class E>
__device__ __forceinline__ void step(const E& e, const Source& s, Stream& t, float ty,
                                     float xt, float hm1, float wm1) {
  const bool live = t.y < t.yend;
  const bool need = live && t.a + 1 >= t.nc;  // the row's second canvas row is missing
  if (need && t.a > t.nc) {
    t.nc = t.nlo = t.a;
    t.ncf = t.af;
  }
  const float v = canvas(e, s, t.nc, t.ncf);
  if (need) {
    t.v1 = t.v0;
    t.v0 = v;
    t.nc += 1;
    t.ncf = add(t.ncf, 1.0f);
  }
  const bool emit = live && t.a + 1 < t.nc;
  float c0 = t.v1, c1 = t.v0;
  if (emit && (t.a != t.nc - 2 || t.a < t.nlo)) {  // a residual that fell fast
    c0 = canvas(e, s, t.a, t.af);
    c1 = canvas(e, s, t.a + 1, add(t.af, 1.0f));
  }
  const float acc = lerp_in(t.fy, c0, c1);
  const float sy = add(add(t.yf, ty), t.ry);
  const float sx = add(xt, t.rx);
  const bool inb = sy >= 0.0f && sy <= hm1 && sx >= 0.0f && sx <= wm1;
  if (emit) {
    *t.op = inb ? acc : 0.0f;
    t.op += s.W;
    t.y += 1;
    t.yf = add(t.yf, 1.0f);
  }
  enter(e, t);  // the next row's, or this row's again
}

// Column x, output rows y0 .. yend - 1 (none where x >= W): steps until
// every lane of the warp is done.
template <class E>
__device__ __forceinline__ void strip(const E& e, const Source& s, float* __restrict__ o,
                                      int y0, int yend, float tx, float ty) {
  const float xt = add((float)s.x, tx);
  const float hm1 = (float)s.H - 1.0f, wm1 = (float)s.W - 1.0f;
  Stream t;
  start(e, t, o, s.W, y0, yend);
  while (__any_sync(0xffffffffu, t.y < t.yend)) step(e, s, t, ty, xt, hm1, wm1);
}

__global__ void __launch_bounds__(NTHREADS)
field_warp(const float* __restrict__ frames, const float* __restrict__ fields,
           float* __restrict__ out, bool* __restrict__ ok, int H, int W, int gh,
           int gw, float rh, float rw, int mp) {
  __shared__ float cache[NCR * 2 * NTHREADS];
  __shared__ float tsh[2];
  __shared__ int tish[2];
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ncell = gh * gw;
  const float* f = fields + (size_t)b * ncell * 2;

  // the frame's t: row-major sequential sums, one lane per channel. The
  // block stages the cells through `cache` in chunks of CHUNK cells (all
  // loads in flight at once); lanes 0 and 1 then run the dependent chain
  // from shared memory, so the chain waits on no global load.
  float sum = 0.0f;
  for (int c0 = 0; c0 < ncell; c0 += CHUNK) {
    const int n = min(CHUNK, ncell - c0);
    for (int i = tid; i < 2 * n; i += NTHREADS) cache[i] = __ldg(f + 2 * c0 + i);
    __syncthreads();
    if (tid < 2) {
#pragma unroll 8
      for (int c = 0; c < n; ++c) sum = add(sum, cache[2 * c + tid]);
    }
    __syncthreads();
  }
  if (tid < 2) {
    const float t = rintf(__fdiv_rn(sum, (float)ncell));
    tsh[tid] = t;
    tish[tid] = (int)fminf(fmaxf(t, -(PAD + 1.0f)), PAD + 1.0f);  // used where |t| <= PAD
  }
  __syncthreads();
  const float tx = tsh[0], ty = tsh[1];
  // residual bound: every |field - t| <= max_px - 0.5 (NaN fails it)
  const float lim = (float)mp - 0.5f;
  bool bad = false;
  for (int i = tid; i < 2 * ncell; i += NTHREADS)
    bad |= !(fabsf(sub(__ldg(f + i), (i & 1) ? ty : tx)) <= lim);
  const bool exact = !__syncthreads_or(bad) && ty >= -PAD && ty <= PAD &&
                     tx >= -PAD && tx <= PAD;
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) ok[b] = exact;

  const int x = blockIdx.x * NTHREADS + tid;
  const int y0 = blockIdx.y * RPT;
  const int yend = min(y0 + RPT, H);
  float* o = out + (size_t)b * H * W + min(x, W - 1);
  if (!exact) {
    if (x < W)
      for (int y = y0; y < yend; ++y) o[y * W] = 0.0f;
    return;
  }

  // the column's two live cells and hat weights (x clamped: lanes past the
  // frame's edge only take part in the warp's loop control)
  Column k;
  k.cells = f;
  k.t[0] = tx;
  k.t[1] = ty;
  k.gh = gh;
  k.gw = gw;
  k.rh = rh;
  k.ghm1 = (float)(gh - 1);
  const int xc = min(x, W - 1);
  const float ucol =
      fminf(fmaxf(sub(mul(add((float)xc, 0.5f), rw), 0.5f), 0.0f), (float)(gw - 1));
  k.d0 = (int)floorf(ucol);
  k.has1 = k.d0 + 1 < gw;
  k.h0 = fmaxf(sub(1.0f, fabsf(sub(ucol, (float)k.d0))), 0.0f);
  k.h1 = fmaxf(sub(1.0f, fabsf(sub(ucol, (float)(k.d0 + 1)))), 0.0f);

  // The rows the strip evaluates: an exact frame's residuals are below
  // max_px, so every row coordinate lies within 2 max_px + 1 rows of the
  // strip, and the row coordinate is monotone in the row.
  const float ulo = urow_raw(k, (float)(y0 - 2 * mp - 2));
  const float uhi = urow_raw(k, (float)(yend + 2 * mp + 1));
  const int clo = (int)floorf(fminf(fmaxf(ulo, 0.0f), k.ghm1));
  const int chi = (int)floorf(fminf(fmaxf(uhi, 0.0f), k.ghm1));
  const Source s{frames + (size_t)b * H * W, H, W, xc, tish[0], tish[1]};
  const int yl = x < W ? yend : y0;
  if (chi <= clo + 1) {  // block-uniform
    float in[3][2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch)
        in[i][ch] = clo + i < gh ? inner_direct(k, clo + i, ch) : 0.0f;
    auto run = [&](auto e) {
      e.k = k;
      e.ca = (float)clo;
      e.cb = (float)(clo + 1);
      e.cc = (float)(clo + 2);
#pragma unroll
      for (int i = 0; i < 3; ++i) e.in[i][0] = in[i][0], e.in[i][1] = in[i][1];
      strip(e, s, o, y0, yl, tx, ty);
    };
    if (ulo >= 0.0f && uhi <= k.ghm1 && clo + 2 < gh)
      run(TwoCell<true>{});
    else
      run(TwoCell<false>{});
  } else {
    General e;
    e.k = k;
    e.cache = cache + tid;
    e.clo = clo;
    e.ncache = min(min(chi + 1, gh - 1) - clo + 1, NCR);
    for (int i = 0; i < e.ncache; ++i) {
      cache[(i * 2 + 0) * NTHREADS + tid] = inner_direct(k, clo + i, 0);
      cache[(i * 2 + 1) * NTHREADS + tid] = inner_direct(k, clo + i, 1);
    }
    strip(e, s, o, y0, yl, tx, ty);
  }
}

}  // namespace

// frames (B, H, W) f32, fields (B, gh, gw, 2) f32 -> out (B, H, W) f32 and
// ok (B,) bool, on `stream`, in one launch. rh, rw are float32(gh / H) and
// float32(gw / W). Returns cudaGetLastError() after the launch.
extern "C" int kcmc_warp_batch_field(const float* frames, const float* fields,
                                     float* out, bool* ok, int B, int H, int W,
                                     int gh, int gw, float rh, float rw,
                                     int max_px, void* stream) {
  if (B < 1 || H < 1 || W < 1 || B > 65535 || (H + RPT - 1) / RPT > 65535 ||
      (long long)H * W > INT_MAX || gh < 1 || gw < 1 || (long long)gh * gw > MAX_CELLS)
    return (int)cudaErrorInvalidValue;
  dim3 grid((W + NTHREADS - 1) / NTHREADS, (H + RPT - 1) / RPT, B);
  field_warp<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(frames, fields, out, ok, H, W,
                                                          gh, gw, rh, rw, max_px);
  return (int)cudaGetLastError();
}
