// K9 response_fields_3d: the Gaussian-windowed 3D structure tensor of a
// volume batch and its Harris response, plus the descriptor-stage blur.
//
// Replaces kcmc_tpu/ops/pallas_detect3d.py::response_fields_3d
// (_structure_kernel). Same function, pallas_detect3d.py:96-156:
//   * central differences g = 0.5 * (v[+1] - v[-1]) along z, y and x
//     with SAME zero padding, then re-masked to the real volume (a
//     gradient outside the volume is 0), exactly the jnp route's
//     zero-padded products;
//   * the six products gx*gx, gy*gy, gz*gz, gx*gy, gx*gz, gy*gz, each
//     correlated with the float32 Gaussian window taps along z, then y,
//     then x (SAME zero padding, accumulated tap by tap in tap order);
//   * optionally the blur of the volume with the smooth taps, z, y, x.
// Unlike the TPU kernel, which writes the six entries for XLA to combine,
// this kernel also forms the response det(S) - k tr(S)^3 (the reference's
// operation order, pallas_detect3d.py:220-227) from the six entries while
// they are in registers, so it writes 2 fields instead of 7. The 3x3x3
// NMS stays outside (ops/detect3d.py), as in the reference.
//
// Bound on the H100: at config 5 (B=8, 32x256x256) the function reads
// 67 MB and writes 134 MB (response and blur), 0.060 ms at 3.35 TB/s,
// and needs ~490 float32 operations per voxel (6 x 3 x 21 window, 3 x 25
// blur, gradients, products, response), 0.12 ms at 67 TFLOP/s: it is
// bound by operations. The design keeps every intermediate on chip.
// A block owns a 16x16 (y, x) output column tile and marches down the
// whole z axis: each thread owns one (y, x) column of the tile plus its
// y/x halo and keeps the last 2R+1 planes of its three gradients (or of
// the input, for the blur) in registers, so the z pass costs no shared
// memory and no z halo is ever recomputed. Per output plane the six
// z-windowed entries go through shared memory for the y pass and the x
// pass. Every product and sum is an explicitly rounded float32
// operation in the order of the plain PyTorch version
// (response_fields_3d_plain), so the two agree bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int TY = 16;
constexpr int TX = 16;
constexpr int MAXR = 6;

struct Taps {
  float w[2 * MAXR + 1];
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

template <int R>
struct Geom {
  static constexpr int RY = TY + 2 * R;  // column rows of the tile + halo
  static constexpr int RX = TX + 2 * R;
  static constexpr int NCOL = RY * RX;
  static constexpr int NT = (NCOL + 31) / 32 * 32;
  static constexpr int NTAP = 2 * R + 1;
};

// Windowed structure tensor + Harris response. Window radius GR: the
// gradients are needed on the tile plus a GR halo in y and x.
template <int GR>
__global__ void __launch_bounds__(Geom<GR>::NT)
structure_kernel(const float* __restrict__ vols, float* __restrict__ resp,
                 int D, int H, int W, int tiles_x, Taps g, float harris_k) {
  using G = Geom<GR>;
  constexpr int RX = G::RX, NTAP = G::NTAP;
  __shared__ float sZ[6][G::NCOL];  // z-windowed entries, one plane
  __shared__ float sY[6][TY * RX];  // then y-windowed

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TY;
  const int tx0 = (blockIdx.x % tiles_x) * TX;
  const int tid = threadIdx.x;
  const bool col = tid < G::NCOL;
  const int cy = tid / RX, cx = tid % RX;
  const int y = ty0 - GR + cy, x = tx0 - GR + cx;
  const bool inside = col && y >= 0 && y < H && x >= 0 && x < W;
  const size_t plane = (size_t)H * W;
  const float* vb = vols + (size_t)b * D * plane;

  // rings of the last NTAP planes' gradients at this column (oldest first)
  float rx[NTAP], ry[NTAP], rz[NTAP];
#pragma unroll
  for (int t = 0; t < NTAP; ++t) rx[t] = ry[t] = rz[t] = 0.f;
  float vm1 = 0.f, vm2 = 0.f;  // input at this column, planes p-1 and p-2
  float pgx = 0.f, pgy = 0.f;  // gx, gy of plane p-1

  auto at = [&](int z, int yy, int xx) -> float {
    return (z < D && yy >= 0 && yy < H && xx >= 0 && xx < W)
               ? vb[(size_t)z * plane + (size_t)yy * W + xx]
               : 0.f;
  };

  // At step p plane p is read; the gradients of plane p-1 complete, and
  // the ring then centres on plane c = p-1-GR.
  for (int p = 0; p <= D + GR; ++p) {
    const int c = p - 1 - GR;
    if (col) {
      const float v = inside ? at(p, y, x) : 0.f;
      const bool live = inside && p - 1 >= 0 && p - 1 < D;
      const float gz = live ? fmul(0.5f, fsub(v, vm2)) : 0.f;
      const float gxq = live ? pgx : 0.f;
      const float gyq = live ? pgy : 0.f;
#pragma unroll
      for (int t = 0; t < NTAP - 1; ++t) {
        rx[t] = rx[t + 1];
        ry[t] = ry[t + 1];
        rz[t] = rz[t + 1];
      }
      rx[NTAP - 1] = gxq;
      ry[NTAP - 1] = gyq;
      rz[NTAP - 1] = gz;
      if (p < D && inside) {
        pgx = fmul(0.5f, fsub(at(p, y, x + 1), at(p, y, x - 1)));
        pgy = fmul(0.5f, fsub(at(p, y + 1, x), at(p, y - 1, x)));
      } else {
        pgx = pgy = 0.f;
      }
      vm2 = vm1;
      vm1 = v;
      if (c >= 0) {
        // order: sxx, syy, szz, sxy, sxz, syz
        float a0 = fmul(g.w[0], fmul(rx[0], rx[0]));
        float a1 = fmul(g.w[0], fmul(ry[0], ry[0]));
        float a2 = fmul(g.w[0], fmul(rz[0], rz[0]));
        float a3 = fmul(g.w[0], fmul(rx[0], ry[0]));
        float a4 = fmul(g.w[0], fmul(rx[0], rz[0]));
        float a5 = fmul(g.w[0], fmul(ry[0], rz[0]));
#pragma unroll
        for (int t = 1; t < NTAP; ++t) {
          const float w = g.w[t];
          a0 = fadd(a0, fmul(w, fmul(rx[t], rx[t])));
          a1 = fadd(a1, fmul(w, fmul(ry[t], ry[t])));
          a2 = fadd(a2, fmul(w, fmul(rz[t], rz[t])));
          a3 = fadd(a3, fmul(w, fmul(rx[t], ry[t])));
          a4 = fadd(a4, fmul(w, fmul(rx[t], rz[t])));
          a5 = fadd(a5, fmul(w, fmul(ry[t], rz[t])));
        }
        sZ[0][tid] = a0;
        sZ[1][tid] = a1;
        sZ[2][tid] = a2;
        sZ[3][tid] = a3;
        sZ[4][tid] = a4;
        sZ[5][tid] = a5;
      }
    }
    __syncthreads();  // sZ complete (and every thread past its reads)
    if (c < 0) continue;

    for (int i = tid; i < 6 * TY * RX; i += G::NT) {
      const int e = i / (TY * RX), r = i % (TY * RX);
      const int yy = r / RX, xx = r % RX;
      float acc = fmul(g.w[0], sZ[e][yy * RX + xx]);
#pragma unroll
      for (int t = 1; t < NTAP; ++t)
        acc = fadd(acc, fmul(g.w[t], sZ[e][(yy + t) * RX + xx]));
      sY[e][r] = acc;
    }
    __syncthreads();

    for (int i = tid; i < TY * TX; i += G::NT) {
      const int yy = i / TX, xx = i % TX;
      const int oy = ty0 + yy, ox = tx0 + xx;
      if (oy >= H || ox >= W) continue;
      float s[6];
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const float* row = &sY[e][yy * RX + xx];
        float acc = fmul(g.w[0], row[0]);
#pragma unroll
        for (int t = 1; t < NTAP; ++t) acc = fadd(acc, fmul(g.w[t], row[t]));
        s[e] = acc;
      }
      const float sxx = s[0], syy = s[1], szz = s[2];
      const float sxy = s[3], sxz = s[4], syz = s[5];
      const float det = fadd(
          fsub(fmul(sxx, fsub(fmul(syy, szz), fmul(syz, syz))),
               fmul(sxy, fsub(fmul(sxy, szz), fmul(syz, sxz)))),
          fmul(sxz, fsub(fmul(sxy, syz), fmul(syy, sxz))));
      const float tr = fadd(fadd(sxx, syy), szz);
      resp[((size_t)b * D + c) * plane + (size_t)oy * W + ox] =
          fsub(det, fmul(fmul(fmul(harris_k, tr), tr), tr));
    }
  }
}

// Separable blur of the volume with the smooth taps (radius SR), the same
// column march with the input itself in the ring.
template <int SR>
__global__ void __launch_bounds__(Geom<SR>::NT)
blur_kernel(const float* __restrict__ vols, float* __restrict__ out, int D,
            int H, int W, int tiles_x, Taps s) {
  using G = Geom<SR>;
  constexpr int RX = G::RX, NTAP = G::NTAP;
  __shared__ float sZ[G::NCOL];
  __shared__ float sY[TY * RX];

  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x / tiles_x) * TY;
  const int tx0 = (blockIdx.x % tiles_x) * TX;
  const int tid = threadIdx.x;
  const bool col = tid < G::NCOL;
  const int y = ty0 - SR + tid / RX, x = tx0 - SR + tid % RX;
  const bool inside = col && y >= 0 && y < H && x >= 0 && x < W;
  const size_t plane = (size_t)H * W;
  const float* src = vols + (size_t)b * D * plane + (inside ? (size_t)y * W + x : 0);

  float rv[NTAP];
#pragma unroll
  for (int t = 0; t < NTAP; ++t) rv[t] = 0.f;

  for (int p = 0; p < D + SR; ++p) {
    const int c = p - SR;
    if (col) {
#pragma unroll
      for (int t = 0; t < NTAP - 1; ++t) rv[t] = rv[t + 1];
      rv[NTAP - 1] = (inside && p < D) ? src[(size_t)p * plane] : 0.f;
      if (c >= 0) {
        float acc = fmul(s.w[0], rv[0]);
#pragma unroll
        for (int t = 1; t < NTAP; ++t) acc = fadd(acc, fmul(s.w[t], rv[t]));
        sZ[tid] = acc;
      }
    }
    if (c < 0) continue;
    __syncthreads();
    for (int i = tid; i < TY * RX; i += G::NT) {
      const int yy = i / RX, xx = i % RX;
      float acc = fmul(s.w[0], sZ[yy * RX + xx]);
#pragma unroll
      for (int t = 1; t < NTAP; ++t)
        acc = fadd(acc, fmul(s.w[t], sZ[(yy + t) * RX + xx]));
      sY[i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < TY * TX; i += G::NT) {
      const int yy = i / TX, xx = i % TX;
      const int oy = ty0 + yy, ox = tx0 + xx;
      if (oy >= H || ox >= W) continue;
      const float* row = &sY[yy * RX + xx];
      float acc = fmul(s.w[0], row[0]);
#pragma unroll
      for (int t = 1; t < NTAP; ++t) acc = fadd(acc, fmul(s.w[t], row[t]));
      out[((size_t)b * D + c) * plane + (size_t)oy * W + ox] = acc;
    }
  }
}

template <int R>
void launch_structure(const float* vols, float* resp, int B, int D, int H,
                      int W, const Taps& g, float k, cudaStream_t st) {
  const int tx = (W + TX - 1) / TX, ty = (H + TY - 1) / TY;
  structure_kernel<R><<<dim3(tx * ty, B), Geom<R>::NT, 0, st>>>(
      vols, resp, D, H, W, tx, g, k);
}

template <int R>
void launch_blur(const float* vols, float* out, int B, int D, int H, int W,
                 const Taps& s, cudaStream_t st) {
  const int tx = (W + TX - 1) / TX, ty = (H + TY - 1) / TY;
  blur_kernel<R><<<dim3(tx * ty, B), Geom<R>::NT, 0, st>>>(vols, out, D, H, W,
                                                            tx, s);
}

}  // namespace

// vols (B, D, H, W) f32 -> resp (B, D, H, W) f32 and, when `smooth` is not
// null, the blur (B, D, H, W) f32, on `stream`. gauss / smooth_taps are
// host arrays of 2r+1 floats with radii 1 <= gr, sr <= 6. Returns
// cudaGetLastError() after the launches.
extern "C" int kcmc_response_fields_3d(const float* vols, float* resp,
                                       float* smooth, int B, int D, int H,
                                       int W, const float* gauss, int gr,
                                       const float* smooth_taps, int sr,
                                       float harris_k, void* stream) {
  if (gr < 1 || gr > MAXR || (smooth != nullptr && (sr < 1 || sr > MAXR)))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Taps g{}, s{};
  for (int i = 0; i < 2 * gr + 1; ++i) g.w[i] = gauss[i];
  switch (gr) {
    case 1: launch_structure<1>(vols, resp, B, D, H, W, g, harris_k, st); break;
    case 2: launch_structure<2>(vols, resp, B, D, H, W, g, harris_k, st); break;
    case 3: launch_structure<3>(vols, resp, B, D, H, W, g, harris_k, st); break;
    case 4: launch_structure<4>(vols, resp, B, D, H, W, g, harris_k, st); break;
    case 5: launch_structure<5>(vols, resp, B, D, H, W, g, harris_k, st); break;
    default: launch_structure<6>(vols, resp, B, D, H, W, g, harris_k, st); break;
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0 || smooth == nullptr) return rc;
  for (int i = 0; i < 2 * sr + 1; ++i) s.w[i] = smooth_taps[i];
  switch (sr) {
    case 1: launch_blur<1>(vols, smooth, B, D, H, W, s, st); break;
    case 2: launch_blur<2>(vols, smooth, B, D, H, W, s, st); break;
    case 3: launch_blur<3>(vols, smooth, B, D, H, W, s, st); break;
    case 4: launch_blur<4>(vols, smooth, B, D, H, W, s, st); break;
    case 5: launch_blur<5>(vols, smooth, B, D, H, W, s, st); break;
    default: launch_blur<6>(vols, smooth, B, D, H, W, s, st); break;
  }
  return (int)cudaGetLastError();
}
