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
// NMS stays outside (ops/detect3d.py), as in the reference. The blur is
// computed in the same pass from the same staged input, as the TPU
// kernel computes it on its resident slab.
//
// Bound on the H100: at config 5 (B=8, 32x256x256) the function reads
// 67 MB and writes 134 MB (response and blur), 0.060 ms at 3.35 TB/s,
// and needs ~490 float32 operations per voxel (6 x 3 x 21 window, 3 x 25
// blur, gradients, products, response). Every operation is one rounded
// instruction (the plain version rounds each, and the build has
// --fmad=false), so the floor is the float32 issue rate, 33.5 T
// instructions/s: 0.24 ms. Halo work is the lever. The design:
//   * A block owns TZ x TY output (z, y) points of one volume, one thread
//     each, and marches x across the whole width. The z and y windows run
//     on each new x-slice; the x window, the last pass, is a shift
//     register: each thread keeps the six entries of the 2 GR + 1 outputs
//     still collecting taps, the output that has taken t taps in register
//     t; each new slice's terms move every output one register on (the
//     add writes the next register, so nothing else moves), and one
//     output completes per slice, its response formed at once. So the x
//     pass and the y pass do no halo work, and the z pass only the y halo
//     (42 of 32 rows).
//   * The six products are formed once per voxel (of the slice region).
//   * The input streams through a ring of 16 x-slices of the (z, y)
//     region plus a halo of max(GR + 1, SR) in shared memory, two bricks
//     of 8 slices: 4-byte cp.async (zero-filled outside the volume), a
//     warp covering 32-byte runs of x, one brick in flight while the
//     other is read.
//   * The z pass and the y pass run as items of 8 consecutive outputs of
//     one entry, sliding over values in registers (the y items load them
//     as float4); the y pass takes the slice before the z pass's, so both
//     share one phase, and the thread of a point then reads its six
//     y-windowed entries. The blur takes the same slice through z (items
//     of two outputs) and y into a ring of 24 y-blurred slices; every 8
//     slices an item of 8 x outputs per point slides over them.
//   * Two barriers per slice. Responses are staged per thread, 4 x at a
//     time, and stored as 16-byte runs; a blur x item stores 32 bytes.
//   * 512 threads and up to 224,128 bytes of dynamic shared memory (the
//     entry point sets the limit and returns a refusal): one block per
//     SM. Two threads per point (1024, three entries each) were slower.
// Every product and sum is an explicitly rounded float32 operation in the
// order of the plain PyTorch version (response_fields_3d_plain), and the
// zero padding is computed, not skipped (a window tap on padding adds
// +0.0, which turns a -0.0 sum into +0.0), so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXR = 6;
constexpr int TZ = 16;        // output planes of a block
constexpr int TY = 32;        // output rows of a block (a warp per plane)
constexpr int NT = TZ * TY;   // threads: one per (z, y) point
constexpr int XB = 8;         // x-slices of a staged brick
constexpr int NS = 2 * XB;    // x-slices of the input ring
constexpr int Q = 8;          // outputs of a z-pass or y-pass item
constexpr int NSTAGE = 4;     // responses staged per point before a store
constexpr int XQ = 8;         // blur outputs of an x-pass item
constexpr int NXR = 3 * XQ;   // y-blurred slices kept for the x pass

struct Taps {
  float w[2 * MAXR + 1];
};

__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

// window radius GR, blur radius SR (0: no blur)
template <int GR, int SR>
struct Geo {
  static constexpr int N = 2 * GR + 1;   // window taps, and x-window registers
  static constexpr int NB = 2 * SR + 1;  // blur taps
  static constexpr int HZ = GR + 1 > SR ? GR + 1 : SR;  // input halo in z and y
  static constexpr int RZ = TZ + 2 * HZ, RY = TY + 2 * HZ;  // staged slice
  static constexpr int PZ = TZ + 2 * GR, PY = TY + 2 * GR;  // product region
  static constexpr int PYS = (PY + 3) / 4 * 4;  // z-windowed row stride (16-byte rows)
  static constexpr int BW = TY + 2 * SR;        // z-blurred rows
  static constexpr int YV = (Q + 2 * GR + 3) / 4;  // float4 loads of a y-pass item
  // shared memory, in floats
  static constexpr int RING = NS * RZ * RY;
  static constexpr int PROD = 6 * PZ * PY;
  static constexpr int ZWIN = 2 * 6 * TZ * PYS;  // two slices
  static constexpr int YWIN = 6 * NT;
  static constexpr int BZ = SR ? TZ * BW : 0;
  static constexpr int BRING = SR ? NXR * NT : 0;
  static constexpr int STAGE = NSTAGE * NT;
  static constexpr int FLOATS = RING + PROD + ZWIN + YWIN + BZ + BRING + STAGE;
  static constexpr int BITEMS = SR ? TZ / 2 * BW : 0;  // z-blur items of two outputs
  static_assert(2 * SR + XQ <= NXR, "an x-blur item's slices are still in the ring");
  static constexpr int ZITEMS = 6 * (TZ / Q) * PY;
  static constexpr int YITEMS = 6 * TZ * (TY / Q);
  static_assert(4 * YV <= PYS - (TY - Q), "a y-pass item's loads stay in its row");
};

__device__ __forceinline__ float harris3(float sxx, float syy, float szz, float sxy, float sxz,
                                         float syz, float k) {
  const float det =
      fadd(fsub(fmul(sxx, fsub(fmul(syy, szz), fmul(syz, syz))),
                fmul(sxy, fsub(fmul(sxy, szz), fmul(syz, sxz)))),
           fmul(sxz, fsub(fmul(sxy, syz), fmul(syy, sxz))));
  const float tr = fadd(fadd(sxx, syy), szz);
  return fsub(det, fmul(fmul(fmul(k, tr), tr), tr));
}

// The x-blur of the XQ outputs [x0, x0 + XQ) of one point from the ring
// of y-blurred slices (slot = slice mod NXR; x0 = XQ m, PH = m mod 3, so
// every slot is static), slices x0 - SR .. x0 + XQ - 1 + SR in tap order.
template <int SR, int PH>
__device__ __forceinline__ void blur_x(const float* ring, const Taps& sw, float (&a)[XQ]) {
  constexpr int NB = 2 * SR + 1;
#pragma unroll
  for (int i = 0; i < XQ + NB - 1; ++i) {
    const float v = ring[((PH * XQ - SR + i + NXR) % NXR) * NT];
#pragma unroll
    for (int j = 0; j < XQ; ++j) {
      const int t = i - j;
      if (t == 0) a[j] = fmul(sw.w[0], v);
      else if (t > 0 && t < NB) a[j] = fadd(a[j], fmul(sw.w[t], v));
    }
  }
}

template <int GR, int SR>
__global__ void __launch_bounds__(NT, 1)
structure_kernel(const float* __restrict__ vols, float* __restrict__ resp,
                 float* __restrict__ smooth, int D, int H, int W, int tiles_y,
                 Taps g, Taps sw, float harris_k, int vec_ok) {
  using G = Geo<GR, SR>;
  constexpr int N = G::N, NB = G::NB, HZ = G::HZ, RZ = G::RZ, RY = G::RY;
  constexpr int PZ = G::PZ, PY = G::PY, BW = G::BW;
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                   // [NS][RZ][RY] input x-slices
  float* prod = ring + G::RING;         // [6][PZ][PY] products of one slice
  float* zwin = prod + G::PROD;         // [2][6][TZ][PYS] z-windowed, by slice parity
  float* ywin = zwin + G::ZWIN;         // [6][NT] y-windowed
  float* bz = ywin + G::YWIN;           // [TZ][BW] z-blurred
  float* bring = bz + G::BZ;            // [NXR][NT] y-blurred slices
  float* stage = bring + G::BRING;      // [NSTAGE][NT] responses

  const int tid = threadIdx.x;
  const int zo = tid / TY, yo = tid % TY;
  const int b = blockIdx.y;
  const int ty0 = (blockIdx.x % tiles_y) * TY, tz0 = (blockIdx.x / tiles_y) * TZ;
  const size_t vplane = (size_t)H * W;
  const float* vb = vols + (size_t)b * D * vplane;
  const bool own = tz0 + zo < D && ty0 + yo < H;
  const size_t orow = own ? (((size_t)b * D + tz0 + zo) * H + ty0 + yo) * W : 0;

  // brick k: x-slices [k XB, k XB + XB) of the (RZ, RY) region into ring
  // slots x mod NS; lane bits 0-2 pick x, so a warp reads 32-byte runs
  const int xi = tid % XB;
  auto load_brick = [&](int k) {
    const int x = k * XB + xi;
    const bool xin = x >= 0 && x < W;
    float* dst = ring + (x & (NS - 1)) * RZ * RY;
    constexpr int STEP = NT / XB;
    int zr = (tid / XB) / RY, yr = (tid / XB) % RY;
    for (int row = tid / XB; row < RZ * RY; row += STEP) {
      const int z = tz0 - HZ + zr, y = ty0 - HZ + yr;
      const bool in = xin && (unsigned)z < (unsigned)D && (unsigned)y < (unsigned)H;
      cp_async4(dst + row, in ? vb + (size_t)z * vplane + (size_t)y * W + x : vb, in);
      yr += STEP % RY;
      zr += STEP / RY;
      if (yr >= RY) {
        yr -= RY;
        ++zr;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // responses are staged per point, NSTAGE consecutive x, then stored
  auto put = [&](float* out, int x, float v) {
    stage[(x % NSTAGE) * NT + tid] = v;
    if (x % NSTAGE != NSTAGE - 1 && x != W - 1) return;
    if (!own) return;
    const int x0 = x - x % NSTAGE;
    float* o = out + orow + x0;
    if (x % NSTAGE == NSTAGE - 1 && vec_ok) {
      *(float4*)o = make_float4(stage[0 * NT + tid], stage[1 * NT + tid],
                                stage[2 * NT + tid], stage[3 * NT + tid]);
    } else {
      for (int i = 0; i <= x % NSTAGE; ++i) o[i] = stage[i * NT + tid];
    }
  };

  load_brick(-1);  // zeros: the slices before the volume
  load_brick(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  for (int i = tid; i < G::BRING; i += NT) bring[i] = 0.f;
  __syncthreads();

  float acc[6][N];
#pragma unroll
  for (int e = 0; e < 6; ++e)
#pragma unroll
    for (int j = 0; j < N; ++j) acc[e][j] = 0.f;

  // the product items of this thread: q0, q0 + NT, ... (after the z-blur
  // items in one numbering, so threads with a z-blur item start later)
  const int q0 = ((tid - G::BITEMS) % NT + NT) % NT;
  const int zz0 = q0 / PY, yy0 = q0 % PY;

  // step s: input slice s is visible; the structure forms the products
  // and the z window of slice sp = s - 1 (its x gradient reads slice s)
  // and the y and x windows of slice sx = s - 2; the blur takes
  // slice s through z and y, and every XQ slices XQ outputs through x
  const int xb_end = (W + XQ - 1) / XQ * XQ - 1 + SR;  // the last x-blur item
  const int s_end = SR ? max(W + GR + 1, xb_end) : W + GR + 1;
  for (int s = 0; s <= s_end; ++s) {
    const int sp = s - 1, sx = s - 2;
    const bool slice = sp >= 0 && sp < W;
    const bool yslice = sx >= 0 && sx < W;
    // A: z-blur of slice s (items of two outputs); products of slice sp
    if (s % XB == 2) load_brick(s / XB + 1);
    if (SR && s < W) {
      for (int i = tid; i < G::BITEMS; i += NT) {
        const int z = i / BW * 2, yy = i % BW;
        const float* c = ring + ((s & (NS - 1)) * RZ + z + HZ - SR) * RY + yy + HZ - SR;
        float a0 = fmul(sw.w[0], c[0]), a1 = fmul(sw.w[0], c[RY]);
#pragma unroll
        for (int t = 1; t < NB; ++t) {
          a0 = fadd(a0, fmul(sw.w[t], c[t * RY]));
          a1 = fadd(a1, fmul(sw.w[t], c[(t + 1) * RY]));
        }
        bz[z * BW + yy] = a0;
        bz[(z + 1) * BW + yy] = a1;
      }
    }
    if (slice) {
      // slices sp - 1 and s at fixed offsets from slice sp
      const float* rc = ring + (sp & (NS - 1)) * RZ * RY + (HZ - GR) * (RY + 1);
      const int dm = (((sp - 1) & (NS - 1)) - (sp & (NS - 1))) * RZ * RY;
      const int dp = ((s & (NS - 1)) - (sp & (NS - 1))) * RZ * RY;
      int zz = zz0, yy = yy0;
      for (int q = q0; q < PZ * PY; q += NT) {
        const int z = tz0 - GR + zz, y = ty0 - GR + yy;
        float gx = 0.f, gy = 0.f, gz = 0.f;
        if ((unsigned)z < (unsigned)D && (unsigned)y < (unsigned)H) {
          const float* c = rc + zz * RY + yy;
          gx = fmul(0.5f, fsub(c[dp], c[dm]));
          gy = fmul(0.5f, fsub(c[1], c[-1]));
          gz = fmul(0.5f, fsub(c[RY], c[-RY]));
        }
        float* d = prod + q;
        // out of the volume every product is 0 (+0.0: the gradients are +0.0)
        d[0 * PZ * PY] = fmul(gx, gx);
        d[1 * PZ * PY] = fmul(gy, gy);
        d[2 * PZ * PY] = fmul(gz, gz);
        d[3 * PZ * PY] = fmul(gx, gy);
        d[4 * PZ * PY] = fmul(gx, gz);
        d[5 * PZ * PY] = fmul(gy, gz);
        zz += NT / PY;
        yy += NT % PY;
        if (yy >= PY) {
          yy -= PY;
          ++zz;
        }
      }
    }
    if (s % XB == XB - 1) asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // B: z window of slice sp (items of Q outputs of one entry and row),
    // y window of slice sx (items of Q outputs of one entry and plane);
    // y-blur of slice s into its ring slot
    if (slice) {
      for (int i = tid; i < G::ZITEMS; i += NT) {
        const int yy = i % PY, r = i / PY;
        const int zg = r % (TZ / Q), e = r / (TZ / Q);
        const float* src = prod + (e * PZ + zg * Q) * PY + yy;
        float a[Q];
#pragma unroll
        for (int ii = 0; ii < Q + N - 1; ++ii) {
          const float v = src[ii * PY];
#pragma unroll
          for (int j = 0; j < Q; ++j) {
            const int t = ii - j;
            if (t == 0) a[j] = fmul(g.w[0], v);
            else if (t > 0 && t < N) a[j] = fadd(a[j], fmul(g.w[t], v));
          }
        }
        float* dst = zwin + ((sp & 1) * 6 * TZ + e * TZ + zg * Q) * G::PYS + yy;
#pragma unroll
        for (int j = 0; j < Q; ++j) dst[j * G::PYS] = a[j];
      }
    }
    if (yslice) {
      for (int i = tid; i < G::YITEMS; i += NT) {
        const int yg = i % (TY / Q), r = i / (TY / Q);  // r = e * TZ + z
        const float4* src =
            (const float4*)(zwin + ((sx & 1) * 6 * TZ + r) * G::PYS + yg * Q);
        float v[4 * G::YV];
#pragma unroll
        for (int q = 0; q < G::YV; ++q) {
          const float4 f = src[q];
          v[4 * q] = f.x;
          v[4 * q + 1] = f.y;
          v[4 * q + 2] = f.z;
          v[4 * q + 3] = f.w;
        }
        float a[Q];
#pragma unroll
        for (int j = 0; j < Q; ++j) {
          a[j] = fmul(g.w[0], v[j]);
#pragma unroll
          for (int t = 1; t < N; ++t) a[j] = fadd(a[j], fmul(g.w[t], v[j + t]));
        }
        float4* dst = (float4*)(ywin + r * TY + yg * Q);
#pragma unroll
        for (int q = 0; q < Q / 4; ++q)
          dst[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
      }
    }
    if (SR) {
      float v = 0.f;
      if (s < W) {
        const float* c = bz + zo * BW + yo;
        v = fmul(sw.w[0], c[0]);
#pragma unroll
        for (int t = 1; t < NB; ++t) v = fadd(v, fmul(sw.w[t], c[t]));
      }
      bring[(s % NXR) * NT + tid] = v;
    }
    __syncthreads();

    // C: slice sx into the x window (zeros past the volume);
    // x-blur of slices s - 2 SR .. s (the ring's zeros outside the volume)
    if (sx >= 0) {
      // the output that has taken taps 0 .. t - 1 takes tap t and moves
      // to acc[t]; acc[0] starts the output x = sx + GR, acc[N - 1]
      // completes x = sx - GR
#pragma unroll
      for (int e = 0; e < 6; ++e) {
        const float yv = yslice ? ywin[e * NT + tid] : 0.f;
#pragma unroll
        for (int t = N - 1; t >= 1; --t) acc[e][t] = fadd(acc[e][t - 1], fmul(g.w[t], yv));
        acc[e][0] = fmul(g.w[0], yv);
      }
      const int x = sx - GR;
      if (x >= 0 && x < W)
        put(resp, x, harris3(acc[0][N - 1], acc[1][N - 1], acc[2][N - 1], acc[3][N - 1],
                             acc[4][N - 1], acc[5][N - 1], harris_k));
    }
    if (SR && s >= XQ - 1 + SR && (s - SR) % XQ == XQ - 1) {
      const int x0 = s - SR - (XQ - 1), ph = x0 / XQ % 3;
      float a[XQ];
      if (ph == 0) blur_x<SR, 0>(bring + tid, sw, a);
      else if (ph == 1) blur_x<SR, 1>(bring + tid, sw, a);
      else blur_x<SR, 2>(bring + tid, sw, a);
      if (own) {
        float* o = smooth + orow + x0;
        if (x0 + XQ <= W && vec_ok) {
          *(float4*)o = make_float4(a[0], a[1], a[2], a[3]);
          *(float4*)(o + 4) = make_float4(a[4], a[5], a[6], a[7]);
        } else {
#pragma unroll
          for (int j = 0; j < XQ; ++j)
            if (x0 + j < W) o[j] = a[j];
        }
      }
    }
  }
}

template <int GR, int SR>
int launch(const float* vols, float* resp, float* smooth, int B, int D, int H, int W,
           const Taps& g, const Taps& s, float k, cudaStream_t st) {
  const int smem = Geo<GR, SR>::FLOATS * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(structure_kernel<GR, SR>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_y = (H + TY - 1) / TY, tiles_z = (D + TZ - 1) / TZ;
  const int vec_ok = W % 4 == 0 && (uintptr_t)resp % 16 == 0 &&
                     (smooth == nullptr || (uintptr_t)smooth % 16 == 0);
  structure_kernel<GR, SR><<<dim3(tiles_y * tiles_z, B), NT, smem, st>>>(
      vols, resp, smooth, D, H, W, tiles_y, g, s, k, vec_ok);
  return (int)cudaGetLastError();
}

template <int GR>
int launch_gr(int sr, const float* vols, float* resp, float* smooth, int B, int D, int H,
              int W, const Taps& g, const Taps& s, float k, cudaStream_t st) {
  switch (sr) {
    case 0: return launch<GR, 0>(vols, resp, smooth, B, D, H, W, g, s, k, st);
    case 1: return launch<GR, 1>(vols, resp, smooth, B, D, H, W, g, s, k, st);
    case 2: return launch<GR, 2>(vols, resp, smooth, B, D, H, W, g, s, k, st);
    case 3: return launch<GR, 3>(vols, resp, smooth, B, D, H, W, g, s, k, st);
    case 4: return launch<GR, 4>(vols, resp, smooth, B, D, H, W, g, s, k, st);
    case 5: return launch<GR, 5>(vols, resp, smooth, B, D, H, W, g, s, k, st);
    default: return launch<GR, 6>(vols, resp, smooth, B, D, H, W, g, s, k, st);
  }
}

}  // namespace

// vols (B, D, H, W) f32 -> resp (B, D, H, W) f32 and, when `smooth` is not
// null, the blur (B, D, H, W) f32, in one launch on `stream`. gauss /
// smooth_taps are host arrays of 2r+1 floats with radii 1 <= gr, sr <= 6.
// Returns the error of the shared-memory attribute or cudaGetLastError()
// after the launch.
extern "C" int kcmc_response_fields_3d(const float* vols, float* resp,
                                       float* smooth, int B, int D, int H,
                                       int W, const float* gauss, int gr,
                                       const float* smooth_taps, int sr,
                                       float harris_k, void* stream) {
  if (gr < 1 || gr > MAXR || (smooth != nullptr && (sr < 1 || sr > MAXR)))
    return (int)cudaErrorInvalidValue;
  if (B < 1 || B > 65535 || D < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Taps g{}, s{};
  for (int i = 0; i < 2 * gr + 1; ++i) g.w[i] = gauss[i];
  if (smooth == nullptr) sr = 0;
  for (int i = 0; i < 2 * sr + 1 && sr > 0; ++i) s.w[i] = smooth_taps[i];
  switch (gr) {
    case 1: return launch_gr<1>(sr, vols, resp, smooth, B, D, H, W, g, s, harris_k, st);
    case 2: return launch_gr<2>(sr, vols, resp, smooth, B, D, H, W, g, s, harris_k, st);
    case 3: return launch_gr<3>(sr, vols, resp, smooth, B, D, H, W, g, s, harris_k, st);
    case 4: return launch_gr<4>(sr, vols, resp, smooth, B, D, H, W, g, s, harris_k, st);
    case 5: return launch_gr<5>(sr, vols, resp, smooth, B, D, H, W, g, s, harris_k, st);
    default: return launch_gr<6>(sr, vols, resp, smooth, B, D, H, W, g, s, harris_k, st);
  }
}
