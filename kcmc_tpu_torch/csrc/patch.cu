// K2 extract_blended: per-keypoint patch cut plus separable bilinear
// blend, keypoint-first, bf16 in and out; with moments (K6), also the
// ORB intensity-centroid moments of each raw patch.
//
// Replaces kcmc_tpu/ops/pallas_patch.py::extract_blended
// (extract_blended_planes / _blended_kernel, with_moments=False as K2 and
// with_moments=True as K6),
// and with it the banded (_extract_blended_planes_banded) and slab
// (_extract_blended_planes_slab) layouts that the TPU needed for frames
// past its VMEM budget: this kernel reads from device memory directly
// and has no size gate.
//
// For keypoint (x, y) it reads the P x P window of the edge-padded frame
// at (floor(y) + 1, floor(x) + 1) (reads past the padded frame clamp to
// its edge, as the Pallas wrapper's extra edge padding does) and writes
//   yb[i][j]  = (1 - fy) * p[i][j] + fy * p[i+1][j]
//   out[i][j] = bf16((1 - fx) * yb[i][j] + fx * yb[i][j+1])
// for the (P-1) x (P-1) output, in float32 on the bf16 pixel values,
// rounded as two fused multiply-adds:
//   yb  = fma(fy, p[i+1][j], (1 - fy) * p[i][j])
//   out = fma(1 - fx, yb[i][j], (fx * yb[i][j+1]))
// That is how the reference evaluates the expression on the CPU (XLA
// contracts it into exactly these FMAs; the uncontracted form differs
// from the reference in ~25% of the float32 results). Descriptor bits
// are order comparisons of the bf16 outputs, so the kernel must match
// its plain version bit for bit: the FMAs are explicit __fmaf_rn and
// every other operation an explicitly rounded __fmul_rn / __fsub_rn,
// and the build adds --fmad=false so the compiler contracts nothing else.
//
// Bound on the H100: memory. At B=32, K=512, 512x512 (padded 540x540)
// it must read 18.7 MB of frames and write 23.9 MB of patches, about
// 13 us at 3.35 TB/s; the arithmetic is ~95 MFLOP. One warp takes one
// keypoint, a lane one window column (two for P > 32), and marches down
// the rows: it loads its pixel of the new row, forms yb for its column
// with the previous row kept in a register, takes yb of column j + 1 from
// the next lane (__shfl_down_sync) and writes the output row to a
// per-warp shared buffer. The keypoint's (P-1)^2 outputs are one
// contiguous run in device memory; the warp writes it with 16-byte
// stores (the buffer is offset to the run's alignment, so the shared
// and global addresses agree modulo 16) and 2-byte stores for the
// unaligned head and tail. No block barrier, no runtime division: P is
// a template parameter for the sizes the paths use (28 and 32) and a
// runtime value in one general instantiation for the rest of [2, 64].
//
// K6 (WITH_MOMENTS): per keypoint also
//   m10 = sum patch * dx,  m01 = sum patch * dy
// over the MOMENT_RADIUS disc of the RAW window, centred at window index
// c + (qx, qy), c = (P - 2) / 2, q = (frac >= 0.5): the reference's
// `_moment_maps(P)` weights (pallas_patch.py:222). Each product of a bf16
// value and an integer |w| <= 7 is exact in float64, so after the blend
// the lane of a disc column reads its 15 disc rows again (from the cache)
// and sums that column's terms in float64 in row order; the 15 column
// sums (slot dx + 7; slot 15 holds +0.0) are
// then added pairwise by a fixed __shfl_xor_sync tree, (i, i + 8),
// (i, i + 4), (i, i + 2), (i, i + 1), and rounded once to float32. The
// plain version (_moments_plain) sums in the same order, so the two
// agree bit for bit (the TPU kernel sums in float32 in XLA's order, which
// interpret mode matches to a few ulps). At config 4 (B=32, K=512, P=32,
// 544^2 frames) K6 must read 18.9 MB and write 31.5 MB + 0.13 MB of
// moments, ~15 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXP = 64;
constexpr int MR = 7;      // MOMENT_RADIUS
constexpr int NSLOT = 16;  // the 2 * MR + 1 disc columns, padded to a power of two

// keypoints (warps) per block: the general instantiation stages up to
// 63 x 63 outputs a warp, so it takes fewer to stay in 48 KB
__host__ __device__ constexpr int kpb(int PT) { return PT == 0 ? 4 : 8; }
// window columns per lane
__host__ __device__ constexpr int cpl(int PT) { return PT == 0 ? 2 : (PT + 31) / 32; }
// bytes of one warp's output buffer: the largest run plus 16 for the
// alignment offset, rounded to 16
__host__ __device__ constexpr int stage_bytes(int PT) {
  return ((((PT == 0 ? MAXP : PT) - 1) * ((PT == 0 ? MAXP : PT) - 1) * 2 + 16) + 15) / 16 * 16;
}

template <int PT, bool WITH_MOMENTS>
__global__ void __launch_bounds__(32 * kpb(PT))
blend_kernel(const __nv_bfloat16* __restrict__ padded,
             const float* __restrict__ xy, __nv_bfloat16* __restrict__ out,
             float* __restrict__ m10, float* __restrict__ m01,
             int K, int Hp, int Wp, int P_rt) {
  constexpr int KPB = kpb(PT), CPL = cpl(PT);
  __shared__ __align__(16) unsigned char stage[KPB][stage_bytes(PT)];
  __shared__ double slot_x[WITH_MOMENTS ? KPB : 1][NSLOT];
  __shared__ double slot_y[WITH_MOMENTS ? KPB : 1][NSLOT];

  const int P = PT ? PT : P_rt;
  const int Pb = P - 1;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int k = blockIdx.x * KPB + w;
  if (k >= K) return;  // whole warps; nothing below waits on the block

  const size_t kp = (size_t)b * K + k;
  const float x = xy[kp * 2 + 0], y = xy[kp * 2 + 1];
  const float flx = floorf(x), fly = floorf(y);
  const float fx = __fsub_rn(x, flx), fy = __fsub_rn(y, fly);
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const int ox = (int)flx + 1, oy = (int)fly + 1;
  const __nv_bfloat16* frame = padded + (size_t)b * Hp * Wp;

  int col[CPL];  // clamped frame column of each of the lane's window columns
#pragma unroll
  for (int c = 0; c < CPL; ++c) col[c] = min(max(ox + lane * CPL + c, 0), Wp - 1);

  // the output run of this keypoint, and the buffer offset to its alignment
  __nv_bfloat16* gout = out + kp * (size_t)(Pb * Pb);
  const int mis = (int)((uintptr_t)gout & 15);
  __nv_bfloat16* so = (__nv_bfloat16*)(stage[w] + mis);

  float prev[CPL];
  {
    const __nv_bfloat16* rp = frame + (size_t)min(max(oy, 0), Hp - 1) * Wp;
#pragma unroll
    for (int c = 0; c < CPL; ++c) prev[c] = __bfloat162float(rp[col[c]]);
  }
#pragma unroll
  for (int i = 1; i < P; ++i) {
    const __nv_bfloat16* rp = frame + (size_t)min(max(oy + i, 0), Hp - 1) * Wp;
    float cur[CPL], yb[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) cur[c] = __bfloat162float(rp[col[c]]);
#pragma unroll
    for (int c = 0; c < CPL; ++c) yb[c] = __fmaf_rn(fy, cur[c], __fmul_rn(gy, prev[c]));
    const float next = __shfl_down_sync(0xffffffffu, yb[0], 1);
    __nv_bfloat16* orow = so + (i - 1) * Pb;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int j = lane * CPL + c;
      const float yb1 = c + 1 < CPL ? yb[c + 1] : next;
      if (j < Pb) orow[j] = __float2bfloat16_rn(__fmaf_rn(gx, yb[c], __fmul_rn(fx, yb1)));
    }
#pragma unroll
    for (int c = 0; c < CPL; ++c) prev[c] = cur[c];
  }

  if constexpr (WITH_MOMENTS) {
    // each disc column's terms in float64, in row order, from the rows
    // just read (cached)
    const int cc = (P - 2) / 2;
    const int cy = cc + (fy >= 0.5f ? 1 : 0), cx = cc + (fx >= 0.5f ? 1 : 0);
    double sx[CPL], sy[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int dx = lane * CPL + c - cx;
      const int dx2 = dx >= -MR && dx <= MR ? dx * dx : MR * MR + 1;  // outside: no row
      const double ddx = (double)dx;
      double ax = 0.0, ay = 0.0;
#pragma unroll
      for (int dy = -MR; dy <= MR; ++dy) {
        const int r = min(max(oy + cy + dy, 0), Hp - 1);
        const float v = __bfloat162float(frame[(size_t)r * Wp + col[c]]);
        if (dx2 <= MR * MR - dy * dy) {
          ax = __dadd_rn(ax, __dmul_rn((double)v, ddx));
          ay = __dadd_rn(ay, __dmul_rn((double)v, (double)dy));
        }
      }
      sx[c] = ax;
      sy[c] = ay;
    }
    // slot dx + MR of each disc column, +0.0 in the slots no column fills
    if (lane < NSLOT) slot_x[w][lane] = slot_y[w][lane] = 0.0;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int dx = lane * CPL + c - cx;
      if (dx >= -MR && dx <= MR) {
        slot_x[w][dx + MR] = sx[c];
        slot_y[w][dx + MR] = sy[c];
      }
    }
    __syncwarp();
    double tx = slot_x[w][lane & (NSLOT - 1)], ty = slot_y[w][lane & (NSLOT - 1)];
#pragma unroll
    for (int h = NSLOT / 2; h >= 1; h >>= 1) {
      tx = __dadd_rn(tx, __shfl_xor_sync(0xffffffffu, tx, h));
      ty = __dadd_rn(ty, __shfl_xor_sync(0xffffffffu, ty, h));
    }
    if (lane == 0) {
      m10[kp] = __double2float_rn(tx);
      m01[kp] = __double2float_rn(ty);
    }
  }

  // the run: a 2-byte head up to 16-byte alignment, 16-byte stores, a tail
  __syncwarp();
  const int n = Pb * Pb;
  const int head = min(n, ((16 - mis) & 15) / 2);
  const int nvec = (n - head) / 8;
  if (lane < head) gout[lane] = so[lane];
  const uint4* sv = (const uint4*)(so + head);
  uint4* gv = (uint4*)(gout + head);
  for (int v = lane; v < nvec; v += 32) gv[v] = sv[v];
  for (int e = head + nvec * 8 + lane; e < n; e += 32) gout[e] = so[e];
}

template <int PT>
int launch(const void* padded, const float* xy, void* out, float* m10, float* m01,
           int B, int K, int Hp, int Wp, int P, bool mom, cudaStream_t st) {
  const dim3 grid((K + kpb(PT) - 1) / kpb(PT), B);
  const auto* in = (const __nv_bfloat16*)padded;
  auto* o = (__nv_bfloat16*)out;
  if (mom)
    blend_kernel<PT, true><<<grid, 32 * kpb(PT), 0, st>>>(in, xy, o, m10, m01, K, Hp, Wp, P);
  else
    blend_kernel<PT, false><<<grid, 32 * kpb(PT), 0, st>>>(in, xy, o, nullptr, nullptr, K,
                                                           Hp, Wp, P);
  return (int)cudaGetLastError();
}

}  // namespace

// padded (B, Hp, Wp) bf16, xy (B, K, 2) f32 -> out (B, K, P-1, P-1) bf16
// and, when m10 and m01 are not null, the (B, K) f32 moments (K6; needs
// P >= 2 * MR + 3 so the disc fits the window), on `stream`. Returns
// cudaGetLastError() after the launch.
extern "C" int kcmc_extract_blended(const void* padded, const float* xy,
                                    void* out, float* m10, float* m01,
                                    int B, int K, int Hp, int Wp, int P,
                                    void* stream) {
  if (P < 2 || P > MAXP) return (int)cudaErrorInvalidValue;
  const bool mom = m10 != nullptr && m01 != nullptr;
  if (mom && P < 2 * MR + 3) return (int)cudaErrorInvalidValue;
  if (B < 1 || K < 1 || Hp < 1 || Wp < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (P) {
    case 28: return launch<28>(padded, xy, out, m10, m01, B, K, Hp, Wp, P, mom, st);
    case 32: return launch<32>(padded, xy, out, m10, m01, B, K, Hp, Wp, P, mom, st);
    default: return launch<0>(padded, xy, out, m10, m01, B, K, Hp, Wp, P, mom, st);
  }
}
