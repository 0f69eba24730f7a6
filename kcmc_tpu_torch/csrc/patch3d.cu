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
// --fmad=false. Each yb and xb is the same float whichever output reads
// it, so each is formed once: kernel, plain version and interpret mode
// agree bit for bit.
//
// Bound on the H100: memory. At config 5 (B=8, K=512, Pz=8, Pxy=20) it
// writes 41.4 MB of patches and reads the union of the slabs (about 30 MB
// on config 5's scenes), ~0.021 ms at 3.35 TB/s; the arithmetic is ~0.1
// GFLOP. One warp takes one keypoint, a lane one slab column (two for
// Pxy > 32), with no block barrier and no runtime division (MUFU.RCP 0 in
// the SASS). It marches the slab plane by plane and, within a plane, row
// by row, so each voxel is loaded once: a whole plane's loads are issued
// together while the plane before it is blended; yb of row y is formed
// from row y + 1 and the previous row kept in a register, yb of column
// x + 1 comes from the next lane (__shfl_down_sync), and the previous
// plane's x-lerps wait in registers, one per output row, for the z-lerp.
// That state (two planes of rows and a plane of x-lerps) takes 128
// registers, so an SM holds 16 warps. At Pxy = 20 twelve lanes load a
// repeated column and write nothing: the kernel issues ~3000 warp
// instructions a keypoint, ~0.012 ms of issue at config 5 by that count,
// so the idle lanes are not what bounds it. Outputs are produced in the
// order of the keypoint's contiguous run (plane, row, column) into a
// per-warp ring in shared memory, addressed like the run modulo 16 bytes.
// After every second plane (once 32 pieces wait, in the general
// instantiation) one lane hands the whole 16-byte pieces to the copy
// engine as bulk copies (cp.async.bulk, one or two per flush), so the
// stores leave without the warp's instructions; the run's unaligned head
// and tail go with 4-byte stores. A keypoint whose slab lies inside the
// padded volume takes a path without clamps. Pz and Pxy are template
// parameters for the path's sizes (8, 20); one general instantiation
// takes the rest of [2, 64] row by row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KPB = 4;     // keypoints (warps) a block
constexpr int MIN_BLOCKS = 4;  // blocks an SM holds: at most 128 registers a thread
constexpr int MAXP = 64;   // the wrapper's largest side
constexpr int RING = 2048;  // floats of a warp's output ring (a power of two)
constexpr unsigned FULL = 0xffffffffu;

// slab columns a lane holds
__host__ __device__ constexpr int cpl(int PT) { return PT == 0 ? 2 : (PT + 31) / 32; }

// a bulk copy of n floats (n % 4 == 0, both ends 16-byte aligned) from
// shared memory to device memory, in the thread's bulk async-group
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int n) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"((unsigned)__cvta_generic_to_shared(src)), "r"(n * 4)
               : "memory");
}

struct Frac {
  float fx, fy, fz, gx, gy, gz;
};

// One keypoint's run: `vol` its volume, `gout` the first of its
// (Pz-1)(Pxy-1)^2 outputs, (ox, oy, oz) the slab origin. CLAMP clamps
// every slab index to the volume.
template <int PZT, int PXYT, bool CLAMP>
__device__ __forceinline__ void march(const float* __restrict__ vol, float* __restrict__ gout,
                                      float* __restrict__ ring, int lane, int Dp, int Hp,
                                      int Wp, int Pz, int Pxy, int ox, int oy, int oz,
                                      const Frac f) {
  constexpr int CPL = cpl(PXYT);
  constexpr int NR = PXYT ? PXYT : MAXP;  // rows of a plane
  const int Pb = Pxy - 1;
  const int n_out = (Pz - 1) * Pb * Pb;
  // the run in 16-byte pieces: position p of the run is ring slot
  // (mis + p) & (RING - 1) and piece (mis + p) >> 2
  const int mis = (int)(((uintptr_t)gout >> 2) & 3);

  int gcol[CPL];  // the lane's volume columns (past the slab: its last)
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int x = ox + min(lane * CPL + c, Pxy - 1);
    gcol[c] = CLAMP ? min(max(x, 0), Wp - 1) : x;
  }
  // the slab's rows are loaded in order, z then y: (lz, ly) is the next
  // one; inside the volume one pointer walks them
  int lz = 0, ly = 0;
  const float* lp = vol + ((size_t)oz * Hp + oy) * Wp;
  auto load_row = [&](float* dst) {
    const float* rp =
        CLAMP ? vol + ((size_t)min(max(oz + lz, 0), Dp - 1) * Hp + min(max(oy + ly, 0), Hp - 1)) * Wp
              : lp;
#pragma unroll
    for (int c = 0; c < CPL; ++c) dst[c] = __ldg(rp + gcol[c]);
    lp += Wp;
    if (++ly == Pxy) {
      ly = 0;
      ++lz;
      lp += (size_t)(Hp - Pxy) * Wp;
    }
  };

  int done = 0;     // outputs written to the ring
  int flushed = 0;  // pieces stored
  // store the pieces up to the last whole one (every piece when `last`)
  // The whole pieces leave by bulk copies (the async proxy reads the
  // ring: every lane fences its ring writes first); a copy's ring slots
  // are rewritten only after the next flush has waited for its reads.
  auto flush = [&](bool last) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    const int end = last ? (mis + n_out + 3) >> 2 : (mis + done) >> 2;
    // whole pieces [v0, v1), in at most two copies (the ring wraps)
    const int v0 = max(flushed, (mis + 3) >> 2), v1 = min(end, (mis + n_out) >> 2);
    if (lane == 0) {
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      if (v1 > v0) {
        const int a0 = v0 << 2, n = (v1 - v0) << 2;
        const int s0 = a0 & (RING - 1);
        const int first = min(n, RING - s0);
        bulk_store(gout + (a0 - mis), ring + s0, first);
        if (n > first) bulk_store(gout + (a0 - mis + first), ring, n - first);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
      if (last) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    // the run's partial head and tail pieces, float by float
    for (int v = flushed + lane; v < end; v += 32) {
      const int a = v << 2;
      if (v < v0 || v >= v1) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (a + e >= mis && a + e < mis + n_out) gout[a + e - mis] = ring[(a + e) & (RING - 1)];
      }
    }
    flushed = end;
    __syncwarp();
  };

  // rows in flight: the slab's rows, in order, in groups of G (a plane of
  // the template, a row of the general instantiation); a group is loaded,
  // all its loads at once, while the one before it is blended
  constexpr int G = PXYT ? PXYT : 1;
  float cur[G][CPL], nxt[G][CPL];
#pragma unroll
  for (int i = 0; i < G; ++i) load_row(cur[i]);
  float xbp[NR - 1][CPL];  // the previous plane's x-lerps, by output row
  float prev[CPL];
#pragma unroll 1
  for (int z = 0; z < Pz; ++z) {
#pragma unroll
    for (int g = 0; g < (PXYT ? 1 : Pxy); ++g) {
      if (lz < Pz) {
#pragma unroll
        for (int i = 0; i < G; ++i) load_row(nxt[i]);
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int y = g * G + i;
        if (y > 0) {
          const int yo = y - 1;  // the output row
          float yb[CPL];
#pragma unroll
          for (int c = 0; c < CPL; ++c)
            yb[c] = __fmaf_rn(f.fy, cur[i][c], __fmul_rn(f.gy, prev[c]));
          const float right = __shfl_down_sync(FULL, yb[0], 1);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            const int x = lane * CPL + c;
            const float yb1 = c + 1 < CPL ? yb[c + 1] : right;
            const float xb = __fmaf_rn(f.gx, yb[c], __fmul_rn(f.fx, yb1));
            if (z > 0 && x < Pb)
              ring[(mis + done + x) & (RING - 1)] = __fmaf_rn(f.gz, xbp[yo][c], __fmul_rn(f.fz, xb));
            xbp[yo][c] = xb;
          }
          if (z > 0) {
            done += Pb;
            // PXYT: after every second plane; general: once a warp's worth
            // of pieces waits
            if (PXYT ? yo == PXYT - 2 && (z & 1) == 0 : ((mis + done) >> 2) - flushed >= 32)
              flush(false);
          }
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c) prev[c] = cur[i][c];
      }
#pragma unroll
      for (int i = 0; i < G; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c) cur[i][c] = nxt[i][c];
    }
  }
  flush(true);
}

template <int PZT, int PXYT>
__global__ void __launch_bounds__(32 * KPB, MIN_BLOCKS)
blend3d_kernel(const float* __restrict__ padded, const float* __restrict__ xyz,
               float* __restrict__ out, int K, int Dp, int Hp, int Wp, int Pz_rt,
               int Pxy_rt) {
  __shared__ __align__(16) float ring[KPB][RING];
  const int Pz = PZT ? PZT : Pz_rt, Pxy = PXYT ? PXYT : Pxy_rt;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int k = blockIdx.x * KPB + w;
  if (k >= K) return;  // whole warps; nothing below waits on the block

  const size_t kp = (size_t)b * K + k;
  const float x = xyz[kp * 3 + 0], y = xyz[kp * 3 + 1], z = xyz[kp * 3 + 2];
  const float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  Frac f;
  f.fx = __fsub_rn(x, flx);
  f.fy = __fsub_rn(y, fly);
  f.fz = __fsub_rn(z, flz);
  f.gx = __fsub_rn(1.0f, f.fx);
  f.gy = __fsub_rn(1.0f, f.fy);
  f.gz = __fsub_rn(1.0f, f.fz);
  const int ox = (int)flx + 1, oy = (int)fly + 1, oz = (int)flz + 1;
  const float* vol = padded + (size_t)b * Dp * Hp * Wp;
  const int Pb = Pxy - 1;
  float* gout = out + kp * (size_t)((Pz - 1) * Pb * Pb);
  const bool inside = ox >= 0 && oy >= 0 && oz >= 0 && ox <= Wp - Pxy &&
                      oy <= Hp - Pxy && oz <= Dp - Pz;
  if (inside)
    march<PZT, PXYT, false>(vol, gout, ring[w], lane, Dp, Hp, Wp, Pz, Pxy, ox, oy, oz, f);
  else
    march<PZT, PXYT, true>(vol, gout, ring[w], lane, Dp, Hp, Wp, Pz, Pxy, ox, oy, oz, f);
}

template <int PZT, int PXYT>
int launch(const float* padded, const float* xyz, float* out, int B, int K, int Dp, int Hp,
           int Wp, int Pz, int Pxy, cudaStream_t st) {
  const dim3 grid((K + KPB - 1) / KPB, B);
  blend3d_kernel<PZT, PXYT><<<grid, 32 * KPB, 0, st>>>(padded, xyz, out, K, Dp, Hp, Wp, Pz,
                                                       Pxy);
  return (int)cudaGetLastError();
}

}  // namespace

// padded (B, Dp, Hp, Wp) f32, xyz (B, K, 3) f32 -> out (B, K, Pz-1, Pxy-1,
// Pxy-1) f32 (4-byte aligned) on `stream`, for 2 <= Pz, Pxy <= 64.
// Returns cudaGetLastError() after the launch.
extern "C" int kcmc_extract_blended_3d(const float* padded, const float* xyz,
                                       float* out, int B, int K, int Dp,
                                       int Hp, int Wp, int Pz, int Pxy,
                                       void* stream) {
  if (B < 1 || K < 1 || B > 65535 || Dp < 1 || Hp < 1 || Wp < 1)
    return (int)cudaErrorInvalidValue;
  if (Pz < 2 || Pxy < 2 || Pz > MAXP || Pxy > MAXP) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (Pz == 8 && Pxy == 20)
    return launch<8, 20>(padded, xyz, out, B, K, Dp, Hp, Wp, Pz, Pxy, st);
  return launch<0, 0>(padded, xyz, out, B, K, Dp, Hp, Wp, Pz, Pxy, st);
}
