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
// So it needs Hopper's warpgroup MMA.
//
// Design. A CTA takes 8 row blocks (128 rows) of one frame and 256 of the
// V columns; the column tile is the fastest grid index, so the two CTAs
// that share rows run together and read them through L2 once.
//   * Warps 0-7 are two consumer warpgroups; warp w owns row block w,
//     which is exactly the 16 rows a warp contributes to
//     wgmma.m64n256k16 (bf16 in, float32 accumulate, 128 accumulators a
//     thread). Warps 8-11 are the producer warpgroup (setmaxnreg gives
//     its registers to the consumers); one lane issues the TMA copies.
//   * B = sel, through a 3-D tensor map over (nb, L, V), so rows past L
//     are zero-filled (a 2-D (nb L, V) view would read the next bin there).
//     A stage is 64 k-rows x 256 columns, four 64-column boxes of 128-byte
//     rows in the 128-byte swizzle, read by wgmma as an MN-major B
//     (transpose bit set); four stages ring under full/empty mbarriers.
//   * A from registers. L = 961 is odd, so a row's stride is 1,922 bytes
//     and neither TMA nor a 16-byte copy can address single rows. Each
//     warp copies its rows' 64-wide k-slices three stages ahead with
//     aligned 16-byte cp.async (nine per row: the slice plus the row's
//     0-7 element misalignment) into private shared buffers, and builds
//     its fragments from there with 32-bit shared loads and a funnel
//     shift; k-columns past L are zeroed. flat must be 16-byte aligned:
//     a chunk aligned down from a row's start then stays inside flat,
//     and each chunk copies only its bytes before the slice's end
//     (cp.async's src-size; the rest is zero-filled). Two fragment sets let one
//     stage's MMAs run while the next stage's fragments are built
//     (wgmma.wait_group 1).
//   * Mixed bins: a CTA makes one pass over k per distinct bin among its
//     row blocks. A warp whose row block has another bin feeds zero A
//     fragments (adding exact zeros). Every warpgroup issues every MMA,
//     even with no row block of the pass's bin: a branch around wgmma
//     makes ptxas serialize the MMAs.
//   * Epilogue: once all MMAs are done the ring is free; each warp stages
//     its 16 x 256 bf16 rows there and 16 lanes copy one row each to
//     device memory with cp.async.bulk.
//   * Edges: the sentinel bin nb clamps to nb - 1; row blocks past Kp/16
//     neither load nor store; columns past V are zero-filled by TMA and
//     not stored.
// The dynamic shared memory (187,524 bytes) is above 48 KB, so the entry point
// sets cudaFuncAttributeMaxDynamicSharedMemorySize before each launch;
// the tensor map is encoded on the host (cuTensorMapEncodeTiled, looked
// up at run time, so nothing links against libcuda),
// and every refusal is returned as the error.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ALIGN = 16;     // rows per row block: one warp's share of M
constexpr int RB = 8;         // row blocks per CTA (two warpgroups)
constexpr int BN = 256;       // columns per CTA: the wgmma N
constexpr int BK = 64;        // k rows per stage
constexpr int KS = 16;        // k per wgmma
constexpr int STAGES = 4;     // ring of sel k-tiles
constexpr int BOX_N = 64;     // TMA box width: 128 bytes, the swizzle span
constexpr int BOX_BYTES = BK * BOX_N * 2;      // 8 KB
constexpr int STAGE_BYTES = BK * BN * 2;       // 32 KB
constexpr int AW = BK + 8;    // staged A row, elements (slice + misalignment)
constexpr int AW32 = AW / 2;
constexpr int A_BYTES = ALIGN * AW * 2;        // 2,304 per warp
constexpr int NCONS = 8;      // consumer warps (two warpgroups)
constexpr int NTHREADS = 32 * NCONS + 128;     // and the producer warpgroup
constexpr int CPR = BK / 8 + 1;               // 16-byte chunks per staged row
constexpr int CHUNKS = ALIGN * CPR;           // per warp and stage
constexpr int CPL = (CHUNKS + 31) / 32;       // per lane
constexpr int ASTAGES = 3;    // A slices in flight per warp
constexpr int EW = BN + 8;    // staged output row, elements (bank spread)
static_assert(NCONS * ALIGN * EW * 2 <= STAGES * STAGE_BYTES, "output staging fits the ring");
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + ASTAGES * NCONS * A_BYTES +
                           2 * STAGES * 8 + 2 * RB * 4 + 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// one TMA box (64 columns x 64 k-rows of bin c2) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of an MN-major, 128-byte-swizzled B:
// 64-column atoms LBO = 8 KB apart (the boxes), 8-row k groups SBO =
// 1 KB apart
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(BOX_BYTES >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 256, float32) += a (this warp's 16 x 16 bf16 fragment) * B
__device__ __forceinline__ void wgmma_256(float (&d)[128], const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __launch_bounds__(NTHREADS, 1)
select_kernel(const __grid_constant__ CUtensorMap tmap, const uint16_t* __restrict__ flat,
              const int* __restrict__ ibin, uint16_t* __restrict__ out, int Kp, int L,
              int V, int nb) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* sB = smem;
  uint16_t* sA = (uint16_t*)(smem + STAGES * STAGE_BYTES);
  uint64_t* full = (uint64_t*)(smem + STAGES * STAGE_BYTES + ASTAGES * NCONS * A_BYTES);
  uint64_t* empty = full + STAGES;
  int* bins = (int*)(empty + STAGES);  // RB row-block bins (-1: past Kp)
  int* pmask = bins + RB;              // per pass: row blocks of its bin
  int* npass_s = pmask + RB;

  const int n0 = blockIdx.x * BN;
  const int kb0 = blockIdx.y * RB;
  const int b = blockIdx.z;
  const int nblk = Kp / ALIGN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    int np = 0;
    for (int r = 0; r < RB; ++r) {
      const int kb = kb0 + r;
      bins[r] = kb < nblk ? min(max(ibin[(size_t)b * nblk + kb], 0), nb - 1) : -1;
    }
    for (int r = 0; r < RB; ++r) {
      if (bins[r] < 0) continue;
      bool seen = false;
      for (int q = 0; q < r; ++q) seen |= bins[q] == bins[r];
      if (seen) continue;
      int m = 0;
      for (int q = r; q < RB; ++q) m |= (bins[q] == bins[r]) << q;
      pmask[np++] = m;
    }
    *npass_s = np;
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int nst = (L + BK - 1) / BK;
  const int total = *npass_s * nst;

  if (warp >= NCONS) {  // producer warpgroup: one lane issues the copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == NCONS && lane == 0) {
      for (int i = 0, p = 0, st = 0; i < total; ++i) {
        const int slot = i % STAGES, round = i / STAGES;
        if (round > 0) mbar_wait(&empty[slot], (round - 1) & 1);
        mbar_expect_tx(&full[slot], STAGE_BYTES);
        const int pb = bins[__ffs(pmask[p]) - 1];
#pragma unroll
        for (int q = 0; q < BN / BOX_N; ++q)
          tma_load(sB + slot * STAGE_BYTES + q * BOX_BYTES, &tmap, &full[slot],
                   n0 + q * BOX_N, st * BK, pb);
        if (++st == nst) {
          st = 0;
          ++p;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // consumer warp `warp`: row block kb0 + warp, rows g and g + 8 of it
  const int g = lane >> 2, t = lane & 3;
  const uint16_t* ablk = flat + ((size_t)b * Kp + (size_t)(kb0 + warp) * ALIGN) * L;
  // rows g and g + 8 start at the same offset mod 16 bytes (8 L = 0 mod 8)
  const int sh = (int)(((uintptr_t)(ablk + (size_t)g * L) & 15) >> 1);
  auto abuf = [&](int i) { return sA + ((i % ASTAGES) * NCONS + warp) * ALIGN * AW; };
  // start the copy of stage j's slice, if this warp's row block takes part
  // in it: the aligned 16-byte chunks that cover its 16 rows x k-slice
  // [k0, min(k0 + 64, L)), into buffer j % ASTAGES (cp.async, no
  // registers). Every stage commits one group, empty or not, so that
  // wait_group counts stages.
  auto stage_a = [&](int j) {
    if (j < total) {
      const int pj = j / nst, k0 = (j - pj * nst) * BK;
      if ((pmask[pj] >> warp) & 1) {
        uint16_t* dst = abuf(j);
        const int kend = min(k0 + BK, L);
#pragma unroll
        for (int it = 0; it < CPL; ++it) {
          const int c = lane + 32 * it;
          if (c < CHUNKS) {
            const int row = c / CPR, jc = c - row * CPR;
            const uint16_t* rp = ablk + (size_t)row * L;
            const uint16_t* src =
                (const uint16_t*)((uintptr_t)(rp + k0) & ~(uintptr_t)15) + 8 * jc;
            // bytes of the chunk inside [.., rp + kend): the rest is
            // zero-filled, so no read passes the row's slice (nor the end
            // of flat on its last row)
            const int nbytes = min(16, 2 * (int)(rp + kend - src));
            if (nbytes > 0)
              asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                               smem_u32(dst + row * AW + 8 * jc)),
                           "l"(src), "r"(nbytes)
                           : "memory");
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
  // fragments of two stages: one in the MMAs in flight, one being built
  uint32_t af0[BK / KS][4], af1[BK / KS][4];

#pragma unroll
  for (int j = 0; j < ASTAGES; ++j) stage_a(j);
  int p = 0, st = 0;
  // stage i: build its fragments, start the copy of stage i + ASTAGES's
  // slice, issue its MMAs, then wait for stage i - 1's MMAs and release
  // that ring slot
  auto step = [&](int i, auto bufc) {
    uint32_t(&af)[BK / KS][4] = decltype(bufc)::value ? af1 : af0;
    uint32_t(&afp)[BK / KS][4] = decltype(bufc)::value ? af0 : af1;
    const int slot = i % STAGES, round = i / STAGES;
    const int k0 = st * BK;
    const int m = pmask[p];
    const bool mine = (m >> warp) & 1;
    const uint32_t* s32 = (const uint32_t*)abuf(i);
    // bf16 pair (row, k0 + kk, + 1) from the staged slice
    auto pair = [&](int row, int kk) -> uint32_t {
      const int q = sh + kk;
      const uint32_t lo = s32[row * AW32 + (q >> 1)];
      const uint32_t hi = s32[row * AW32 + (q >> 1) + 1];
      return __funnelshift_r(lo, hi, (q & 1) << 4);
    };
    if (mine) {  // stage i's copy is done; the ASTAGES - 1 later may run
      asm volatile("cp.async.wait_group %0;\n" ::"n"(ASTAGES - 1) : "memory");
      __syncwarp();
    }
#pragma unroll
    for (int ks = 0; ks < BK / KS; ++ks) {
      const int kk = ks * KS + 2 * t;
      if (mine) {
        af[ks][0] = pair(g, kk);
        af[ks][1] = pair(g + 8, kk);
        af[ks][2] = pair(g, kk + 8);
        af[ks][3] = pair(g + 8, kk + 8);
        if (k0 + BK > L) {  // zero the k-columns past L
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int k = k0 + kk + 8 * h;
            const uint32_t keep = k >= L ? 0u : (k + 1 >= L ? 0xFFFFu : 0xFFFFFFFFu);
            af[ks][h * 2] &= keep;
            af[ks][h * 2 + 1] &= keep;
          }
        }
      } else {
        af[ks][0] = af[ks][1] = af[ks][2] = af[ks][3] = 0u;
      }
    }
    __syncwarp();  // every lane has read the staged slice: reuse its buffer
    stage_a(i + ASTAGES);

    mbar_wait(&full[slot], round & 1);
    // Every warpgroup issues all four k-steps of every stage: past L the
    // ring holds zeros (TMA fill) and A is zero, and a warpgroup with no
    // row block of the pass's bin multiplies zero fragments. A branch
    // around the MMAs would make ptxas serialize them.
    const uint8_t* sbuf = sB + slot * STAGE_BYTES;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / KS; ++ks) wgmma_256(acc, af[ks], b_desc(sbuf + ks * KS * 128));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_acc(acc);
#pragma unroll
    for (int ks = 0; ks < BK / KS; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(afp[ks][q])::"memory");
    if (i > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    if (++st == nst) {
      st = 0;
      ++p;
    }
  };
  for (int i = 0; i < total; i += 2) {
    step(i, std::integral_constant<int, 0>());
    if (i + 1 < total) step(i + 1, std::integral_constant<int, 1>());
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);

  // Epilogue. Once every consumer warp's MMAs are done, the ring is free:
  // each warp stages its 16 x 256 bf16 rows there (rows 528 bytes apart,
  // so the 8 rows of one store hit distinct banks) and 16 lanes copy one
  // row each to device memory (cp.async.bulk), which the CTA only waits
  // to have read.
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * NCONS) : "memory");
  if (bins[warp] < 0) return;
  uint16_t* sEw = (uint16_t*)sB + warp * ALIGN * EW;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = j * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(sEw + g * EW + n) =
        __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<__nv_bfloat162*>(sEw + (g + 8) * EW + n) =
        __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane < ALIGN) {
    uint16_t* o = out + ((size_t)b * Kp + (size_t)(kb0 + warp) * ALIGN + lane) * V + n0;
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(o),
                 "r"(smem_u32(sEw + lane * EW)), "r"(min(BN, V - n0) * 2)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (PFN_cuTensorMapEncodeTiled_v12000)p;
  }
  return fn;
}

}  // namespace

// flat (B, Kp, L) bf16, ibin (B, Kp / 16) int32, sel (nb, L, V) bf16
// (flat and sel 16-byte aligned) -> out (B, Kp, V) bf16 on `stream`. Kp % 16 == 0 and
// V % 8 == 0. Returns the first error: the tensor map's encoding, the
// shared-memory attribute, or cudaGetLastError() after the launch.
extern "C" int kcmc_binned_select_rows(const void* flat, const int* ibin,
                                       const void* sel, void* out, int B,
                                       int Kp, int L, int V, int nb,
                                       void* stream) {
  if (B < 1 || B > 65535 || Kp < ALIGN || Kp % ALIGN || V < 8 || V % 8 || L < 1 || nb < 1 ||
      ((uintptr_t)sel & 15) || ((uintptr_t)flat & 15) || (Kp / ALIGN + RB - 1) / RB > 65535)
    return (int)cudaErrorInvalidValue;
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tmap;
  const cuuint64_t dims[3] = {(cuuint64_t)V, (cuuint64_t)L, (cuuint64_t)nb};
  const cuuint64_t strides[2] = {(cuuint64_t)V * 2, (cuuint64_t)L * V * 2};
  const cuuint32_t box[3] = {BOX_N, BK, 1};
  const cuuint32_t estride[3] = {1, 1, 1};
  if (encode(&tmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(sel), dims,
             strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((V + BN - 1) / BN, (Kp / ALIGN + RB - 1) / RB, B);
  select_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tmap, (const uint16_t*)flat, ibin, (uint16_t*)out, Kp, L, V, nb);
  return (int)cudaGetLastError();
}
