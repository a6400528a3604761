// shift_scored_match — the global-search scoring core of the gather engine.
//
// Replaces pyp_tpu/ops/pallas_kernels.py `shift_scored_match` (Pallas body
// `_kernel`). For every (particle x psi) row a and reference direction d:
//
//     score[a, d] = max_s Re( sum_g v[a, g] * E[g, s] * u[g, d] ) * ninv[a, d]
//     sidx[a, d]  = the first s that attains the max
//
// What bounds it on an H100: arithmetic. As one real GEMM it is
// num[a, (s, d)] = sum_k A[a, k] * B[k, (s, d)] with K = 2G,
// A = [Re v | Im v] and B = [Re(E_s u); -Im(E_s u)]: 2*A*S*D*K FLOP, at the
// slice's shapes (A = 256 particles x 72 psi = 18,432, G = 168, D = 732,
// S = 29) 2.6e11 FLOP against ~8e7 bytes of inputs and 1.1e8 of outputs.
//
// Design: a tensor-core GEMM whose epilogue is the shift max.
//   * 3xTF32 for FP32 accuracy: every operand x is split (by the wrapper)
//     into hi = tf32(x) and lo = x - hi (read as TF32 by the tensor
//     cores), and each product is a_hi b_hi + a_hi b_lo + a_lo b_hi,
//     accumulated in FP32 by wgmma
//     (m64nNk8, TF32 operands from shared memory). Single-pass TF32 keeps
//     10 mantissa bits and misses the oracle's tolerance.
//   * A tile is 128 rows (two consumer warpgroups of 64) by 8 directions x
//     SC shifts; its N columns are ordered c = 8 s + d_local. In the wgmma
//     accumulator layout a lane holds columns 2(lane%4), 2(lane%4)+1 mod 8,
//     so every shift of one (row, direction) lies in one thread's
//     registers: the max and the first argmax over s are register-local,
//     and nothing of size (A, S*D) reaches memory. S > 32 runs as chunks of
//     SC <= 32 shifts with a running best.
//   * Operands arrive in "tile images" laid out by the wrapper: each stage's
//     A and B tiles are single contiguous blocks in the canonical
//     no-swizzle K-major core-matrix layout (8 rows x 16 bytes each), so one
//     TMA bulk copy (cp.async.bulk) per operand fills a stage, ragged edges
//     are zeros in the image, and wgmma reads the tile as it landed.
//   * A ring of NSTAGE shared-memory stages with full/empty mbarriers: one
//     producer thread keeps the copies in flight, the consumer warpgroups
//     issue wgmma and release a stage one k-block later (wait_group 1).
//   * Persistent grid, one block per SM, walking (row tile, direction tile)
//     units in groups of GROUP_M row tiles, so that the A rows of a group
//     and the B columns in flight stay in the 50 MB L2.
//
// Outputs: score (A, D) float32 and sidx (A, D) int32, C-contiguous.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int KC = 16;           // K (floats) per stage: 4 core matrices
constexpr int BM = 128;          // rows per tile
constexpr int DT = 8;            // directions per tile
constexpr int SCMAX = 32;        // shifts per chunk: N = 8 SC <= 256
constexpr int NSTAGE = 4;
constexpr int GROUP_M = 16;      // row tiles walked together
constexpr int THREADS = 384;     // producer warpgroup + two consumers
constexpr int A_TILE_BYTES = BM * KC * 4;
constexpr uint32_t CORE_BYTES = 128;            // 8 rows x 16 bytes
constexpr uint32_t LBO = CORE_BYTES;            // next core matrix along K
constexpr uint32_t SBO = (KC / 4) * CORE_BYTES; // next 8-row group

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// TMA bulk copy of `bytes` contiguous bytes into shared memory; completion
// counts against `bar`'s transaction bytes
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma matrix descriptor: no swizzle, K-major core matrices
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(LBO >> 4) << 16) |
         (static_cast<uint64_t>(SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across the asynchronous
// wgmma region
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 8 SC per warpgroup, 4 SC floats a thread) += A(desc) * B(desc)^T,
// or = when scale_d is 0: wgmma.m64n{8 SC}k8.f32.tf32.tf32
template <int SC>
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db,
                                           uint32_t scale_d);

#define WG_D(i) \
  "+f"(d[4 * (i)]), "+f"(d[4 * (i) + 1]), "+f"(d[4 * (i) + 2]), "+f"(d[4 * (i) + 3])
#define WG_MMA(SC, N, SLIST, OPS, IA, IB, IS)                                \
  template <>                                                                \
  __device__ __forceinline__ void wgmma_tf32<SC>(float* d, uint64_t da,      \
                                                 uint64_t db,                \
                                                 uint32_t scale_d) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " IS ", 0;\n"             \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" \
                 SLIST "}, " IA ", " IB ", p, 1, 1;\n}\n"                    \
                 : OPS                                                       \
                 : "l"(da), "l"(db), "r"(scale_d));                          \
  }

// accumulator operand strings and lists for 1..32 shifts per chunk
#define WG_S1 "%0, %1, %2, %3"
#define WG_S2 WG_S1 ", %4, %5, %6, %7"
#define WG_S3 WG_S2 ", %8, %9, %10, %11"
#define WG_S4 WG_S3 ", %12, %13, %14, %15"
#define WG_S5 WG_S4 ", %16, %17, %18, %19"
#define WG_S6 WG_S5 ", %20, %21, %22, %23"
#define WG_S7 WG_S6 ", %24, %25, %26, %27"
#define WG_S8 WG_S7 ", %28, %29, %30, %31"
#define WG_S9 WG_S8 ", %32, %33, %34, %35"
#define WG_S10 WG_S9 ", %36, %37, %38, %39"
#define WG_S11 WG_S10 ", %40, %41, %42, %43"
#define WG_S12 WG_S11 ", %44, %45, %46, %47"
#define WG_S13 WG_S12 ", %48, %49, %50, %51"
#define WG_S14 WG_S13 ", %52, %53, %54, %55"
#define WG_S15 WG_S14 ", %56, %57, %58, %59"
#define WG_S16 WG_S15 ", %60, %61, %62, %63"
#define WG_S17 WG_S16 ", %64, %65, %66, %67"
#define WG_S18 WG_S17 ", %68, %69, %70, %71"
#define WG_S19 WG_S18 ", %72, %73, %74, %75"
#define WG_S20 WG_S19 ", %76, %77, %78, %79"
#define WG_S21 WG_S20 ", %80, %81, %82, %83"
#define WG_S22 WG_S21 ", %84, %85, %86, %87"
#define WG_S23 WG_S22 ", %88, %89, %90, %91"
#define WG_S24 WG_S23 ", %92, %93, %94, %95"
#define WG_S25 WG_S24 ", %96, %97, %98, %99"
#define WG_S26 WG_S25 ", %100, %101, %102, %103"
#define WG_S27 WG_S26 ", %104, %105, %106, %107"
#define WG_S28 WG_S27 ", %108, %109, %110, %111"
#define WG_S29 WG_S28 ", %112, %113, %114, %115"
#define WG_S30 WG_S29 ", %116, %117, %118, %119"
#define WG_S31 WG_S30 ", %120, %121, %122, %123"
#define WG_S32 WG_S31 ", %124, %125, %126, %127"
#define WG_OPS1 WG_D(0)
#define WG_OPS2 WG_OPS1, WG_D(1)
#define WG_OPS3 WG_OPS2, WG_D(2)
#define WG_OPS4 WG_OPS3, WG_D(3)
#define WG_OPS5 WG_OPS4, WG_D(4)
#define WG_OPS6 WG_OPS5, WG_D(5)
#define WG_OPS7 WG_OPS6, WG_D(6)
#define WG_OPS8 WG_OPS7, WG_D(7)
#define WG_OPS9 WG_OPS8, WG_D(8)
#define WG_OPS10 WG_OPS9, WG_D(9)
#define WG_OPS11 WG_OPS10, WG_D(10)
#define WG_OPS12 WG_OPS11, WG_D(11)
#define WG_OPS13 WG_OPS12, WG_D(12)
#define WG_OPS14 WG_OPS13, WG_D(13)
#define WG_OPS15 WG_OPS14, WG_D(14)
#define WG_OPS16 WG_OPS15, WG_D(15)
#define WG_OPS17 WG_OPS16, WG_D(16)
#define WG_OPS18 WG_OPS17, WG_D(17)
#define WG_OPS19 WG_OPS18, WG_D(18)
#define WG_OPS20 WG_OPS19, WG_D(19)
#define WG_OPS21 WG_OPS20, WG_D(20)
#define WG_OPS22 WG_OPS21, WG_D(21)
#define WG_OPS23 WG_OPS22, WG_D(22)
#define WG_OPS24 WG_OPS23, WG_D(23)
#define WG_OPS25 WG_OPS24, WG_D(24)
#define WG_OPS26 WG_OPS25, WG_D(25)
#define WG_OPS27 WG_OPS26, WG_D(26)
#define WG_OPS28 WG_OPS27, WG_D(27)
#define WG_OPS29 WG_OPS28, WG_D(28)
#define WG_OPS30 WG_OPS29, WG_D(29)
#define WG_OPS31 WG_OPS30, WG_D(30)
#define WG_OPS32 WG_OPS31, WG_D(31)
WG_MMA(1, 8, WG_S1, WG_OPS1, "%4", "%5", "%6")
WG_MMA(2, 16, WG_S2, WG_OPS2, "%8", "%9", "%10")
WG_MMA(3, 24, WG_S3, WG_OPS3, "%12", "%13", "%14")
WG_MMA(4, 32, WG_S4, WG_OPS4, "%16", "%17", "%18")
WG_MMA(5, 40, WG_S5, WG_OPS5, "%20", "%21", "%22")
WG_MMA(6, 48, WG_S6, WG_OPS6, "%24", "%25", "%26")
WG_MMA(7, 56, WG_S7, WG_OPS7, "%28", "%29", "%30")
WG_MMA(8, 64, WG_S8, WG_OPS8, "%32", "%33", "%34")
WG_MMA(9, 72, WG_S9, WG_OPS9, "%36", "%37", "%38")
WG_MMA(10, 80, WG_S10, WG_OPS10, "%40", "%41", "%42")
WG_MMA(11, 88, WG_S11, WG_OPS11, "%44", "%45", "%46")
WG_MMA(12, 96, WG_S12, WG_OPS12, "%48", "%49", "%50")
WG_MMA(13, 104, WG_S13, WG_OPS13, "%52", "%53", "%54")
WG_MMA(14, 112, WG_S14, WG_OPS14, "%56", "%57", "%58")
WG_MMA(15, 120, WG_S15, WG_OPS15, "%60", "%61", "%62")
WG_MMA(16, 128, WG_S16, WG_OPS16, "%64", "%65", "%66")
WG_MMA(17, 136, WG_S17, WG_OPS17, "%68", "%69", "%70")
WG_MMA(18, 144, WG_S18, WG_OPS18, "%72", "%73", "%74")
WG_MMA(19, 152, WG_S19, WG_OPS19, "%76", "%77", "%78")
WG_MMA(20, 160, WG_S20, WG_OPS20, "%80", "%81", "%82")
WG_MMA(21, 168, WG_S21, WG_OPS21, "%84", "%85", "%86")
WG_MMA(22, 176, WG_S22, WG_OPS22, "%88", "%89", "%90")
WG_MMA(23, 184, WG_S23, WG_OPS23, "%92", "%93", "%94")
WG_MMA(24, 192, WG_S24, WG_OPS24, "%96", "%97", "%98")
WG_MMA(25, 200, WG_S25, WG_OPS25, "%100", "%101", "%102")
WG_MMA(26, 208, WG_S26, WG_OPS26, "%104", "%105", "%106")
WG_MMA(27, 216, WG_S27, WG_OPS27, "%108", "%109", "%110")
WG_MMA(28, 224, WG_S28, WG_OPS28, "%112", "%113", "%114")
WG_MMA(29, 232, WG_S29, WG_OPS29, "%116", "%117", "%118")
WG_MMA(30, 240, WG_S30, WG_OPS30, "%120", "%121", "%122")
WG_MMA(31, 248, WG_S31, WG_OPS31, "%124", "%125", "%126")
WG_MMA(32, 256, WG_S32, WG_OPS32, "%128", "%129", "%130")

#undef WG_MMA
#undef WG_D

// unit u -> (row tile m, direction tile t): groups of GROUP_M row tiles,
// direction tiles outer within a group
__device__ __forceinline__ void unit_coords(int u, int n_m, int n_t, int& m,
                                            int& t) {
  const int g = u / (GROUP_M * n_t);
  const int gm = min(GROUP_M, n_m - g * GROUP_M);
  const int w = u - g * GROUP_M * n_t;
  t = w / gm;
  m = g * GROUP_M + w % gm;
}

// Tile images (float32): a_hi/a_lo (n_m, n_kb, BM/8, KC/4, 8, 4);
// b_hi/b_lo (n_t, n_chunk, n_kb, SC, KC/4, 8, 4), rows of a B tile ordered
// (shift, direction). Each stage holds A hi, A lo, B hi, B lo.
template <int SC>
__global__ void __launch_bounds__(THREADS, 1)
    shift_scored_match_kernel(const float* __restrict__ a_hi,
                              const float* __restrict__ a_lo,
                              const float* __restrict__ b_hi,
                              const float* __restrict__ b_lo,
                              const float* __restrict__ ninv,
                              float* __restrict__ score,
                              int* __restrict__ sidx, int A, int D, int S,
                              int n_kb, int n_chunk) {
  constexpr int B_TILE_BYTES = DT * SC * KC * 4;
  constexpr int STAGE_BYTES = 2 * A_TILE_BYTES + 2 * B_TILE_BYTES;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + NSTAGE * STAGE_BYTES);
  uint64_t* empty = full + NSTAGE;

  const int n_m = (A + BM - 1) / BM;
  const int n_t = (D + DT - 1) / DT;
  const int n_units = n_m * n_t;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread issues every copy
    if (threadIdx.x != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      int m, t;
      unit_coords(u, n_m, n_t, m, t);
      for (int ch = 0; ch < n_chunk; ++ch) {
        for (int kb = 0; kb < n_kb; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          unsigned char* st = smem + stage * STAGE_BYTES;
          const size_t ao = (static_cast<size_t>(m) * n_kb + kb) * (BM * KC);
          const size_t bo =
              ((static_cast<size_t>(t) * n_chunk + ch) * n_kb + kb) *
              (DT * SC * KC);
          bulk_load(st, a_hi + ao, A_TILE_BYTES, &full[stage]);
          bulk_load(st + A_TILE_BYTES, a_lo + ao, A_TILE_BYTES, &full[stage]);
          bulk_load(st + 2 * A_TILE_BYTES, b_hi + bo, B_TILE_BYTES,
                    &full[stage]);
          bulk_load(st + 2 * A_TILE_BYTES + B_TILE_BYTES, b_lo + bo,
                    B_TILE_BYTES, &full[stage]);
          if (++stage == NSTAGE) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wg = threadIdx.x / 128 - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[4 * SC];
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    int m, t;
    unit_coords(u, n_m, n_t, m, t);
    // this thread's outputs: rows r[i], directions d[c]
    int r[2], dd[2];
    float nv[2][2], best[2][2];
    int bidx[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r[i] = m * BM + 64 * wg + 16 * warp + 8 * i + lane / 4;
      dd[i] = t * DT + 2 * (lane % 4) + i;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        nv[i][c] = (r[i] < A && dd[c] < D)
                       ? ninv[static_cast<size_t>(r[i]) * D + dd[c]]
                       : 0.f;
        best[i][c] = -CUDART_INF_F;
        bidx[i][c] = 0;
      }

    for (int ch = 0; ch < n_chunk; ++ch) {
      int prev = -1;
      for (int kb = 0; kb < n_kb; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t st = smem_addr(smem + stage * STAGE_BYTES);
        const uint32_t sa_hi = st + wg * (64 / 8) * SBO;
        const uint32_t sa_lo = sa_hi + A_TILE_BYTES;
        const uint32_t sb_hi = st + 2 * A_TILE_BYTES;
        const uint32_t sb_lo = sb_hi + B_TILE_BYTES;
        fence_regs<4 * SC>(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 8; ++kk) {
          const uint32_t k_off = kk * 2 * CORE_BYTES;  // k8 = 2 core matrices
          wgmma_tf32<SC>(acc, desc(sa_hi + k_off), desc(sb_hi + k_off),
                         (kb | kk) ? 1u : 0u);
          wgmma_tf32<SC>(acc, desc(sa_hi + k_off), desc(sb_lo + k_off), 1u);
          wgmma_tf32<SC>(acc, desc(sa_lo + k_off), desc(sb_hi + k_off), 1u);
        }
        wgmma_commit();
        fence_regs<4 * SC>(acc);
        // the previous k-block's products are done: release its stage
        wgmma_wait<1>();
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = stage;
        if (++stage == NSTAGE) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs<4 * SC>(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
      // the shift max: accumulator 4 s + 2 i + c is (row r[i], shift s,
      // direction dd[c]); strict > in ascending s keeps the first best
#pragma unroll
      for (int s = 0; s < SC; ++s) {
        const int sg = ch * SC + s;
        if (sg < S) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float v = acc[4 * s + 2 * i + c] * nv[i][c];
              if (v > best[i][c]) {
                best[i][c] = v;
                bidx[i][c] = sg;
              }
            }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (r[i] < A && dd[c] < D) {
          const size_t o = static_cast<size_t>(r[i]) * D + dd[c];
          score[o] = best[i][c];
          sidx[o] = bidx[i][c];
        }
  }
}

template <int SC>
int launch(const float* a_hi, const float* a_lo, const float* b_hi,
           const float* b_lo, const float* ninv, float* score, int* sidx,
           int A, int D, int S, int n_kb, int n_chunk, cudaStream_t stream) {
  constexpr int smem =
      NSTAGE * (2 * A_TILE_BYTES + 2 * DT * SC * KC * 4) + 2 * NSTAGE * 8;
  auto kern = shift_scored_match_kernel<SC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev, sms;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_units = ((A + BM - 1) / BM) * ((D + DT - 1) / DT);
  kern<<<n_units < sms ? n_units : sms, THREADS, smem, stream>>>(
      a_hi, a_lo, b_hi, b_lo, ninv, score, sidx, A, D, S, n_kb, n_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The tile-image layout the wrapper must write: {BM, DT, KC, SCMAX}
// (ops/kernels.py checks its own constants against these before it
// launches).
extern "C" void shift_scored_match_layout(int* out) {
  out[0] = BM;
  out[1] = DT;
  out[2] = KC;
  out[3] = SCMAX;
}

// Launches on `stream` (PyTorch's current stream) and returns a CUDA error
// code (0 on success); it neither allocates nor synchronises. The operands
// are the wrapper's tile images with SC = sc shifts per chunk (1..32),
// n_chunk chunks and n_kb k-blocks of 16.
extern "C" int shift_scored_match_launch(const float* a_hi, const float* a_lo,
                                         const float* b_hi, const float* b_lo,
                                         const float* ninv, float* score,
                                         int* sidx, int A, int D, int S,
                                         int n_kb, int n_chunk, int sc,
                                         void* stream) {
  if (A <= 0 || D <= 0) return 0;
  if (sc < 1 || sc > SCMAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (sc) {
#define SSM_CASE(k)                                                          \
  case k:                                                                    \
    return launch<k>(a_hi, a_lo, b_hi, b_lo, ninv, score, sidx, A, D, S,     \
                     n_kb, n_chunk, st);
    SSM_CASE(1) SSM_CASE(2) SSM_CASE(3) SSM_CASE(4) SSM_CASE(5) SSM_CASE(6)
    SSM_CASE(7) SSM_CASE(8) SSM_CASE(9) SSM_CASE(10) SSM_CASE(11)
    SSM_CASE(12) SSM_CASE(13) SSM_CASE(14) SSM_CASE(15) SSM_CASE(16)
    SSM_CASE(17) SSM_CASE(18) SSM_CASE(19) SSM_CASE(20) SSM_CASE(21)
    SSM_CASE(22) SSM_CASE(23) SSM_CASE(24) SSM_CASE(25) SSM_CASE(26)
    SSM_CASE(27) SSM_CASE(28) SSM_CASE(29) SSM_CASE(30) SSM_CASE(31)
    SSM_CASE(32)
#undef SSM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
