// shift_scored_match — the global-search scoring core of the gather engine.
//
// Replaces pyp_tpu/ops/pallas_kernels.py `shift_scored_match` (Pallas body
// `_kernel`). For every (particle x psi) row a and reference direction d:
//
//     score[a, d] = max_s Re( sum_g v[a, g] * E[g, s] * u[g, d] ) * ninv[a, d]
//     sidx[a, d]  = the first s that attains the max
//
// What bounds it on an H100: arithmetic. Re(w u) = wr*ur - wi*ui is two
// FP32 FMAs per (a, d, s, g), 4*A*D*S*G FLOP in all: at the slice's shapes
// (A = 256 particles x 72 psi = 18,432, G = 168, D = 732, S = 29) that is
// 2.6e11 FLOP per batch of 256 particles, against ~2e7 bytes of inputs.
//
// Design (simple and right first):
//   * one block of 16 x 16 threads per 64-row x 64-direction output tile;
//     each thread owns a 4 x 4 micro-tile (rows ty + 16 i, directions
//     tx + 16 j) and keeps its running best score and shift index in
//     registers across the whole shift loop, so nothing but the final
//     (score, index) tile is written;
//   * outer loop over shifts s; inner loop over G in chunks of KC, staging
//     w = v * E[:, s] (formed while loading) and the u chunk in shared
//     memory; FP32 FMAs;
//   * ragged edges are masked on load (zeros) and on store, so the wrapper
//     needs no padding copies;
//   * the shift loop uses strict `>` from -inf with index 0, as the Pallas
//     kernel and the XLA scan do, so the first best shift wins.
//   The simple design re-reads the u tile from L2 once per shift; keeping
//   u resident across shifts, TMA staging and wgmma are later work.
//
// Layouts (all float32, C-contiguous): vr, vi (A, G); ur, ui (G, D);
// er, ei (S, G) — E transposed so a shift's phasors are contiguous;
// ninv (A, D); outputs score (A, D) float32 and sidx (A, D) int32.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 64;      // rows and directions per block
constexpr int TPB = 16;       // threads per block edge (16 x 16 = 256)
constexpr int MICRO = 4;      // TILE / TPB
constexpr int KC = 16;        // G chunk staged per step

__global__ void __launch_bounds__(TPB * TPB)
shift_scored_match_kernel(const float* __restrict__ vr,
                          const float* __restrict__ vi,
                          const float* __restrict__ ur,
                          const float* __restrict__ ui,
                          const float* __restrict__ er,
                          const float* __restrict__ ei,
                          const float* __restrict__ ninv,
                          float* __restrict__ score,
                          int* __restrict__ sidx,
                          int A, int G, int D, int S) {
  // +1 column of padding: the transposed store of the w chunk
  // (ws[g][row], g varying fastest across a warp) stays bank-conflict free
  __shared__ float wsr[KC][TILE + 1];
  __shared__ float wsi[KC][TILE + 1];
  __shared__ float usr[KC][TILE];
  __shared__ float usi[KC][TILE];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TPB + tx;
  const int row0 = blockIdx.y * TILE;
  const int col0 = blockIdx.x * TILE;

  float nv[MICRO][MICRO];
  float best[MICRO][MICRO];
  int bidx[MICRO][MICRO];
#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int a = row0 + ty + TPB * i;
      const int d = col0 + tx + TPB * j;
      nv[i][j] = (a < A && d < D) ? ninv[(size_t)a * D + d] : 0.f;
      best[i][j] = -CUDART_INF_F;
      bidx[i][j] = 0;
    }
  }

  for (int s = 0; s < S; ++s) {
    float acc[MICRO][MICRO];
#pragma unroll
    for (int i = 0; i < MICRO; ++i)
#pragma unroll
      for (int j = 0; j < MICRO; ++j) acc[i][j] = 0.f;

    for (int g0 = 0; g0 < G; g0 += KC) {
      // w chunk: KC x TILE = 1024 values, 4 per thread; consecutive
      // threads read consecutive g of one row
#pragma unroll
      for (int k = 0; k < (KC * TILE) / (TPB * TPB); ++k) {
        const int e = tid + k * TPB * TPB;
        const int gl = e % KC;
        const int rl = e / KC;
        const int g = g0 + gl;
        const int a = row0 + rl;
        float wr = 0.f, wi = 0.f;
        if (g < G && a < A) {
          const float xr = vr[(size_t)a * G + g];
          const float xi = vi[(size_t)a * G + g];
          const float pr = er[(size_t)s * G + g];
          const float pi = ei[(size_t)s * G + g];
          wr = xr * pr - xi * pi;
          wi = xr * pi + xi * pr;
        }
        wsr[gl][rl] = wr;
        wsi[gl][rl] = wi;
      }
      // u chunk: KC x TILE, consecutive threads read consecutive d
#pragma unroll
      for (int k = 0; k < (KC * TILE) / (TPB * TPB); ++k) {
        const int e = tid + k * TPB * TPB;
        const int dl = e % TILE;
        const int gl = e / TILE;
        const int g = g0 + gl;
        const int d = col0 + dl;
        const bool ok = g < G && d < D;
        usr[gl][dl] = ok ? ur[(size_t)g * D + d] : 0.f;
        usi[gl][dl] = ok ? ui[(size_t)g * D + d] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        float a_r[MICRO], a_i[MICRO], b_r[MICRO], b_i[MICRO];
#pragma unroll
        for (int i = 0; i < MICRO; ++i) {
          a_r[i] = wsr[k][ty + TPB * i];
          a_i[i] = wsi[k][ty + TPB * i];
        }
#pragma unroll
        for (int j = 0; j < MICRO; ++j) {
          b_r[j] = usr[k][tx + TPB * j];
          b_i[j] = usi[k][tx + TPB * j];
        }
#pragma unroll
        for (int i = 0; i < MICRO; ++i)
#pragma unroll
          for (int j = 0; j < MICRO; ++j) {
            acc[i][j] = fmaf(a_r[i], b_r[j], acc[i][j]);
            acc[i][j] = fmaf(-a_i[i], b_i[j], acc[i][j]);
          }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < MICRO; ++i)
#pragma unroll
      for (int j = 0; j < MICRO; ++j) {
        const float sc = acc[i][j] * nv[i][j];
        if (sc > best[i][j]) {
          best[i][j] = sc;
          bidx[i][j] = s;
        }
      }
  }

#pragma unroll
  for (int i = 0; i < MICRO; ++i) {
#pragma unroll
    for (int j = 0; j < MICRO; ++j) {
      const int a = row0 + ty + TPB * i;
      const int d = col0 + tx + TPB * j;
      if (a < A && d < D) {
        score[(size_t)a * D + d] = best[i][j];
        sidx[(size_t)a * D + d] = bidx[i][j];
      }
    }
  }
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() as an int; it neither allocates nor synchronises.
extern "C" int shift_scored_match_launch(const float* vr, const float* vi,
                                         const float* ur, const float* ui,
                                         const float* er, const float* ei,
                                         const float* ninv, float* score,
                                         int* sidx, int A, int G, int D, int S,
                                         void* stream) {
  if (A <= 0 || D <= 0) return 0;
  const dim3 block(TPB, TPB);
  const dim3 grid((D + TILE - 1) / TILE, (A + TILE - 1) / TILE);
  shift_scored_match_kernel<<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      vr, vi, ur, ui, er, ei, ninv, score, sidx, A, G, D, S);
  return static_cast<int>(cudaGetLastError());
}
