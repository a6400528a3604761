// csp_score: the CTF-weighted normalized cross-correlation of CSP
// (pyp_tpu_torch/ops/csp.py `_csp_ncc`) as one kernel forward and one
// kernel backward.
//
// For every row r (a (series, tilt, particle) projection, or a candidate of
// the grid search) and mask point g = (ky, kx):
//
//     ph  = -2 pi / n (ky dy + kx dx)                      (dy, dx) = dshift[r]
//     c   = -sin(chi + amp),  chi = pi lam |k|^2 / (n p)^2 df
//                                   - pi/2 Cs lam^3 |k|^4 / (n p)^4
//     num = sum_g c Re(conj(x) u e^{i ph})                  x = xv[r], u = u[r]
//     ncc = num / sqrt(sum_g |x|^2 * sum_g c^2 |u|^2 + 1e-12)
//
// the chain of ops/refine3d._ctf_at_points (df1 = df2, so the azimuth drops
// out) and `_csp_ncc`. The backward gives, from dL/dncc per row, dL/d dshift
// (rows, 2) and dL/d df (rows), each summed over g in the kernel, and where
// asked dL/du (rows, G) complex64 in PyTorch's convention for a real loss
// (dL/dRe u + i dL/dIm u), which the gather's backward kernel reads as it
// is. A row of each input is read at its own row count's modulo: an input
// without the grid search's leading candidate axis serves every candidate
// without a copy.
//
// It replaces no TPU kernel: the JAX package leaves `_csp_ncc` to XLA's
// fusion. The port ran it as a chain of elementwise launches, each a full
// pass over the (rows, G) points, and autograd replayed the chain.
//
// Bound: bytes. A forward reads xv and u once (complex64: 262 MB at 41,984
// x 390, ~78 us at 3.35 TB/s) and writes 16 bytes a row; a backward reads
// them again and, where u's gradient is asked for, writes it (131 MB more).
// The arithmetic (two accurate sine and cosine evaluations a point) costs
// about as long as the reads, so nothing is loaded twice and nothing extra
// is computed a point: one warp a row, each lane loading two points'
// xv and u as one 16-byte load each where G is even and the rows aligned
// (8-byte loads otherwise); the per-point constants (the phase's ky, kx
// factors and chi's two terms) computed into shared memory 1,024 points at
// a time, once a block where G fits in one such tile; each row's three sums reduced by warp shuffles in
// float32, so no atomics and the same sums in every run (a graph replay
// equals the eager steps bit for bit). sincosf and sinf are the accurate
// ones (chi reaches tens of radians); the library is built without
// --use_fast_math.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // mask points whose constants a block holds at once

struct Consts {
  float ph;      // -2 pi / n
  float chi_df;  // pi lam / (n p)^2: chi's defocus term per |k|^2 and Å
  float chi_cs;  // pi/2 Cs lam^3 / (n p)^4: chi's Cs term per |k|^4
  float amp;     // atan2(w, sqrt(1 - w^2))
};

// a point's constants: the phase's factors of dy and dx, chi's factor of df
// and its Cs term
__device__ __forceinline__ float4 point_consts(float2 k, const Consts& c) {
  float k2 = k.x * k.x + k.y * k.y;
  return make_float4(k.x * c.ph, k.y * c.ph, c.chi_df * k2, c.chi_cs * k2 * k2);
}

// fills pts[0, n) with the constants of mask points g0 .. g0 + n - 1
__device__ __forceinline__ void fill(float4* pts, const float2* __restrict__ mask, int g0,
                                     int n, const Consts& c) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) pts[i] = point_consts(__ldg(mask + g0 + i), c);
}

struct Row {
  float dy, dx, df;
  const float2* x;
  const float2* u;
};

__device__ __forceinline__ Row row_inputs(long long row, const float* __restrict__ dshift,
                                          long long rows_s, const float* __restrict__ df,
                                          long long rows_d, const float2* __restrict__ xv,
                                          long long rows_x, const float2* __restrict__ u,
                                          long long rows_u, int G) {
  Row r;
  long long s = row % rows_s;
  r.dy = __ldg(dshift + 2 * s);
  r.dx = __ldg(dshift + 2 * s + 1);
  r.df = __ldg(df + row % rows_d);
  r.x = xv + (row % rows_x) * G;
  r.u = u + (row % rows_u) * G;
  return r;
}

// the three sums of one point into (num, xx, cu)
__device__ __forceinline__ void forward_point(const float4& p, float2 x, float2 u, const Row& r,
                                              float amp, float& num, float& xx, float& cu) {
  float sp, cp;
  sincosf(fmaf(p.x, r.dy, p.y * r.dx), &sp, &cp);
  float c = -sinf(fmaf(p.z, r.df, -p.w) + amp);
  float re = x.x * u.x + x.y * u.y;  // Re(conj(x) u)
  float im = x.x * u.y - x.y * u.x;  // Im(conj(x) u)
  num += c * (re * cp - im * sp);
  xx += x.x * x.x + x.y * x.y;
  cu += c * c * (u.x * u.x + u.y * u.y);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kPair: each lane reads two neighbouring points of a row as one float4
// (G even, rows 16-byte aligned)
template <bool kPair>
__global__ void __launch_bounds__(kThreads)
score_forward(const float* __restrict__ dshift, long long rows_s, const float* __restrict__ df,
              long long rows_d, const float2* __restrict__ xv, long long rows_x,
              const float2* __restrict__ u, long long rows_u, const float2* __restrict__ mask,
              int G, long long rows, Consts k, float* __restrict__ ncc,
              float* __restrict__ sums) {
  __shared__ float4 pts[kTile];
  const int lane = threadIdx.x & 31;
  const int tiles = (G + kTile - 1) / kTile;
  if (tiles == 1) {
    fill(pts, mask, 0, G, k);
    __syncthreads();
  }
  for (long long base = blockIdx.x * static_cast<long long>(kWarps); base < rows;
       base += static_cast<long long>(gridDim.x) * kWarps) {
    const long long row = base + (threadIdx.x >> 5);
    const bool live = row < rows;
    Row r{};
    if (live) r = row_inputs(row, dshift, rows_s, df, rows_d, xv, rows_x, u, rows_u, G);
    float num = 0.0f, xx = 0.0f, cu = 0.0f;
    for (int t = 0; t < tiles; ++t) {
      const int g0 = t * kTile, n = min(kTile, G - g0);
      if (tiles > 1) {
        __syncthreads();
        fill(pts, mask, g0, n, k);
        __syncthreads();
      }
      if (!live) continue;
      if (kPair) {
        const float4* x4 = reinterpret_cast<const float4*>(r.x + g0);
        const float4* u4 = reinterpret_cast<const float4*>(r.u + g0);
        for (int j = lane; j < n / 2; j += 32) {
          float4 a = __ldg(x4 + j), b = __ldg(u4 + j);
          forward_point(pts[2 * j], make_float2(a.x, a.y), make_float2(b.x, b.y), r, k.amp, num,
                        xx, cu);
          forward_point(pts[2 * j + 1], make_float2(a.z, a.w), make_float2(b.z, b.w), r, k.amp,
                        num, xx, cu);
        }
      } else {
        for (int j = lane; j < n; j += 32)
          forward_point(pts[j], __ldg(r.x + g0 + j), __ldg(r.u + g0 + j), r, k.amp, num, xx, cu);
      }
    }
    num = warp_sum(num);
    xx = warp_sum(xx);
    cu = warp_sum(cu);
    if (live && lane == 0) {
      ncc[row] = num / sqrtf(xx * cu + 1e-12f);
      sums[3 * row] = num;
      sums[3 * row + 1] = xx;
      sums[3 * row + 2] = cu;
    }
  }
}

// one point's share of dL/d(dy, dx) (before the factor gA) and dL/d df, and
// where du is written its dL/du
__device__ __forceinline__ float2 backward_point(const float4& p, float2 x, float2 u, const Row& r,
                                                 float amp, float gA, float gU, float& sy,
                                                 float& sx, float& sd) {
  float sp, cp, sc, cc;
  sincosf(fmaf(p.x, r.dy, p.y * r.dx), &sp, &cp);
  sincosf(fmaf(p.z, r.df, -p.w) + amp, &sc, &cc);
  float c = -sc;
  float re = x.x * u.x + x.y * u.y;
  float im = x.x * u.y - x.y * u.x;
  float dnum_dc = re * cp - im * sp;       // d num / d c
  float dnum_dph = -c * (re * sp + im * cp);  // d num / d ph
  sy += dnum_dph * p.x;
  sx += dnum_dph * p.y;
  float gu2 = 2.0f * gU * c;  // d/dc of gU c^2 |u|^2 over |u|^2, and du's factor of u over c
  sd += (gA * dnum_dc + gu2 * (u.x * u.x + u.y * u.y)) * (-cc) * p.z;
  // du = gA c x e^{-i ph} + 2 gU c^2 u
  float ga = gA * c, gb = gu2 * c;
  return make_float2(ga * (x.x * cp + x.y * sp) + gb * u.x, ga * (x.y * cp - x.x * sp) + gb * u.y);
}

template <bool kPair>
__global__ void __launch_bounds__(kThreads)
score_backward(const float* __restrict__ dshift, long long rows_s, const float* __restrict__ df,
               long long rows_d, const float2* __restrict__ xv, long long rows_x,
               const float2* __restrict__ u, long long rows_u, const float2* __restrict__ mask,
               int G, long long rows, Consts k, const float* __restrict__ sums,
               const float* __restrict__ grad, float* __restrict__ d_shift,
               float* __restrict__ d_df, float2* __restrict__ du) {
  __shared__ float4 pts[kTile];
  const int lane = threadIdx.x & 31;
  const int tiles = (G + kTile - 1) / kTile;
  if (tiles == 1) {
    fill(pts, mask, 0, G, k);
    __syncthreads();
  }
  for (long long base = blockIdx.x * static_cast<long long>(kWarps); base < rows;
       base += static_cast<long long>(gridDim.x) * kWarps) {
    const long long row = base + (threadIdx.x >> 5);
    const bool live = row < rows;
    Row r{};
    float gA = 0.0f, gU = 0.0f;
    if (live) {
      r = row_inputs(row, dshift, rows_s, df, rows_d, xv, rows_x, u, rows_u, G);
      // ncc = num / D, D = sqrt(xx cu + 1e-12): gA = dL/dnum, gU = dL/dcu
      float num = __ldg(sums + 3 * row), xx = __ldg(sums + 3 * row + 1);
      float cu = __ldg(sums + 3 * row + 2), g = __ldg(grad + row);
      float q = xx * cu + 1e-12f, D = sqrtf(q);
      gA = g / D;
      gU = -0.5f * g * (num / D) * (xx / q);
    }
    float sy = 0.0f, sx = 0.0f, sd = 0.0f;
    float2* drow = du ? du + row * G : nullptr;
    for (int t = 0; t < tiles; ++t) {
      const int g0 = t * kTile, n = min(kTile, G - g0);
      if (tiles > 1) {
        __syncthreads();
        fill(pts, mask, g0, n, k);
        __syncthreads();
      }
      if (!live) continue;
      if (kPair) {
        const float4* x4 = reinterpret_cast<const float4*>(r.x + g0);
        const float4* u4 = reinterpret_cast<const float4*>(r.u + g0);
        for (int j = lane; j < n / 2; j += 32) {
          float4 a = __ldg(x4 + j), b = __ldg(u4 + j);
          float2 d0 = backward_point(pts[2 * j], make_float2(a.x, a.y), make_float2(b.x, b.y), r,
                                     k.amp, gA, gU, sy, sx, sd);
          float2 d1 = backward_point(pts[2 * j + 1], make_float2(a.z, a.w), make_float2(b.z, b.w),
                                     r, k.amp, gA, gU, sy, sx, sd);
          if (drow) reinterpret_cast<float4*>(drow + g0)[j] = make_float4(d0.x, d0.y, d1.x, d1.y);
        }
      } else {
        for (int j = lane; j < n; j += 32) {
          float2 d = backward_point(pts[j], __ldg(r.x + g0 + j), __ldg(r.u + g0 + j), r, k.amp,
                                    gA, gU, sy, sx, sd);
          if (drow) drow[g0 + j] = d;
        }
      }
    }
    sy = warp_sum(sy);
    sx = warp_sum(sx);
    sd = warp_sum(sd);
    if (live && lane == 0) {
      d_shift[2 * row] = gA * sy;
      d_shift[2 * row + 1] = gA * sx;
      d_df[row] = sd;
    }
  }
}

// blocks enough for every row, at most as many as the card holds at once
// (a block fills its point constants once where G fits in one tile)
template <typename Kernel>
int blocks_for(Kernel kernel, long long rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  long long resident = static_cast<long long>(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  long long need = (rows + kWarps - 1) / kWarps;
  return static_cast<int>(need < resident ? need : resident);
}

bool pairs(int G, const void* a, const void* b, const void* c) {
  auto aligned = [](const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; };
  return G % 2 == 0 && aligned(a) && aligned(b) && (c == nullptr || aligned(c));
}

}  // namespace

extern "C" {

// ncc (rows) f32 and sums (rows, 3) f32 (the row's num, sum |x|^2 and
// sum c^2 |u|^2, which the backward reads) from dshift (rows_s, 2) f32, df
// (rows_d) f32, xv (rows_x, G) and u (rows_u, G) complex64 and mask (G, 2)
// f32 (ky, kx); row r reads row r mod rows_* of each. k: -2 pi / n, chi's
// defocus and Cs factors, and the amplitude contrast's phase. Returns
// cudaGetLastError() after the launch.
int csp_score_forward(const void* dshift, long long rows_s, const void* df, long long rows_d,
                      const void* xv, long long rows_x, const void* u, long long rows_u,
                      const void* mask, int G, long long rows, float ph, float chi_df,
                      float chi_cs, float amp, void* ncc, void* sums, void* stream) {
  if (rows > 0) {
    Consts k{ph, chi_df, chi_cs, amp};
    auto s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto kernel) {
      kernel<<<blocks_for(kernel, rows), kThreads, 0, s>>>(
          static_cast<const float*>(dshift), rows_s, static_cast<const float*>(df), rows_d,
          static_cast<const float2*>(xv), rows_x, static_cast<const float2*>(u), rows_u,
          static_cast<const float2*>(mask), G, rows, k, static_cast<float*>(ncc),
          static_cast<float*>(sums));
    };
    if (pairs(G, xv, u, nullptr))
      args(score_forward<true>);
    else
      args(score_forward<false>);
  }
  return static_cast<int>(cudaGetLastError());
}

// d_shift (rows, 2) f32 and d_df (rows) f32, and where du is not null du
// (rows, G) complex64, from grad (rows) f32 (dL/dncc) and the forward's
// inputs and sums
int csp_score_backward(const void* dshift, long long rows_s, const void* df, long long rows_d,
                       const void* xv, long long rows_x, const void* u, long long rows_u,
                       const void* mask, int G, long long rows, float ph, float chi_df,
                       float chi_cs, float amp, const void* sums, const void* grad,
                       void* d_shift, void* d_df, void* du, void* stream) {
  if (rows > 0) {
    Consts k{ph, chi_df, chi_cs, amp};
    auto s = static_cast<cudaStream_t>(stream);
    auto args = [&](auto kernel) {
      kernel<<<blocks_for(kernel, rows), kThreads, 0, s>>>(
          static_cast<const float*>(dshift), rows_s, static_cast<const float*>(df), rows_d,
          static_cast<const float2*>(xv), rows_x, static_cast<const float2*>(u), rows_u,
          static_cast<const float2*>(mask), G, rows, k, static_cast<const float*>(sums),
          static_cast<const float*>(grad), static_cast<float*>(d_shift),
          static_cast<float*>(d_df), static_cast<float2*>(du));
    };
    if (pairs(G, xv, u, du))
      args(score_backward<true>);
    else
      args(score_backward<false>);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
