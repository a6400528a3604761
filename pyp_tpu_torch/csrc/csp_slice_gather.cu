// csp_slice_gather: the CSP model gather (pyp_tpu_torch/ops/csp.py
// `_csp_model_gather`) as one kernel forward and one kernel backward.
//
// For every row r (a (series, tilt, particle) projection, or a candidate of
// the grid search) and mask point g, the central-slice coordinate
//
//     q_c = scale * (mask[g,1] * R[r,0,c] + mask[g,0] * R[r,1,c]),  c = x, y, z
//
// read in the gather's order (qz, qy, qx), and the trilinear, Friedel-aware
// value of the padded reference spectrum Fref (m, m, m/2+1) there, under the
// rules of ops/fourier_slice.gather_3d_hermitian: the Friedel flip for
// qx < 0, 8 corners summed in (dz, dy, dx) order with weights wz*wy*wx,
// floor-mod in z and y, zero weight for kx > nxf-1, conj of the sum when
// the point was flipped, zero outside r^2 <= (m/2)^2 (its conj for kx < 0
// never applies inside the sphere: `corners`). Every
// product and sum is rounded on its own (__fmul_rn, __fadd_rn), as PyTorch's
// unfused elementwise kernels round them, so no FMA is contracted, and r^2
// is summed in the order torch.sum takes on the card: the floor, Nyquist and
// validity decisions, and the values, fall as in the plain chain.
//
// It replaces no TPU kernel: the JAX package leaves this gather to XLA's
// fusion; the port ran it as ~300 elementwise launches a call, each a full
// pass over the (rows, G) points, and autograd replayed the chain.
//
// Bound: the forward's output, (rows, G) complex64 written once (131 MB at
// 41,984 x 390, ~40 us at 3.35 TB/s); Fref (8.6 MB at m = 128) stays in the
// 50 MB L2. What the card spends beyond that is the corner reads: 8 a point,
// each lane of a warp on other cache lines (neighbouring mask points lie
// `scale` voxels apart), so the L2's sectors, not HBM, bound it. A point's
// 2 x 2 (y, x) corners of one z plane are laid side by side first
// (`quad_fref`: Fq[z,y,x] = F at (y, x), (y, x+1), (y+1, x), (y+1, x+1),
// x clamped to nxf-1 and y+1 floor-mod m; 35 MB at m = 128, L2-resident,
// ~20 us), so a point reads its 8 corners as two 32-byte sectors through
// the read-only path, where 8 scattered loads took four to five (a gather
// of ~0.43 ms at 41,984 x 390 falls to ~0.27 ms on an H100). One warp a
// row, lanes on neighbouring mask points: the rotation is read once a row
// and the output is stored coalesced as float2.
//
// Backward: the gradient with respect to R (rows, 3, 3), its third row 0,
// through the trilinear weights (no scatter into Fref): per point
// dL/dfrac_i = Re(conj(g') * dv/dfrac_i), g' = g or conj(g) where flipped,
// times the flip's sign and the scale, then onto R's first two rows by the
// mask point. One warp a row sums its points and reduces by shuffles: no
// atomics, no (rows, G, 3) tensor, the same sums in every run. The corners
// are recomputed from Fq, not saved.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct SlicePoint {
  float frac[3];   // (z, y, x) fractions after the Friedel flip
  int k0[3];       // their floors
  int z[2], y0;    // k0 + 0 and k0 + 1 in z, k0 in y, floor-mod m
  bool flip;       // qx < 0: the Friedel mate was read
  bool inside;     // r^2 <= (m/2)^2
};

__device__ __forceinline__ int floor_mod(int a, int n) {
  if (static_cast<unsigned>(a) < static_cast<unsigned>(n)) return a;
  int r = a % n;
  return r < 0 ? r + n : r;
}

// r: the row's rotation, its first two rows (x, y, z) at r[0..2], r[3..5]
__device__ __forceinline__ SlicePoint slice_point(const float* r, float m0, float m1,
                                                  float scale, int m) {
  float q[3];  // (qz, qy, qx) = scaled (q_2, q_1, q_0)
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[2 - c] = __fmul_rn(__fadd_rn(__fmul_rn(m1, r[c]), __fmul_rn(m0, r[3 + c])), scale);
  SlicePoint p;
  p.flip = q[2] < 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = p.flip ? -q[i] : q[i];
    float f = floorf(s);
    p.frac[i] = __fsub_rn(s, f);
    p.k0[i] = static_cast<int>(f);
  }
  // torch.sum over a last axis of 3 on the card: two threads, the first
  // adding elements 0 and 2, then the second's element 1
  float r2 = __fadd_rn(__fadd_rn(__fmul_rn(q[0], q[0]), __fmul_rn(q[2], q[2])),
                       __fmul_rn(q[1], q[1]));
  int h = m / 2;
  p.inside = r2 <= static_cast<float>(h * h);
  p.z[0] = floor_mod(p.k0[0], m);
  p.z[1] = p.z[0] + 1 == m ? 0 : p.z[0] + 1;
  p.y0 = floor_mod(p.k0[1], m);
  return p;
}

// The 8 corners v[2 dz + dy][dx] of an inside point, gather_3d_hermitian's
// values; returns whether its x + 1 corners lie in the half-spectrum
// (kx <= nxf - 1; past it the chain weights the clamped value 0, which Fq
// holds there). An inside point has |q| <= m/2 and, after the flip, qx >= 0
// (or -0), so 0 <= x0 <= nxf - 1: the chain's conj for kx < 0 and its clamp
// of the x0 corner never apply.
__device__ __forceinline__ bool corners(const float4* __restrict__ Fq, const SlicePoint& p,
                                        int m, int nxf, float2 v[4][2]) {
#pragma unroll
  for (int dz = 0; dz < 2; ++dz) {
    const float4* q = Fq + 2 * ((static_cast<long long>(p.z[dz]) * m + p.y0) * nxf + p.k0[2]);
    float4 a = __ldg(q), b = __ldg(q + 1);
    v[2 * dz][0] = make_float2(a.x, a.y);
    v[2 * dz][1] = make_float2(a.z, a.w);
    v[2 * dz + 1][0] = make_float2(b.x, b.y);
    v[2 * dz + 1][1] = make_float2(b.z, b.w);
  }
  return p.k0[2] < nxf - 1;
}

__global__ void __launch_bounds__(kThreads)
quad_fref(const float2* __restrict__ F, float4* __restrict__ Fq, int m, int nxf) {
  long long n = static_cast<long long>(m) * m * nxf;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    int x = static_cast<int>(i % nxf);
    long long zy = i / nxf;
    int y = static_cast<int>(zy % m);
    long long j = (zy - y + (y + 1 == m ? 0 : y + 1)) * nxf + x;  // (z, y+1 mod m, x)
    int dx = x + 1 < nxf ? 1 : 0;
    float2 a = F[i], b = F[i + dx], c = F[j], d = F[j + dx];
    Fq[2 * i] = make_float4(a.x, a.y, b.x, b.y);
    Fq[2 * i + 1] = make_float4(c.x, c.y, d.x, d.y);
  }
}

__global__ void __launch_bounds__(kThreads)
slice_gather_forward(const float* __restrict__ R, const float2* __restrict__ mask,
                     const float4* __restrict__ Fq, float2* __restrict__ out, long long rows,
                     int G, int m, int nxf, float scale) {
  const int lane = threadIdx.x & 31;
  for (long long row = blockIdx.x * static_cast<long long>(kWarps) + (threadIdx.x >> 5);
       row < rows; row += static_cast<long long>(gridDim.x) * kWarps) {
    float r[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) r[k] = __ldg(R + row * 9 + k);
    float2* o = out + row * G;
    for (int g = lane; g < G; g += 32) {
      float2 mk = __ldg(mask + g);  // (ky, kx)
      SlicePoint p = slice_point(r, mk.x, mk.y, scale, m);
      float2 acc = make_float2(0.0f, 0.0f);
      if (p.inside) {
        float2 v[4][2];
        bool x1_in = corners(Fq, p, m, nxf, v);
#pragma unroll
        for (int zy = 0; zy < 4; ++zy) {
          int dz = zy >> 1, dy = zy & 1;
          float wz = dz ? p.frac[0] : __fsub_rn(1.0f, p.frac[0]);
          float wy = dy ? p.frac[1] : __fsub_rn(1.0f, p.frac[1]);
          float wzy = __fmul_rn(wz, wy);
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            float wx = dx ? p.frac[2] : __fsub_rn(1.0f, p.frac[2]);
            float w = (dx == 0 || x1_in) ? __fmul_rn(wzy, wx) : 0.0f;
            float tr = __fmul_rn(w, v[zy][dx].x), ti = __fmul_rn(w, v[zy][dx].y);
            if (zy == 0 && dx == 0) {
              acc = make_float2(tr, ti);
            } else {
              acc.x = __fadd_rn(acc.x, tr);
              acc.y = __fadd_rn(acc.y, ti);
            }
          }
        }
        if (p.flip) acc.y = -acc.y;
      }
      o[g] = acc;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
slice_gather_backward(const float* __restrict__ R, const float2* __restrict__ mask,
                      const float4* __restrict__ Fq, const float2* __restrict__ grad,
                      float* __restrict__ dR, long long rows, int G, int m, int nxf,
                      float scale) {
  const int lane = threadIdx.x & 31;
  const long long row = blockIdx.x * static_cast<long long>(kWarps) + (threadIdx.x >> 5);
  if (row >= rows) return;
  float r[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) r[k] = __ldg(R + row * 9 + k);
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // dR[0][x,y,z], dR[1][x,y,z]
  for (int g = lane; g < G; g += 32) {
    float2 mk = __ldg(mask + g);
    SlicePoint p = slice_point(r, mk.x, mk.y, scale, m);
    if (!p.inside) continue;
    float2 gg = __ldg(grad + row * G + g);
    if (p.flip) gg.y = -gg.y;
    float w0[3], w1[3];  // the weights of the dk = 0 and dk = 1 corners
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      w1[k] = p.frac[k];
      w0[k] = 1.0f - p.frac[k];
    }
    float dv[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};  // dv/dfrac_(z,y,x)
    float2 v[4][2];
    bool x1_in = corners(Fq, p, m, nxf, v);
#pragma unroll
    for (int zy = 0; zy < 4; ++zy) {
      int dz = zy >> 1, dy = zy & 1;
      float wz = dz ? w1[0] : w0[0], sz = dz ? 1.0f : -1.0f;
      float wy = dy ? w1[1] : w0[1], sy = dy ? 1.0f : -1.0f;
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        if (dx == 1 && !x1_in) continue;
        float wx = dx ? w1[2] : w0[2], sx = dx ? 1.0f : -1.0f;
        float az = sz * wy * wx, ay = wz * sy * wx, ax = wz * wy * sx;
        dv[0][0] += az * v[zy][dx].x;
        dv[0][1] += az * v[zy][dx].y;
        dv[1][0] += ay * v[zy][dx].x;
        dv[1][1] += ay * v[zy][dx].y;
        dv[2][0] += ax * v[zy][dx].x;
        dv[2][1] += ax * v[zy][dx].y;
      }
    }
    float sgn = p.flip ? -scale : scale;
#pragma unroll
    for (int c = 0; c < 3; ++c) {  // q_c is the gather's coordinate 2 - c
      float dq = sgn * (gg.x * dv[2 - c][0] + gg.y * dv[2 - c][1]);
      acc[c] += mk.y * dq;
      acc[3 + c] += mk.x * dq;
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
  }
  // lane k < 6 writes the sum lane 0 holds; the third row's lanes write 0
  float mine = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float a0 = __shfl_sync(0xffffffffu, acc[k], 0);
    if (lane == k) mine = a0;
  }
  if (lane < 9) dR[row * 9 + lane] = mine;
}

int blocks_for(long long work, int per_block) {
  long long b = (work + per_block - 1) / per_block;
  return static_cast<int>(b < 1 ? 1 : (b < (1LL << 30) ? b : (1LL << 30)));
}

}  // namespace

extern "C" {

// out (rows, G) complex64 from R (rows, 3, 3) f32 (its first two rows are
// read), mask (G, 2) f32 and F (m, m, nxf) complex64; Fq (m, m, nxf, 4)
// complex64 receives F's corner quads, which the backward reads. Returns
// cudaGetLastError() after the launches.
int csp_slice_gather_forward(const void* R, const void* mask, const void* F, void* Fq,
                             void* out, long long rows, int G, int m, int nxf, float scale,
                             void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  quad_fref<<<blocks_for(static_cast<long long>(m) * m * nxf, kThreads), kThreads, 0, s>>>(
      static_cast<const float2*>(F), static_cast<float4*>(Fq), m, nxf);
  if (rows > 0 && G > 0) {
    slice_gather_forward<<<blocks_for(rows, kWarps), kThreads, 0, s>>>(
        static_cast<const float*>(R), static_cast<const float2*>(mask),
        static_cast<const float4*>(Fq), static_cast<float2*>(out), rows, G, m, nxf, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// dR (rows, 3, 3) f32, its third row 0, from the output's gradient grad
// (rows, G) complex64 and the forward's Fq
int csp_slice_gather_backward(const void* R, const void* mask, const void* Fq,
                              const void* grad, void* dR, long long rows, int G, int m,
                              int nxf, float scale, void* stream) {
  if (rows > 0) {
    slice_gather_backward<<<blocks_for(rows, kWarps), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(R), static_cast<const float2*>(mask),
        static_cast<const float4*>(Fq), static_cast<const float2*>(grad),
        static_cast<float*>(dR), rows, G, m, nxf, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
