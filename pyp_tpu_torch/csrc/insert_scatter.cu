// insert_scatter: the trilinear, Friedel-aware scatter of the insertion
// (pyp_tpu_torch/ops/fourier_slice.py `_scatter`) as one kernel, from the
// samples' padded coordinates, values and CTF^2 weights to the (num, den)
// accumulators of one or two sets.
//
// For every sample i of row b (q (B, ..., 3) ordered (qz, qy, qx), vals
// complex, c2 real, the row's set s = set_id[b]):
//
//     flip where qx < 0: q -> -q, v -> conj(v)
//     inside: (qz^2 + qx^2) + qy^2 <= (pn/2)^2, of the unflipped q
//     per corner (dz, dy, dx) of floor(q): w = (wz * wy) * wx, wz = frac or
//         1 - frac; neg = kx < 0 takes (-kz, -ky, -kx) and conj(v); kz, ky
//         floor-mod pn; the corner counts where kx <= nxf - 1 and inside
//     num[s, kz, ky, kx] += w v,  den[s, kz, ky, kx] += w c2
//
// the rules of ops/kernels.insert_scatter_plain (the corner lists and
// index_add_ it replaces on the card). Every product and difference is
// rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn), as PyTorch's
// unfused elementwise kernels round them, so no FMA is contracted, and r^2
// is summed in the order torch.sum takes over a last axis of 3 on the
// card (elements 0 and 2, then 1): each term added equals the chain's bit
// for bit, and only the order of the sums differs, which index_add_'s
// atomics leave open too. A corner whose weight is zero (outside the
// sphere, past kx = nxf - 1, or w == 0) adds nothing: it changes no sum
// of finite terms. After the flip kx >= 0, so the neg rule never applies
// to the corners of a flipped point; it is kept as the chain has it.
//
// It replaces no TPU kernel: the JAX package leaves the insertion to XLA's
// scatter. The port built 8 corner lists (an int64 index and three
// float32 terms a corner: 709 M entries at 41,984 rows x 64 x 33) with
// elementwise launches, concatenated them and added them with three
// scalar index_add_ passes, tens of GB of traffic and most of the
// insertion's memory.
//
// Bound: 24 bytes a sample of input (q 12, vals 8, c2 4; 2.13 GB, 0.64 ms
// at 41,984 x 64 x 33 and 3.35 TB/s), read once and coalesced (one thread
// a sample, neighbouring threads on neighbouring kx of a row), plus one
// 16-byte vector atomic into L2 per counted corner: the accumulators are
// interleaved (n_sets, pn, pn, nxf, 4) float32 (Re, Im, den, unused; 34 MB
// at pn = 128, n_sets = 2, which the 50 MB L2 holds), so a corner is one
// atomicAdd(float4*) (sm_90) in place of three scalar atomics. A second
// pass splits the buffer into num (complex64) and den (float32).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int floor_mod(int a, int n) {
  if (static_cast<unsigned>(a) < static_cast<unsigned>(n)) return a;
  int r = a % n;
  return r < 0 ? r + n : r;
}

__global__ void __launch_bounds__(kThreads)
scatter(const float* __restrict__ q, const float2* __restrict__ vals,
        const float* __restrict__ c2, const long long* __restrict__ set_id,
        float4* __restrict__ acc, long long samples, long long per, int n_sets, int pn,
        int nxf) {
  const int h = pn / 2;
  const float r2max = static_cast<float>(h * h);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < samples; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float p[3] = {__ldg(q + 3 * i), __ldg(q + 3 * i + 1), __ldg(q + 3 * i + 2)};
    // torch.sum over a last axis of 3 on the card: two threads, the first
    // adding elements 0 and 2, then the second's element 1
    float r2 = __fadd_rn(__fadd_rn(__fmul_rn(p[0], p[0]), __fmul_rn(p[2], p[2])),
                         __fmul_rn(p[1], p[1]));
    if (!(r2 <= r2max)) continue;  // every corner's weight is gated to 0
    long long set = set_id != nullptr ? __ldg(set_id + i / per) : 0;
    if (set < 0 || set >= n_sets) continue;
    float2 v = __ldg(vals + i);
    float c = __ldg(c2 + i);
    if (p[2] < 0.0f) {
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = -p[k];
      v.y = -v.y;
    }
    float f[3], g[3];  // frac and 1 - frac
    int k0[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float fl = floorf(p[k]);
      f[k] = __fsub_rn(p[k], fl);
      g[k] = __fsub_rn(1.0f, f[k]);
      k0[k] = static_cast<int>(fl);
    }
    float4* base = acc + set * pn * static_cast<long long>(pn) * nxf;
#pragma unroll
    for (int dz = 0; dz < 2; ++dz) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        float wzy = __fmul_rn(dz ? f[0] : g[0], dy ? f[1] : g[1]);
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          float w = __fmul_rn(wzy, dx ? f[2] : g[2]);
          int kz = k0[0] + dz, ky = k0[1] + dy, kx = k0[2] + dx;
          bool neg = kx < 0;
          if (neg) {
            kz = -kz;
            ky = -ky;
            kx = -kx;
          }
          if (kx > nxf - 1 || w == 0.0f) continue;
          float im = neg ? -v.y : v.y;
          long long at = (static_cast<long long>(floor_mod(kz, pn)) * pn + floor_mod(ky, pn)) *
                             nxf + kx;
          atomicAdd(base + at,
                    make_float4(__fmul_rn(w, v.x), __fmul_rn(w, im), __fmul_rn(w, c), 0.0f));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
split(const float4* __restrict__ acc, float2* __restrict__ num, float* __restrict__ den,
      long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 a = acc[i];
    num[i] = make_float2(a.x, a.y);
    den[i] = a.z;
  }
}

int blocks_for(long long work) {
  long long b = (work + kThreads - 1) / kThreads;
  return static_cast<int>(b < 1 ? 1 : (b < (1LL << 30) ? b : (1LL << 30)));
}

}  // namespace

extern "C" {

// num (n_sets, pn, pn, nxf) complex64 and den (n_sets, pn, pn, nxf) f32
// from q (samples, 3) f32 (qz, qy, qx), vals (samples) complex64, c2
// (samples) f32 and set_id (samples / per) int64 (null: every row in set
// 0); acc (n_sets, pn, pn, nxf, 4) f32 is the work buffer, zeroed here. A
// row whose set lies outside [0, n_sets) adds nothing. Returns
// cudaGetLastError() after the launches.
int insert_scatter(const void* q, const void* vals, const void* c2, const void* set_id,
                   void* acc, void* num, void* den, long long samples, long long per,
                   int n_sets, int pn, int nxf, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  long long cells = static_cast<long long>(n_sets) * pn * pn * nxf;
  cudaMemsetAsync(acc, 0, cells * sizeof(float4), s);
  if (samples > 0 && per > 0) {
    scatter<<<blocks_for(samples), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float2*>(vals),
        static_cast<const float*>(c2), static_cast<const long long*>(set_id),
        static_cast<float4*>(acc), samples, per, n_sets, pn, nxf);
  }
  split<<<blocks_for(cells), kThreads, 0, s>>>(static_cast<const float4*>(acc),
                                               static_cast<float2*>(num),
                                               static_cast<float*>(den), cells);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
