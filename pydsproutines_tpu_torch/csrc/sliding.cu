// Hopper sliding normalised matched filter (dense short-template QF^2).
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/sliding.py:_kernel.
// Contract: for every template t < T and shift s < ns = n - l + 1,
//
//   c[t, s]   = sum_{j < l} x[s + j] * conj(tmpl[t, j]),
//   e[s]      = sum_{j < l} |x[s + j]|^2,
//   out[t, s] = |c[t, s]|^2 / (e[s] * tnorm[t])   (0 where that is 0),
//
// with tnorm[t] = ||tmpl_t||^2 from the wrapper. The window energy is an
// f32 sum over the staged window, as the TPU kernel's, so a window of zeros
// gives exactly 0.
//
// Design (simple first version). T is small (1-8 in use), so the TPU's
// (T, Lp) x (Lp, tile) MXU product and its im2col build have no counterpart.
// A block owns TILE = 1024 consecutive shifts: it stages x[s0, s0 + TILE +
// l - 1) and the templates in shared memory (16 KB + 32 KB at l = 1024,
// T = 4; at most 8*2048*8 = 128 KB of templates), and each of its 256
// threads accumulates the shifts tid + 256*q, q < 4, for every template in
// registers. At each tap the warp reads consecutive x words (no bank
// conflict) and one broadcast template word per template. More than 8
// templates run as several launches of at most 8.
//
// What bounds it on the H100: f32 arithmetic. 4*T*l FMAs per shift for the
// products plus 2*l for the energy (T = 4, l = 1024, n = 4M: 1.37e11 FLOP of
// products, ~2.05 ms at 67 TFLOP/s) against 8 bytes read and 4*T written per
// shift (~0.03 ms at 3.35 TB/s). Each tap costs 4 + T shared loads per
// thread for 4*(4*T + 2) FMAs, so the shared-load pipe is the next limit.

#include <cuda_runtime.h>

namespace {

constexpr int SNT = 256;              // threads per block
constexpr int SPT = 4;                // shifts per thread
constexpr int TILE = SNT * SPT;       // shifts per block
constexpr int MAX_TT = 8;             // templates per launch
constexpr size_t kMaxSmem = 227 * 1024;

template <int TT>
__global__ void __launch_bounds__(SNT)
sliding_kernel(const float2* __restrict__ x, long long n,
               const float2* __restrict__ tmpl, int l,
               const float* __restrict__ tnorm, float* __restrict__ out,
               long long ns) {
  extern __shared__ float2 sm[];
  float2* xs = sm;                          // TILE + l - 1 samples
  float2* ts = sm + TILE + l - 1;           // TT * l taps
  const int tid = threadIdx.x;
  const long long s0 = (long long)blockIdx.x * TILE;
  for (int i = tid; i < TILE + l - 1; i += SNT) {
    const long long gi = s0 + i;
    xs[i] = gi < n ? x[gi] : make_float2(0.f, 0.f);
  }
  for (int i = tid; i < TT * l; i += SNT) ts[i] = tmpl[i];
  __syncthreads();

  float2 acc[TT][SPT];
  float e[SPT];
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    e[q] = 0.f;
#pragma unroll
    for (int t = 0; t < TT; ++t) acc[t][q] = make_float2(0.f, 0.f);
  }
  for (int j = 0; j < l; ++j) {
    float2 xv[SPT];
#pragma unroll
    for (int q = 0; q < SPT; ++q) {
      xv[q] = xs[tid + q * SNT + j];
      e[q] = fmaf(xv[q].x, xv[q].x, fmaf(xv[q].y, xv[q].y, e[q]));
    }
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float2 tv = ts[t * l + j];
#pragma unroll
      for (int q = 0; q < SPT; ++q) {        // x * conj(tv)
        acc[t][q].x = fmaf(xv[q].x, tv.x, fmaf(xv[q].y, tv.y, acc[t][q].x));
        acc[t][q].y = fmaf(xv[q].y, tv.x, fmaf(-xv[q].x, tv.y, acc[t][q].y));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < SPT; ++q) {
    const long long s = s0 + tid + q * SNT;
    if (s >= ns) continue;
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const float mag = acc[t][q].x * acc[t][q].x + acc[t][q].y * acc[t][q].y;
      const float den = e[q] * tnorm[t];
      out[(size_t)t * ns + s] = den > 0.f ? mag / den : 0.f;
    }
  }
}

template <int TT>
int launch(const float2* x, long long n, const float2* tmpl, int l,
           const float* tnorm, float* out, long long ns, cudaStream_t st) {
  const size_t smem = sizeof(float2) * ((size_t)TILE + l - 1 + (size_t)TT * l);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      sliding_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (ns + TILE - 1) / TILE;
  sliding_kernel<TT><<<(unsigned)blocks, SNT, smem, st>>>(x, n, tmpl, l,
                                                         tnorm, out, ns);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n,) complex64; tmpl: (t, l) complex64 row-major, not conjugated;
// tnorm: (t,) float32 ||tmpl_t||^2; out: (t, n - l + 1) float32. Templates
// run in launches of at most 8. Returns a cudaError_t.
extern "C" int pdsp_sliding(const void* x, long long n, const void* tmpl,
                            int t, int l, const void* tnorm, void* out,
                            void* stream) {
  const long long ns = n - l + 1;
  if (t <= 0 || l <= 0 || ns <= 0 || (ns + TILE - 1) / TILE > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float2* xp = static_cast<const float2*>(x);
  for (int t0 = 0; t0 < t; t0 += MAX_TT) {
    const float2* tp = static_cast<const float2*>(tmpl) + (size_t)t0 * l;
    const float* np_ = static_cast<const float*>(tnorm) + t0;
    float* op = static_cast<float*>(out) + (size_t)t0 * ns;
    int rc;
    switch (t - t0 < MAX_TT ? t - t0 : MAX_TT) {
      case 1: rc = launch<1>(xp, n, tp, l, np_, op, ns, st); break;
      case 2: rc = launch<2>(xp, n, tp, l, np_, op, ns, st); break;
      case 3: rc = launch<3>(xp, n, tp, l, np_, op, ns, st); break;
      case 4: rc = launch<4>(xp, n, tp, l, np_, op, ns, st); break;
      case 5: rc = launch<5>(xp, n, tp, l, np_, op, ns, st); break;
      case 6: rc = launch<6>(xp, n, tp, l, np_, op, ns, st); break;
      case 7: rc = launch<7>(xp, n, tp, l, np_, op, ns, st); break;
      default: rc = launch<8>(xp, n, tp, l, np_, op, ns, st); break;
    }
    if (rc != 0) return rc;
  }
  return 0;
}
