// Building blocks shared by the CAF peak kernels (fused_xcorr.cu,
// fused_caf3.cu, fft_peak.cu, through fft_smem.cuh): complex multiply-add,
// the (value, index) order of a peak, and the reduction of per-row winners
// to one (peak, true bin) per transform.
//
// Everything sits in an anonymous namespace, so each source that includes
// this header gets its own internal copy and the shared library links
// without duplicate symbols.
//
// Ties go to the lowest true bin everywhere, the rule of torch.argmax /
// numpy.argmax on the natural-order spectrum.

#pragma once

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int NT = 256;
constexpr int MAX_FACTORS = 8;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void cmac(float2& c, float2 a, float2 b) {
  c.x = fmaf(a.x, b.x, c.x);
  c.x = fmaf(-a.y, b.y, c.x);
  c.y = fmaf(a.x, b.y, c.y);
  c.y = fmaf(a.y, b.x, c.y);
}

// (v, k) beats (bv, bk): larger value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

// The factors f[0..nf-1] of a DFT plan, outermost first.
struct Digits {
  int nf;
  int f[MAX_FACTORS];
};

// grid (ntrans): out[t] = the best over the R = f[0]*...*f[nf-2] rows of
// transform t. Row r holds the digits (k_0, ..., k_{nf-2}) in row-major order
// and rowarg the last digit k_{nf-1}; the true bin is
// k_0 + f_0*(k_1 + f_1*(... + f_{nf-2}*k_{nf-1})).
__global__ void __launch_bounds__(NT)
peak_reduce(const float* __restrict__ rowmax, const int* __restrict__ rowarg,
            float* __restrict__ out_max, int* __restrict__ out_bin, int R,
            Digits d) {
  __shared__ float sv[NT];
  __shared__ int sk[NT];
  const long long t = blockIdx.x;
  const int tid = threadIdx.x;
  float bv = -1.f;
  int bk = INT_MAX;
  for (int r = tid; r < R; r += NT) {
    const float v = rowmax[t * R + r];
    int bin = rowarg[t * R + r], rem = r;
    for (int i = d.nf - 2; i >= 0; --i) {
      bin = rem % d.f[i] + d.f[i] * bin;
      rem /= d.f[i];
    }
    if (better(v, bin, bv, bk)) {
      bv = v;
      bk = bin;
    }
  }
  sv[tid] = bv;
  sk[tid] = bk;
  __syncthreads();
  for (int half = NT / 2; half > 0; half >>= 1) {
    if (tid < half &&
        better(sv[tid + half], sk[tid + half], sv[tid], sk[tid])) {
      sv[tid] = sv[tid + half];
      sk[tid] = sk[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out_max[t] = sv[0];
    out_bin[t] = sk[0];
  }
}

}  // namespace
