// Building blocks shared by the CAF peak kernels (fused_xcorr.cu,
// fft_peak.cu, fused_caf3.cu): complex multiply-add, tile loaders, a tiled
// f32 complex matrix product, the per-row spectrum peak and the reduction
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

constexpr int TM = 64, TN = 64, TK = 16, NT = 256;
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

// Row-major (rows, cols) complex matrix, zero outside its bounds.
struct Dense {
  const float2* p;
  int rows, cols;
  __device__ __forceinline__ float2 operator()(int r, int c) const {
    return (r < rows && c < cols) ? p[(size_t)r * cols + c]
                                  : make_float2(0.f, 0.f);
  }
};

// Dense times a (rows, cols) twiddle table, multiplied in as it is loaded.
struct TwDense {
  const float2* p;
  const float2* tw;
  int rows, cols;
  __device__ __forceinline__ float2 operator()(int r, int c) const {
    if (r >= rows || c >= cols) return make_float2(0.f, 0.f);
    const size_t i = (size_t)r * cols + c;
    return cmul(p[i], tw[i]);
  }
};

// Batches of (rows, cols) matrices stored one after another; at(z) is the
// z-th, with or without a twiddle shared by all of them.
struct DenseBatch {
  const float2* p;
  int rows, cols;
  __device__ __forceinline__ Dense at(long long z) const {
    return Dense{p + (size_t)z * rows * cols, rows, cols};
  }
};

struct TwDenseBatch {
  const float2* p;
  const float2* tw;
  int rows, cols;
  __device__ __forceinline__ TwDense at(long long z) const {
    return TwDense{p + (size_t)z * rows * cols, tw, rows, cols};
  }
};

// The modulated window p[t1, t2] = rx[s + t1*n2 + t2] * cc[t1*n2 + t2],
// t1 < n1, t2 < n2: nothing outside rx[s, s + n1*n2) is read.
struct Window {
  const float2* rx;
  const float2* cc;
  long long s;
  int n1, n2;
  __device__ __forceinline__ float2 operator()(int t1, int t2) const {
    if (t1 >= n1 || t2 >= n2) return make_float2(0.f, 0.f);
    const long long t = (long long)t1 * n2 + t2;
    return cmul(rx[s + t], cc[t]);
  }
};

// acc[i][j] = C[m0 + ty + 16i, n0 + tx + 16j] of C = A(M x K) @ B(K x N),
// thread (ty, tx) = (tid / 16, tid % 16). A tiles are read with k fastest and
// B tiles with n fastest, so both loads are coalesced for row-major inputs;
// As is padded by one column so its transposed store is conflict-free.
template <class LA, class LB>
__device__ __forceinline__ void cgemm_tile(const LA& la, const LB& lb, int K,
                                           int m0, int n0,
                                           float2 (*As)[TM + 1],
                                           float2 (*Bs)[TN],
                                           float2 (&acc)[4][4]) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = make_float2(0.f, 0.f);

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int e = tid; e < TK * TM; e += NT) {
      const int kk = e % TK, mm = e / TK;
      As[kk][mm] = la(m0 + mm, k0 + kk);
    }
    for (int e = tid; e < TK * TN; e += NT) {
      const int kk = e / TN, nn = e % TN;
      Bs[kk][nn] = lb(k0 + kk, n0 + nn);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float2 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) cmac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }
}

// (v, k) beats (bv, bk): larger value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

// grid (nb, ceil(M/TM), ceil(N/TN)): C_z = W @ P_z with W (M x M) and P_z
// the modulated window at rx[s_z] viewed as (M, N), s_z = offs[z] for a
// shift list or s0 + z*step when offs is null; epi(z, m, c, value) stores
// each element. Batches sit on grid x (up to 2^31 - 1 of them).
template <class Epi>
__global__ void __launch_bounds__(NT)
window_stage1(const float2* __restrict__ rx, const float2* __restrict__ cc,
              const float2* __restrict__ w,
              const long long* __restrict__ offs, long long s0, int step,
              int M, int N, Epi epi) {
  __shared__ float2 As[TK][TM + 1];
  __shared__ float2 Bs[TK][TN];
  const long long z = blockIdx.x;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.z * TN;
  const long long s = offs ? offs[z] : s0 + z * step;
  float2 acc[4][4];
  cgemm_tile(Dense{w, M, M}, Window{rx, cc, s, M, N}, M, m0, n0, As, Bs, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (m < M && c < N) epi(z, m, c, acc[i][j]);
    }
  }
}

// Plain store of a (nb, M, N) stage output.
struct StoreEpi {
  float2* out;
  int M, N;
  __device__ __forceinline__ void operator()(long long z, int m, int c,
                                             float2 v) const {
    out[((size_t)z * M + m) * N + c] = v;
  }
};

// grid (nb, ceil(K1/TM)): for each row k1 of A_z = la.at(z) (K1 x J), the
// max over k2 < K2 of |(A_z @ W2)[k1, k2]|^2 and its k2. One block owns 64
// rows and walks every k2 tile, keeping the per-row (max, argmax) in
// registers: the spectrum is never stored.
template <class LA>
__global__ void __launch_bounds__(NT)
peak_rows(LA la, const float2* __restrict__ w2, float* __restrict__ rowmax,
          int* __restrict__ rowarg, int K1, int J, int K2) {
  __shared__ float2 As[TK][TM + 1];
  __shared__ float2 Bs[TK][TN];
  const long long z = blockIdx.x;
  const int m0 = blockIdx.y * TM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const auto a = la.at(z);
  float best[4];
  int barg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -1.f;
    barg[i] = INT_MAX;
  }
  for (int n0 = 0; n0 < K2; n0 += TN) {
    float2 acc[4][4];
    cgemm_tile(a, Dense{w2, J, K2}, J, m0, n0, As, Bs, acc);
    // columns visited in increasing k2, so a strict > keeps the lowest k2
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= K2) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = acc[i][j].x * acc[i][j].x + acc[i][j].y * acc[i][j].y;
        if (v > best[i]) {
          best[i] = v;
          barg[i] = c;
        }
      }
    }
  }
  // the 16 threads of one ty hold the same rows: reduce across tx
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa = __shfl_xor_sync(0xffffffffu, barg[i], off);
      if (better(ov, oa, best[i], barg[i])) {
        best[i] = ov;
        barg[i] = oa;
      }
    }
    const int m = m0 + ty + 16 * i;
    if (tx == 0 && m < K1) {
      rowmax[(size_t)z * K1 + m] = best[i];
      rowarg[(size_t)z * K1 + m] = barg[i];
    }
  }
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
