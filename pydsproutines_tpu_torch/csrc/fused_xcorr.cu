// Hopper frequency-scanning CAF peak search.
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/fused_xcorr.py:
// _caf_kernel. Contract: for each shift s = s0 + i*step, i in [0, nb),
//
//   X_s = DFT_n(rx[s : s+n] * cc),   cc = conj(cutout),   n = n1*n2,
//   out_max[i] = max_k |X_s[k]|^2,   out_bin[i] = argmax_k |X_s[k]|^2.
//
// Ties go to the lowest bin k, the rule of torch.argmax / numpy.argmax on the
// natural-order spectrum, so the kernel and its plain twin agree even there.
//
// The DFT is the two-stage (four-step) split, computed here, with t = t1*n2
// + t2 and k = k1 + n1*k2:
//
//   F[k1, t2] = sum_t1 W1[k1, t1] * p[t1, t2]        (stage 1, n1-point)
//   G[k1, t2] = F[k1, t2] * TW[k1, t2]               (twiddle W_n^(k1 t2))
//   X[k1 + n1*k2] = sum_t2 G[k1, t2] * W2[t2, k2]    (stage 2, n2-point)
//
// W1, W2 and TW are f32 tables built on the host from float64 phases
// (ops/fft.py). Three launches per chunk of shifts:
//
//   caf_stage1: gather + modulate p = rx[s + t] * cc[t] on the fly, stage-1
//               DFT as a tiled complex matrix product, twiddle, store G to
//               an f32 scratch (nb, n1, n2) in device memory;
//   caf_stage2: stage-2 DFT as a tiled complex product; each block owns 64
//               k1 rows and walks every k2 tile, keeping per-row
//               (max |X|^2, argmax k2) in registers — the spectrum is never
//               stored;
//   caf_reduce: per shift, the best (value, bin) over the n1 rows.
//
// What bounds it on the H100: arithmetic. The two stages cost n*(n1 + n2)
// complex MACs per shift (2e9 at n = 1M, i.e. 16 GFLOP), all in f32 on the
// CUDA cores (67 TFLOP/s peak), against 8 MB of window read and a 16 MB
// scratch round trip per shift. The tiled products keep each thread at a
// 4x4 complex micro-tile (8 shared loads per 64 FMAs). The TPU kernel kept
// the stage-1 result on chip and ran bf16 matrix passes; fusing the stages
// and moving them onto tensor cores is later work.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int TM = 64, TN = 64, TK = 16, NT = 256;

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

// The modulated window p[t1, t2] = rx[s + t1*n2 + t2] * cc[t1*n2 + t2].
struct Window {
  const float2* rx;
  const float2* cc;
  long long s;
  int n1, n2;
  __device__ __forceinline__ float2 operator()(int t1, int t2) const {
    if (t1 >= n1 || t2 >= n2) return make_float2(0.f, 0.f);
    const int t = t1 * n2 + t2;
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

// grid (ceil(n2/TN), ceil(n1/TM), nb): G[z] = (W1 @ P_z) * TW
__global__ void __launch_bounds__(NT)
caf_stage1(const float2* __restrict__ rx, const float2* __restrict__ cc,
           const float2* __restrict__ w1, const float2* __restrict__ tw,
           float2* __restrict__ g, long long s0, int step, int n1, int n2) {
  __shared__ float2 As[TK][TM + 1];
  __shared__ float2 Bs[TK][TN];
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM, z = blockIdx.z;
  float2 acc[4][4];
  cgemm_tile(Dense{w1, n1, n1},
             Window{rx, cc, s0 + (long long)z * step, n1, n2}, n1, m0, n0,
             As, Bs, acc);
  float2* gz = g + (size_t)z * n1 * n2;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (m < n1 && c < n2) {
        const size_t idx = (size_t)m * n2 + c;
        gz[idx] = cmul(acc[i][j], tw[idx]);
      }
    }
  }
}

// (v, k) beats (bv, bk): larger value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int k, float bv, int bk) {
  return v > bv || (v == bv && k < bk);
}

// grid (ceil(n1/TM), nb): per k1 row, (max_k2 |X|^2, argmax k2)
__global__ void __launch_bounds__(NT)
caf_stage2(const float2* __restrict__ g, const float2* __restrict__ w2,
           float* __restrict__ rowmax, int* __restrict__ rowarg, int n1,
           int n2) {
  __shared__ float2 As[TK][TM + 1];
  __shared__ float2 Bs[TK][TN];
  const int m0 = blockIdx.x * TM, z = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const Dense gz{g + (size_t)z * n1 * n2, n1, n2};
  float best[4];
  int barg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best[i] = -1.f;
    barg[i] = INT_MAX;
  }
  for (int n0 = 0; n0 < n2; n0 += TN) {
    float2 acc[4][4];
    cgemm_tile(gz, Dense{w2, n2, n2}, n2, m0, n0, As, Bs, acc);
    // columns visited in increasing k2, so a strict > keeps the lowest k2
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= n2) continue;
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
    if (tx == 0 && m < n1) {
      rowmax[(size_t)z * n1 + m] = best[i];
      rowarg[(size_t)z * n1 + m] = barg[i];
    }
  }
}

// grid (nb): out[z] = best over k1 of (rowmax, bin = k1 + n1*rowarg)
__global__ void __launch_bounds__(NT)
caf_reduce(const float* __restrict__ rowmax, const int* __restrict__ rowarg,
           float* __restrict__ out_max, int* __restrict__ out_bin, int n1) {
  __shared__ float sv[NT];
  __shared__ int sk[NT];
  const int z = blockIdx.x, tid = threadIdx.x;
  float bv = -1.f;
  int bk = INT_MAX;
  for (int k1 = tid; k1 < n1; k1 += NT) {
    const float v = rowmax[(size_t)z * n1 + k1];
    const int k = k1 + n1 * rowarg[(size_t)z * n1 + k1];
    if (better(v, k, bv, bk)) {
      bv = v;
      bk = k;
    }
  }
  sv[tid] = bv;
  sk[tid] = bk;
  __syncthreads();
  for (int half = NT / 2; half > 0; half >>= 1) {
    if (tid < half && better(sv[tid + half], sk[tid + half], sv[tid], sk[tid])) {
      sv[tid] = sv[tid + half];
      sk[tid] = sk[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out_max[z] = sv[0];
    out_bin[z] = sk[0];
  }
}

}  // namespace

// One chunk of nb shifts s0 + i*step. rx: complex64, covering every window;
// cc: (n1*n2,) complex64 conj(cutout); w1: (n1, n1), tw: (n1, n2), w2:
// (n2, n2) complex64 tables; scratch: (nb, n1, n2) complex64; rowmax /
// rowarg: (nb, n1) float32 / int32; out_max / out_bin: (nb,) float32 /
// int32. Returns a cudaError_t.
extern "C" int pdsp_caf_peak(const void* rx, const void* cc, const void* w1,
                             const void* tw, const void* w2, void* scratch,
                             void* rowmax, void* rowarg, void* out_max,
                             void* out_bin, int s0, int step, int nb, int n1,
                             int n2, void* stream) {
  if (nb <= 0 || nb > 65535 || n1 <= 0 || n2 <= 0 || step <= 0 || s0 < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g1((n2 + TN - 1) / TN, (n1 + TM - 1) / TM, nb);
  caf_stage1<<<g1, NT, 0, st>>>(
      static_cast<const float2*>(rx), static_cast<const float2*>(cc),
      static_cast<const float2*>(w1), static_cast<const float2*>(tw),
      static_cast<float2*>(scratch), s0, step, n1, n2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((n1 + TM - 1) / TM, nb);
  caf_stage2<<<g2, NT, 0, st>>>(
      static_cast<const float2*>(scratch), static_cast<const float2*>(w2),
      static_cast<float*>(rowmax), static_cast<int*>(rowarg), n1, n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  caf_reduce<<<nb, NT, 0, st>>>(
      static_cast<const float*>(rowmax), static_cast<const int*>(rowarg),
      static_cast<float*>(out_max), static_cast<int*>(out_bin), n1);
  return (int)cudaGetLastError();
}
