// Hopper three-stage CAF peak search for big composite windows (n = 10M).
//
// Replaces the TPU kernels pydsproutines_tpu/ops/pallas/fused_caf3.py:
// _stage1_kernel and _stage23_kernel. Contract: for each shift s = offs[i],
// i in [0, nb),
//
//   X_s = DFT_n(rx[s : s+n] * cc),   cc = conj(cutout),   n = f0*f1*f2,
//   out_max[i] = max_k |X_s[k]|^2,   out_bin[i] = its k (lowest on ties).
//
// With t = n0*f1*f2 + n1*f2 + n2 and k = k0 + f0*k1 + f0*f1*k2:
//
//   S1[k0, n1, n2] = A1[k0,n1] A2[k0,n2] sum_n0 W0[k0,n0] p[n0, n1, n2]
//   S2[k0, k1, n2] = sum_n1 W1[k1,n1] S1[k0, n1, n2]
//   X[k]           = sum_n2 W2[n2,k2] TW2[k1,n2] S2[k0, k1, n2]
//
// A1 = exp(-2 pi i k0 n1/(f0 f1)), A2 = exp(-2 pi i k0 n2/n) and TW2 =
// exp(-2 pi i k1 n2/(f1 f2)) are f32 tables built on the host from float64
// phases reduced mod their period (ops/fft.caf3_tables). Four launches per
// chunk of shifts:
//
//   window_stage1<Caf3Epi>: gather + modulate rx[s + t] * cc[t] on the fly
//       (explicit bounds: only rx[s, s+n) is read), f0-point DFT as a tiled
//       complex product, both stage-1 twiddles, store S1 (nb, f0, f1*f2);
//   left_gemm: the f1-point DFT of every (k0, shift) block into S2;
//   peak_rows<TwDenseBatch>: the TPU kernel #4 contract (fft_peak.cu):
//       TW2 applied at load, f2-point DFT, per-row (max, argmax k2) kept in
//       registers over the nb*f0*f1 rows;
//   peak_reduce: per shift, the best row of f0*f1 and its true bin.
//
// What bounds it on the H100: f32 arithmetic, n*(f0 + f1 + f2) complex MACs
// per shift (6.5e9 at 10M = 200*200*250, 8.7e9 with the tiles padded to
// multiples of 64: ~2 ms per shift at 35 TFLOP/s), against two 80 MB
// scratch round trips per shift at 10M (~0.1 ms of HBM time). The scratch
// is complex64 (f32 throughout): the TPU kernels' bf16 scratch and
// Karatsuba passes are not carried over.

#include "cgemm.cuh"

namespace {

// Stage-1 epilogue: both stage-1 twiddles, then store S1.
struct Caf3Epi {
  float2* out;
  const float2* a1;
  const float2* a2;
  int f0, f1, f2;
  __device__ __forceinline__ void operator()(long long z, int k0, int c,
                                             float2 v) const {
    const int n1 = c / f2, n2 = c - n1 * f2;
    v = cmul(v, a1[(size_t)k0 * f1 + n1]);
    v = cmul(v, a2[(size_t)k0 * f2 + n2]);
    out[((size_t)z * f0 + k0) * ((size_t)f1 * f2) + c] = v;
  }
};

// grid (nb, ceil(M/TM), ceil(N/TN)): out_z = W (M x M) @ in_z (M x N)
__global__ void __launch_bounds__(NT)
left_gemm(const float2* __restrict__ w, const float2* __restrict__ in,
          float2* __restrict__ out, int M, int N) {
  __shared__ float2 As[TK][TM + 1];
  __shared__ float2 Bs[TK][TN];
  const size_t off = (size_t)blockIdx.x * M * N;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.z * TN;
  float2 acc[4][4];
  cgemm_tile(Dense{w, M, M}, Dense{in + off, M, N}, M, m0, n0, As, Bs, acc);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (m < M && c < N) out[off + (size_t)m * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// One chunk of nb shifts at int64 offsets offs (device, (nb,)). rx:
// complex64, each rx[offs[i], offs[i] + n) in bounds; cc: (n,) complex64
// conj(cutout); w0 (f0, f0), a1 (f0, f1), a2 (f0, f2), w1 (f1, f1), tw2
// (f1, f2), w2 (f2, f2) complex64 tables; s1, s2: (nb, f0, f1, f2) complex64
// scratch; rowmax / rowarg: (nb*f0*f1,) float32 / int32; out_max / out_bin:
// (nb,) float32 / int32. Returns a cudaError_t.
extern "C" int pdsp_caf3_peak(const void* rx, const void* cc,
                              const void* offs, const void* w0,
                              const void* a1, const void* a2, const void* w1,
                              const void* tw2, const void* w2, void* s1,
                              void* s2, void* rowmax, void* rowarg,
                              void* out_max, void* out_bin, int nb, int f0,
                              int f1, int f2, void* stream) {
  if (nb <= 0 || f0 <= 0 || f1 <= 0 || f2 <= 0 ||
      (long long)f0 * f1 * f2 > INT_MAX ||
      ((long long)f1 * f2 + TN - 1) / TN > 65535 ||
      (long long)nb * f0 > INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int cols = f1 * f2, blocks = nb * f0;
  const dim3 g1(nb, (f0 + TM - 1) / TM, (cols + TN - 1) / TN);
  window_stage1<<<g1, NT, 0, st>>>(
      static_cast<const float2*>(rx), static_cast<const float2*>(cc),
      static_cast<const float2*>(w0), static_cast<const long long*>(offs),
      0, 0, f0, cols,
      Caf3Epi{static_cast<float2*>(s1), static_cast<const float2*>(a1),
              static_cast<const float2*>(a2), f0, f1, f2});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(blocks, (f1 + TM - 1) / TM, (f2 + TN - 1) / TN);
  left_gemm<<<g2, NT, 0, st>>>(static_cast<const float2*>(w1),
                               static_cast<const float2*>(s1),
                               static_cast<float2*>(s2), f1, f2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g3(blocks, (f1 + TM - 1) / TM);
  peak_rows<<<g3, NT, 0, st>>>(
      TwDenseBatch{static_cast<const float2*>(s2),
                   static_cast<const float2*>(tw2), f1, f2},
      static_cast<const float2*>(w2), static_cast<float*>(rowmax),
      static_cast<int*>(rowarg), f1, f2, f2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Digits d{3, {f0, f1, f2}};
  peak_reduce<<<nb, NT, 0, st>>>(
      static_cast<const float*>(rowmax), static_cast<const int*>(rowarg),
      static_cast<float*>(out_max), static_cast<int*>(out_bin), f0 * f1, d);
  return (int)cudaGetLastError();
}
