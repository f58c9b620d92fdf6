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
//   window_stage1<TwEpi>: gather + modulate p = rx[s + t] * cc[t] on the
//               fly, stage-1 DFT as a tiled complex matrix product, twiddle,
//               store G to an f32 scratch (nb, n1, n2) in device memory;
//   peak_rows:  stage-2 DFT as a tiled complex product; each block owns 64
//               k1 rows and walks every k2 tile, keeping per-row
//               (max |X|^2, argmax k2) in registers — the spectrum is never
//               stored (cgemm.cuh, shared with fft_peak.cu);
//   peak_reduce: per shift, the best (value, bin) over the n1 rows.
//
// What bounds it on the H100: arithmetic. The two stages cost n*(n1 + n2)
// complex MACs per shift (2e9 at n = 1M, i.e. 16 GFLOP), all in f32 on the
// CUDA cores (67 TFLOP/s peak), against 8 MB of window read and a 16 MB
// scratch round trip per shift. The tiled products keep each thread at a
// 4x4 complex micro-tile (8 shared loads per 64 FMAs). The TPU kernel kept
// the stage-1 result on chip and ran bf16 matrix passes; fusing the stages
// and moving them onto tensor cores is later work.

#include "cgemm.cuh"

namespace {

// Stage-1 epilogue: the four-step twiddle, then store G (nb, n1, n2).
struct TwEpi {
  float2* out;
  const float2* tw;
  int n1, n2;
  __device__ __forceinline__ void operator()(long long z, int m, int c,
                                             float2 v) const {
    const size_t idx = (size_t)m * n2 + c;
    out[(size_t)z * n1 * n2 + idx] = cmul(v, tw[idx]);
  }
};

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
  if (nb <= 0 || n1 <= 0 || n2 <= 0 || step <= 0 || s0 < 0 ||
      (n2 + TN - 1) / TN > 65535 || (n1 + TM - 1) / TM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g1(nb, (n1 + TM - 1) / TM, (n2 + TN - 1) / TN);
  window_stage1<<<g1, NT, 0, st>>>(
      static_cast<const float2*>(rx), static_cast<const float2*>(cc),
      static_cast<const float2*>(w1), nullptr, s0, step, n1, n2,
      TwEpi{static_cast<float2*>(scratch), static_cast<const float2*>(tw), n1,
            n2});
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(nb, (n1 + TM - 1) / TM);
  peak_rows<<<g2, NT, 0, st>>>(
      DenseBatch{static_cast<const float2*>(scratch), n1, n2},
      static_cast<const float2*>(w2), static_cast<float*>(rowmax),
      static_cast<int*>(rowarg), n1, n2, n2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Digits d{2, {n1, n2}};
  peak_reduce<<<nb, NT, 0, st>>>(
      static_cast<const float*>(rowmax), static_cast<const int*>(rowarg),
      static_cast<float*>(out_max), static_cast<int*>(out_bin), n1, d);
  return (int)cudaGetLastError();
}
