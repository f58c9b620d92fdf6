// Hopper last-stage DFT peak: twiddle, last DFT stage, |.|^2, per-row
// (max, argmax) and the true-bin reduction.
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/fft_peak.py:_kernel.
// Contract: for a batch of stage-1 outputs F_b (K1, J), a twiddle TW
// (K1, J) and the last-stage DFT W2 (J, K2),
//
//   R_b = (F_b * TW) @ W2,
//   rowmax[b, k1] = max_k2 |R_b[k1, k2]|^2,  rowarg[b, k1] = its k2,
//
// and per transform (R = f0*...*f_{L-2} rows of a plan f0..f_{L-1}, whose
// last two factors are K1, K2) the best row and its true bin
// k0 + f0*(k1 + ... + f_{L-2}*k_{L-1}); for a two-factor plan k1 + K1*k2.
// Ties go to the lowest true bin, as torch.argmax on the natural-order
// spectrum does; the TPU kernel broke ties in its permuted order instead.
//
//   peak_rows<TwDenseBatch>: the twiddle multiplies each A element as it is
//       loaded into shared memory; the product is the tiled complex GEMM of
//       cgemm.cuh; each block owns 64 rows and walks every k2 tile with the
//       per-row argmax in registers, so the spectrum is never stored;
//   peak_reduce: one block per transform.
//
// The fast_xcorr "peak-kernel-hopper" route feeds it from window_stage1 with
// a StoreEpi: the stage-1 DFT of each window, read through a per-shift int64
// offset list (no (B, n) gather copy, no BLAS call).
//
// What bounds it on the H100: f32 arithmetic on the CUDA cores, K1*J*K2
// complex MACs per transform (1e9 at n = 1000 x 1000) against one read of
// the (K1, J) stage-1 output; the A tile is re-read once per k2 tile from
// L2. Tensor cores and a fused stage 1 are later work.

#include "cgemm.cuh"

namespace {

bool digits_from(const int* factors, int nf, Digits* d) {
  if (nf < 2 || nf > MAX_FACTORS) return false;
  d->nf = nf;
  for (int i = 0; i < nf; ++i) {
    if (factors[i] <= 0) return false;
    d->f[i] = factors[i];
  }
  return true;
}

}  // namespace

// f1: (nbatch, K1, J) complex64 stage-1 output; tw: (K1, J); w2: (J, K2);
// rowmax / rowarg: (nbatch, K1) float32 / int32; out_max / out_bin:
// (ntrans,) float32 / int32 with ntrans = nbatch * K1 / R, R the product of
// all but the last of the nf factors (factors[nf-2] == K1,
// factors[nf-1] == K2). Returns a cudaError_t.
extern "C" int pdsp_stage2_peak(const void* f1, const void* tw,
                                const void* w2, void* rowmax, void* rowarg,
                                void* out_max, void* out_bin, int nbatch,
                                int K1, int J, int K2, const int* factors,
                                int nf, void* stream) {
  Digits d;
  if (nbatch <= 0 || K1 <= 0 || J <= 0 || K2 <= 0 || K1 > 65535 * TM ||
      !digits_from(factors, nf, &d) || d.f[nf - 2] != K1 || d.f[nf - 1] != K2)
    return (int)cudaErrorInvalidValue;
  long long R = 1;
  for (int i = 0; i < nf - 1; ++i) R *= d.f[i];
  const long long rows = (long long)nbatch * K1;
  if (R > INT_MAX || rows % R != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g(nbatch, (K1 + TM - 1) / TM);
  peak_rows<<<g, NT, 0, st>>>(
      TwDenseBatch{static_cast<const float2*>(f1),
                   static_cast<const float2*>(tw), K1, J},
      static_cast<const float2*>(w2), static_cast<float*>(rowmax),
      static_cast<int*>(rowarg), K1, J, K2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  peak_reduce<<<(unsigned)(rows / R), NT, 0, st>>>(
      static_cast<const float*>(rowmax), static_cast<const int*>(rowarg),
      static_cast<float*>(out_max), static_cast<int*>(out_bin), (int)R, d);
  return (int)cudaGetLastError();
}

// Stage 1 of a two-factor plan n = n1*n2 over nb windows at int64 offsets
// offs (device, (nb,)): out[z] = W1 @ P_z, P_z[t1, t2] = rx[offs[z] + t1*n2
// + t2] * cc[t1*n2 + t2]. w1: (n1, n1); out: (nb, n1, n2) complex64.
extern "C" int pdsp_window_stage1(const void* rx, const void* cc,
                                  const void* w1, const void* offs, void* out,
                                  int nb, int n1, int n2, void* stream) {
  if (nb <= 0 || n1 <= 0 || n2 <= 0 || (n2 + TN - 1) / TN > 65535 ||
      (n1 + TM - 1) / TM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 g(nb, (n1 + TM - 1) / TM, (n2 + TN - 1) / TN);
  window_stage1<<<g, NT, 0, st>>>(
      static_cast<const float2*>(rx), static_cast<const float2*>(cc),
      static_cast<const float2*>(w1), static_cast<const long long*>(offs),
      0, 0, n1, n2, StoreEpi{static_cast<float2*>(out), n1, n2});
  return (int)cudaGetLastError();
}
