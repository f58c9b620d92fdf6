// Hopper last-stage DFT peak: twiddle, last DFT stage, |.|^2, per-row
// (max, argmax) and the true-bin reduction.
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/fft_peak.py:_kernel.
// Contract (the JAX stage2_caf_peak): for a batch of stage-1 outputs F_b
// (K1, J) of a DFT plan whose last two factors are K1 and J, and the
// twiddle TW (K1, J),
//
//   R_b = (F_b * TW) @ DFT_J,
//   rowmax[b, k1] = max_k2 |R_b[k1, k2]|^2,  rowarg[b, k1] = its k2,
//
// and per transform (R = f0*...*f_{L-2} rows of a plan f0..f_{L-1}) the best
// row and its true bin k0 + f0*(k1 + ... + f_{L-2}*k_{L-1}); for a
// two-factor plan k1 + K1*k2. Ties go to the lowest true bin, as
// torch.argmax on the natural-order spectrum does; the TPU kernel broke ties
// in its permuted order instead. The JAX package only ever passes DFT_J as
// the last stage's matrix (_peak_consts), so the kernel takes none: the last
// stage is the J-point FFT of fft_smem.cuh.
//
// Design: row_peak (fft_smem.cuh) over TwRows, which multiplies each element
// of row r by tw[r % K1] as it is loaded into shared memory (the TPU
// kernel's twiddle, applied where it read its tile), then the in-place
// mixed-radix line FFT, |.|^2 and each row's (max, lowest k2) in registers:
// the spectrum is never stored. Rows of a deeper plan's leading factors are
// folded into the batch; peak_reduce (peak.cuh) rebuilds the true bins. J <=
// 8192 (ops/fft.best_two_factor and caf_plan cap every factor there).
//
// The fast_xcorr "peak-kernel-hopper" route feeds it from
// pdsp_window_cols: fft_smem.cuh's col_pass over the windows at each shift's
// int64 offset, storing the column FFTs without the four-step twiddle,
// which this kernel applies on load (no (B, n) gather copy, no library call).
//
// What bounds it on the H100: bytes. One read of the (B, K1, J) stage-1
// output (1.02 GB at (128, 1000, 1000), 0.31 ms at 3.35 TB/s) against
// ~5 J log2 J flops a row (7.5 GFLOP there); the dense (K1 x J) @ (J x J)
// product of the first version did 1.02 TFLOP.

#include "fft_smem.cuh"

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

// Row r of the stage-1 output times its twiddle row, read element by element.
struct TwRowView {
  const float2* p;
  const float2* tw;
  __device__ __forceinline__ float2 operator()(int k) const {
    return cmul(__ldg(p + k), __ldg(tw + k));
  }
};

// The (rows, J) stage-1 output, row r twiddled by tw[r % K1] (rows < 2^31).
struct TwRows {
  const float2* p;
  const float2* tw;
  int J;
  unsigned K1;
  __device__ __forceinline__ TwRowView at(long long r) const {
    return TwRowView{p + (size_t)r * J,
                     tw + (size_t)((unsigned)r % K1) * J};
  }
};

}  // namespace

// f1: (nbatch, K1, J) complex64 stage-1 output; tw: (K1, J) complex64;
// wl / rev: the J-point line table and digit reversal (ops/fft.line_table,
// digit_reversal); plan: the int array of ops/fft.row_plan(J) (one pass of
// J points, its rows per block); rowmax / rowarg: (nbatch * K1) float32 /
// int32; out_max / out_bin: (ntrans,) float32 / int32 with ntrans =
// nbatch * K1 / R, R the product of all but the last of the nf factors
// (factors[nf-2] == K1, factors[nf-1] == J). Returns a cudaError_t.
extern "C" int pdsp_stage2_peak(const void* f1, const void* tw,
                                const void* wl, const void* rev,
                                const void* plan, void* rowmax, void* rowarg,
                                void* out_max, void* out_bin, int nbatch,
                                int K1, const int* factors, int nf,
                                void* stream) {
  CafPlan p;
  Digits d;
  if (!read_plan(static_cast<const int*>(plan), p) || p.nf != 1 ||
      nbatch <= 0 || K1 <= 0 || !digits_from(factors, nf, &d) ||
      d.f[nf - 2] != K1 || d.f[nf - 1] != p.f[0])
    return (int)cudaErrorInvalidValue;
  long long R = 1;
  for (int i = 0; i < nf - 1; ++i) R *= d.f[i];
  const long long rows = (long long)nbatch * K1;
  if (R > INT_MAX || rows > INT_MAX || rows % R != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const LinePlan& lp = p.lp[0];
  const int J = lp.L, rb = p.lines[0];
  cudaError_t err = launch(
      row_peak<TwRows>, (rows + rb - 1) / rb, threads_for(rb * J),
      smem_bytes(lp, rb), st,
      TwRows{static_cast<const float2*>(f1), static_cast<const float2*>(tw),
             J, (unsigned)K1},
      lp, static_cast<const float2*>(wl), static_cast<const int*>(rev),
      static_cast<float*>(rowmax), static_cast<int*>(rowarg), rows, rb);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(peak_reduce, rows / R, NT, 0, st,
                     (const float*)rowmax, (const int*)rowarg,
                     static_cast<float*>(out_max), static_cast<int*>(out_bin),
                     (int)R, d);
}

// Stage 1 of a two-pass plan n = n1*n2 (ops/fft.caf_plan) over nb windows at
// int64 offsets offs (device, (nb,)): out[z, k1, t2] = sum_t1 W_n1^(k1*t1)
// rx[offs[z] + t1*n2 + t2] * cc[t1*n2 + t2], col_pass without its
// twiddle. wl / rev: the n1-point line table and digit reversal; out:
// (nb, n1, n2) complex64. Returns a cudaError_t.
extern "C" int pdsp_window_cols(const void* rx, const void* cc,
                                const void* offs, const void* wl,
                                const void* rev, const void* plan, void* out,
                                int nb, void* stream) {
  CafPlan p;
  if (!read_plan(static_cast<const int*>(plan), p) || p.nf != 2 ||
      offs == nullptr || nb <= 0)
    return (int)cudaErrorInvalidValue;
  const int n1 = p.f[0], n2 = p.f[1], c0 = p.lines[0];
  return (int)launch(
      col_pass<Windows, false>, (long long)nb * ((n2 + c0 - 1) / c0),
      threads_for(c0 * n1), smem_bytes(p.lp[0], c0), (cudaStream_t)stream,
      Windows{static_cast<const float2*>(rx), static_cast<const float2*>(cc),
              Shifts{static_cast<const long long*>(offs), 0, 0}, n2},
      static_cast<float2*>(out), p.lp[0], static_cast<const float2*>(wl),
      static_cast<const int*>(rev), (const float2*)nullptr, (long long)nb,
      n2, 1, c0);
}
