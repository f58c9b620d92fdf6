// Hopper CAF peak search over an int64 shift list, for big windows (n = 10M).
//
// Replaces the TPU kernels pydsproutines_tpu/ops/pallas/fused_caf3.py:
// _stage1_kernel and _stage23_kernel. Contract: for each shift s = offs[i],
// i in [0, nb),
//
//   X_s = DFT_n(rx[s : s+n] * cc),   cc = conj(cutout),
//   out_max[i] = max_k |X_s[k]|^2,   out_bin[i] = its k (lowest on ties).
//
// The passes are those of fused_xcorr.cu (fft_smem.cuh), read through each
// shift's offset with explicit bounds: only rx[s, s+n) is read, so a sweep
// whose last window ends at the end of rx needs no pad. ops/fft.caf_plan
// takes the fewest passes whose FFT lengths fit a block's shared memory
// (<= 8192 points): 10M = 1250 x 8000 in two passes over one 80 MB scratch
// per shift; three (n = f0*f1*f2, k = k0 + f0*(k1 + f1*k2), the second
// column pass in place over each k0 slab with twiddle W_{f1 f2}^(k1 t2))
// only where no two-factor split fits.
//
// What bounds it on the H100: bytes. At 10M a shift moves 320 MB (window and
// template in, scratch out and in: ~0.1 ms at 3.35 TB/s) against ~1.5 GFLOP
// of FFT work; the TPU kernels' bf16 scratch and the three-stage dense DFT
// products (n*(f0+f1+f2) complex MACs per shift) are not carried over.

#include "fft_smem.cuh"

// One chunk of nb shifts at int64 offsets offs (device, (nb,)). rx:
// complex64, each rx[offs[i], offs[i] + n) in bounds; the other arguments as
// pdsp_caf_peak's (fused_xcorr.cu). Returns a cudaError_t.
extern "C" int pdsp_caf3_peak(const void* rx, const void* cc,
                              const void* offs, const void* tables,
                              const void* plan, void* scratch, void* rowmax,
                              void* rowarg, void* out_max, void* out_bin,
                              int nb, void* stream) {
  CafPlan p;
  if (!read_plan(static_cast<const int*>(plan), p) || offs == nullptr)
    return (int)cudaErrorInvalidValue;
  return run_caf(static_cast<const float2*>(rx),
                 static_cast<const float2*>(cc),
                 Shifts{static_cast<const long long*>(offs), 0, 0}, nb, p,
                 static_cast<const void* const*>(tables),
                 static_cast<float2*>(scratch), static_cast<float*>(rowmax),
                 static_cast<int*>(rowarg), static_cast<float*>(out_max),
                 static_cast<int*>(out_bin), (cudaStream_t)stream);
}
