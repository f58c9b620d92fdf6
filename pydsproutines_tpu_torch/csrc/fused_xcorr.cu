// Hopper frequency-scanning CAF peak search.
//
// Replaces the TPU kernel pydsproutines_tpu/ops/pallas/fused_xcorr.py:
// _caf_kernel. Contract: for each shift s = s0 + i*step, i in [0, nb),
//
//   X_s = DFT_n(rx[s : s+n] * cc),   cc = conj(cutout),
//   out_max[i] = max_k |X_s[k]|^2,   out_bin[i] = argmax_k |X_s[k]|^2.
//
// Ties go to the lowest bin k, the rule of torch.argmax / numpy.argmax on the
// natural-order spectrum, so the kernel and its plain twin agree even there.
//
// The DFT is an FFT in shared memory (fft_smem.cuh) under the plan of
// ops/fft.caf_plan: for n <= 8192 one launch per chunk, a block per few
// shifts transforming the whole modulated window and writing each shift's
// peak, no scratch; above, the four-step split n = n1*n2 (t = t1*n2 + t2,
// k = k1 + n1*k2): a column pass (gather + modulate on load, n1-point FFTs
// of C adjacent columns, twiddle W_n^(k1 t2) on store, G to a complex64
// scratch (nb, n1, n2)), a row pass (n2-point FFTs of G's contiguous rows,
// per-row (max |X|^2, argmax k2) in registers, the spectrum never stored)
// and peak_reduce over the n1 rows.
//
// What bounds it on the H100: bytes, ~32 n bytes per shift for two passes
// (window and template in, scratch out and in) against ~5 n log2 n flops.
// The TPU kernel kept the (n1, n2) product in VMEM and ran its DFT stages as
// bf16 matrix passes; an SM's 227 KB hold one column group, so the split
// goes through device memory (L2 for short sweeps).

#include "fft_smem.cuh"

// One chunk of nb shifts s0 + i*step. rx: complex64, covering every window;
// cc: (n,) complex64 conj(cutout); tables: host array of the eight device
// table pointers of ops/fft.caf_tables; plan: host int array of
// ops/fft.plan_ints; scratch: (nb, n) complex64, rowmax / rowarg: (nb, n /
// f_last) float32 / int32 (both unused by a one-pass plan); out_max /
// out_bin: (nb,) float32 / int32. Returns a cudaError_t.
extern "C" int pdsp_caf_peak(const void* rx, const void* cc,
                             const void* tables, const void* plan,
                             void* scratch, void* rowmax, void* rowarg,
                             void* out_max, void* out_bin, long long s0,
                             int step, int nb, void* stream) {
  CafPlan p;
  if (!read_plan(static_cast<const int*>(plan), p) || step <= 0 || s0 < 0)
    return (int)cudaErrorInvalidValue;
  return run_caf(static_cast<const float2*>(rx),
                 static_cast<const float2*>(cc), Shifts{nullptr, s0, step},
                 nb, p, static_cast<const void* const*>(tables),
                 static_cast<float2*>(scratch), static_cast<float*>(rowmax),
                 static_cast<int*>(rowarg), static_cast<float*>(out_max),
                 static_cast<int*>(out_bin), (cudaStream_t)stream);
}
