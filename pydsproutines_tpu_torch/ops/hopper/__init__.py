"""Hand-written Hopper kernels, each beside its plain PyTorch twin:

* ``wola_fused``: WOLA channelizer, N == Dec (csrc/wola_fused.cu);
* ``fused_xcorr``: frequency-scanning CAF peak search over a uniform sweep
  (csrc/fused_xcorr.cu);
* ``fft_peak``: last-stage DFT peak (twiddle on load, row FFT, |.|^2,
  per-row argmax, true-bin reduction) and the shift-list sweep built on it
  (csrc/fft_peak.cu);
* ``fused_caf3``: CAF peak search over an int64 shift list
  (csrc/fused_caf3.cu);
* ``upfirdn``: scipy-exact upfirdn of real-tap planes (csrc/upfirdn.cu);
* ``medfilt``: scipy-exact median filter by radix select
  (csrc/medfilt.cu);
* ``group_caf``: group cross-correlation CAF, the CZT group-xcorr sweep, a
  complex GEMM on the tensor cores in 3xTF32 (csrc/group_caf.cu);
* ``sliding``: sliding normalised multi-template matched filter
  (csrc/sliding.cu).

The CAF kernels (fused_xcorr, fused_caf3, fft_peak) share the
shared-memory FFT of ``csrc/fft_smem.cuh`` and the peak reduction of
``csrc/peak.cuh``. Each wrapper counts its launches in
``<wrapper>.launches``.
"""
