"""Hand-written Hopper kernels, each beside its plain PyTorch twin:

* ``wola_fused``: WOLA channelizer, N == Dec (csrc/wola_fused.cu);
* ``fused_xcorr``: two-stage frequency-scanning CAF peak search
  (csrc/fused_xcorr.cu);
* ``fft_peak``: last-stage DFT peak (twiddle, last stage, |.|^2, per-row
  argmax, true-bin reduction) and the shift-list sweep built on it
  (csrc/fft_peak.cu);
* ``fused_caf3``: three-stage CAF peak search for big windows
  (csrc/fused_caf3.cu);
* ``upfirdn``: scipy-exact upfirdn of real-tap planes (csrc/upfirdn.cu);
* ``medfilt``: scipy-exact median filter by radix select
  (csrc/medfilt.cu);
* ``group_caf``: group cross-correlation CAF, the CZT group-xcorr sweep
  (csrc/group_caf.cu);
* ``sliding``: sliding normalised multi-template matched filter
  (csrc/sliding.cu).

The CAF kernels and the group CAF share ``csrc/cgemm.cuh``. Each wrapper
counts its launches in ``<wrapper>.launches``.
"""
