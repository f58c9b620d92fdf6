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
  (csrc/medfilt.cu).

The CAF kernels share ``csrc/cgemm.cuh``. Each wrapper counts its launches in
``<wrapper>.launches``.
"""
