"""Hand-written Hopper kernels, each beside its plain PyTorch twin:

* ``wola_fused``: WOLA channelizer, N == Dec (csrc/wola_fused.cu);
* ``fused_xcorr``: frequency-scanning CAF peak search (csrc/fused_xcorr.cu).

Each wrapper counts its launches in ``<wrapper>.launches``.
"""
