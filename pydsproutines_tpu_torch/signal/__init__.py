"""Synthetic signal generation: PSK/CPFSK symbol streams, calibrated-SNR
noise, burst placement, sub-sample propagation and channel simulation, with
the JAX package's public names. The random generators take a
``torch.Generator`` where the JAX functions take a PRNG key."""

from pydsproutines_tpu_torch.signal.creation import (
    rand_bits,
    syms_from_bits,
    rand_psk_syms,
    randnoise,
    add_sig_to_noise,
    add_many_sig_to_noise,
    make_cpfsk_syms,
    make_pulsed_cpfsk_syms,
    propagate_signal,
    propagate_signal_exact,
    PSK_CONSTELLATIONS,
)
from pydsproutines_tpu_torch.signal.pulses import make_src4, make_scaled_src4
from pydsproutines_tpu_torch.signal.channelsim import (
    SampledLinearInterpolator,
    ConstAmpSigLerp,
    ConstAmpSigLerpBursty,
    ConstAmpSigLerpBurstyMulti,
)

__all__ = [
    "rand_bits",
    "syms_from_bits",
    "rand_psk_syms",
    "randnoise",
    "add_sig_to_noise",
    "add_many_sig_to_noise",
    "make_cpfsk_syms",
    "make_pulsed_cpfsk_syms",
    "propagate_signal",
    "propagate_signal_exact",
    "PSK_CONSTELLATIONS",
    "make_src4",
    "make_scaled_src4",
    "SampledLinearInterpolator",
    "ConstAmpSigLerp",
    "ConstAmpSigLerpBursty",
    "ConstAmpSigLerpBurstyMulti",
]
