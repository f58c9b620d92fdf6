"""Frequency-axis helpers and tone generation (reference makeFreq,
freqshiftSignal): the natural FFT bin ordering i/length*fs, wrapped to
[-fs/2, fs/2), and complex tones formed from a phase in the real dtype of
the tone, as the JAX package's ``utils/freq.py`` does."""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import (FLOAT_DTYPE,
                                                  complex_dtype_for,
                                                  real_dtype_for)


def make_freq(length: int, fs: float = 1.0, dtype: torch.dtype = FLOAT_DTYPE,
              device=None) -> torch.Tensor:
    """FFT bin frequencies wrapped to [-fs/2, fs/2)."""
    f = torch.arange(length, dtype=dtype, device=device) * (fs / length)
    return torch.where(f >= fs / 2, f - fs, f)


def tone(length: int, freq: float, fs: float = 1.0, phase: float = 0.0,
         dtype: torch.dtype = torch.complex64, device=None) -> torch.Tensor:
    """exp(1j*(2*pi*freq*n/fs + phase)) for n in [0, length), the phase in
    the real dtype of ``dtype``; on the card unless ``device`` says
    otherwise."""
    n = torch.arange(length, dtype=real_dtype_for(dtype),
                     device=resolve_device(device))
    theta = 2 * np.pi * freq / fs * n + phase
    return torch.exp(1j * theta).to(dtype)


def freqshift_signal(x: torch.Tensor, freq: float,
                     fs: float = 1.0) -> torch.Tensor:
    """x * exp(1j*2*pi*freq*t) on x's device (reference freqshiftSignal)."""
    cdt = complex_dtype_for(x.dtype)
    return x.to(cdt) * tone(x.shape[-1], freq, fs, dtype=cdt,
                            device=x.device)
