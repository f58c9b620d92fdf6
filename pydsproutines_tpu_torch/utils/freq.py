"""Frequency-axis helper (reference makeFreq): the natural FFT bin ordering
i/length*fs, wrapped to [-fs/2, fs/2)."""

from __future__ import annotations

import torch

from pydsproutines_tpu_torch.utils.dtypes import FLOAT_DTYPE


def make_freq(length: int, fs: float = 1.0, dtype: torch.dtype = FLOAT_DTYPE,
              device=None) -> torch.Tensor:
    """FFT bin frequencies wrapped to [-fs/2, fs/2)."""
    f = torch.arange(length, dtype=dtype, device=device) * (fs / length)
    return torch.where(f >= fs / 2, f - fs, f)
