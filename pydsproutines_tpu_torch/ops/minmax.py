"""Per-channel min-max scaling of channelizer output.

PyTorch counterpart of ``pydsproutines_tpu/ops/minmax.py`` (reference
minMaxScaler.py:12, the threaded C routine
multiChannel_minMaxScaler_32fc.c): per channel, scale the complex samples so
the amplitude range maps to [0, 1]. Plain torch on the device of the input;
no TPU kernel lies on this path.
"""

from __future__ import annotations

import torch

from pydsproutines_tpu_torch.utils.device import place
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for


def multichannel_minmax_scale(channels, preserve_phase: bool = False,
                              device=None) -> torch.Tensor:
    """Scale each channel of a (channels, time) complex matrix so its
    amplitude spans [0, 1].

    Default (matching the reference C routine, which emits scaled
    magnitudes): returns the real scaled-magnitude matrix. With
    ``preserve_phase`` the complex samples are rescaled instead. A channel
    whose amplitude does not vary is divided by 1 (it scales to 0); a zero
    sample keeps phase 0. A tensor stays on its device; an array goes to
    ``device`` (the card when None).
    """
    channels = place(channels, device)
    rdt = real_dtype_for(channels.dtype)
    amp = torch.abs(channels).to(rdt)
    amin = torch.amin(amp, dim=-1, keepdim=True)
    amax = torch.amax(amp, dim=-1, keepdim=True)
    span = torch.where(amax > amin, amax - amin, torch.ones_like(amax))
    scaled_amp = (amp - amin) / span
    if not preserve_phase:
        return scaled_amp
    phase = torch.where(amp > 0, channels / amp.to(channels.dtype),
                        torch.zeros((), dtype=channels.dtype,
                                    device=channels.device))
    return (phase * scaled_amp.to(channels.dtype)).to(channels.dtype)
