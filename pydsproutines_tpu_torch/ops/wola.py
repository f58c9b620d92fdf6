"""WOLA (weighted overlap-add) polyphase channelizer.

PyTorch counterpart of ``pydsproutines_tpu/ops/wola.py``:

    out[r, :] = N * ifft(dft_in[r, :]),
    dft_in[r, a] = sum_b x[r*Dec - (b*N + a)] * f_tap[b*N + a]

for r in [0, len(x)//Dec), with x zero before index 0 and, when N == 2*Dec,
the odd channels of (globally) odd rows negated.

``select_wola_path`` makes the routing decision: N == Dec goes through the
Hopper kernel (ops/hopper/wola_fused.py), whose CPU twin serves CPU tensors;
N == 2*Dec is plain torch on any device.
"""

from __future__ import annotations

import torch
from torch import nn

from pydsproutines_tpu_torch.ops.hopper.wola_fused import wola_fused, wola_plain
from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.freq import make_freq


def select_wola_path(n: int, dec: int, device) -> tuple[str, str]:
    """The routing decision of ``wola``: (path, reason)."""
    device = torch.device(device)
    if n == dec and device.type == "cuda":
        return "fused-hopper", f"N == Dec == {n}: Hopper WOLA kernel"
    if n == dec:
        return "plain", f"{device.type} tensor: plain torch twin"
    return "plain", f"N == 2*Dec ({n} = 2*{dec}): plain torch, odd-row flip"


def wola(f_tap: torch.Tensor, x: torch.Tensor, dec: int, n: int | None = None,
         row_offset: int = 0) -> torch.Tensor:
    """WOLA channelize ``x`` into ``n`` channels decimated by ``dec``.

    ``f_tap`` has a length that is a multiple of ``n``; ``n`` must be
    ``dec`` or ``2*dec``. ``row_offset`` is the global index of the first
    output row, so that streamed blocks flip the same rows (N == 2*Dec) as
    the whole-signal computation. Complex taps are used as they are at
    N == 2*Dec; at N == Dec only their real part is (the JAX package's
    ``jnp.real(f_tap)``), before the kernel or its twin.
    """
    if n is None:
        n = dec
    if n != dec and n != 2 * dec:
        raise ValueError("Only N == Dec or N == 2*Dec supported (as reference).")
    if f_tap.shape[-1] % n != 0:
        raise ValueError("Filter tap length must be an integer multiple of N.")
    if n == dec:
        if f_tap.is_complex():
            f_tap = f_tap.real.contiguous()
        return wola_fused(f_tap, x, n)
    out = wola_plain(f_tap, x, dec, n)
    rows = out.shape[0]
    odd_row = (torch.arange(rows, device=x.device) + row_offset) % 2 == 1
    odd_chan = torch.arange(n, device=x.device) % 2 == 1
    flip = odd_row[:, None] & odd_chan[None, :]
    return torch.where(flip, -out, out)


class Channeliser(nn.Module):
    """Streaming WOLA channelizer (reference Channeliser): keeps a
    filter-length delay line, prepends it each call, and discards the first
    len(f_tap)/Dec warm-up rows so consecutive blocks concatenate exactly.
    Its state lives on ``device``, ``cuda`` when None.
    """

    def __init__(self, num_taps: int | None = None, num_channels: int = 64,
                 dec: int | None = None, f_tap=None,
                 dtype: torch.dtype = torch.complex64, device=None):
        super().__init__()
        device = resolve_device(device)
        if dec is None:
            dec = num_channels
        self.dec = int(dec)
        self.num_channels = int(num_channels)
        if f_tap is None:
            from scipy import signal as sps
            f_tap = sps.firwin(num_taps, 1.0 / dec)
        f_tap = torch.as_tensor(f_tap, dtype=torch.float32, device=device)
        if f_tap.shape[-1] % self.num_channels != 0:
            raise ValueError("numTaps must be a multiple of numChannels.")
        self.register_buffer("f_tap", f_tap)
        self.register_buffer("delay", torch.zeros(
            f_tap.shape[-1], dtype=dtype, device=device), persistent=False)
        self.jump = int(f_tap.shape[-1] // self.dec)
        self._samples_consumed = 0

    def reset(self):
        self.delay.zero_()
        self._samples_consumed = 0

    def channelise(self, x: torch.Tensor) -> torch.Tensor:
        """Channelize one block; returns (floor(len(x)/dec), num_channels).
        len(x) must be a multiple of dec for seamless streaming."""
        x = torch.as_tensor(x, dtype=self.delay.dtype, device=self.delay.device)
        y = torch.cat([self.delay, x])
        row_offset = self._samples_consumed // self.dec - self.jump
        channels = wola(self.f_tap, y, self.dec, self.num_channels,
                        row_offset=row_offset)
        self.delay = y[-self.f_tap.shape[-1]:].clone()
        self._samples_consumed += int(x.shape[-1])
        return channels[self.jump:, :]

    def channel_freqs(self, fs: float = 1.0) -> torch.Tensor:
        """Centre frequency of each channel (reference channelFreqs)."""
        return make_freq(self.num_channels, fs, device=self.f_tap.device)

    def channel_fs(self, fs: float = 1.0) -> float:
        """Per-channel output sampling rate (reference channelFs)."""
        return fs / self.dec
