"""WOLA (weighted overlap-add) polyphase channelizer.

PyTorch counterpart of ``pydsproutines_tpu/ops/wola.py``:

    out[r, :] = N * ifft(dft_in[r, :]),
    dft_in[r, a] = sum_b x[r*Dec - (b*N + a)] * f_tap[b*N + a]

for r in [0, len(x)//Dec), with x zero before index 0 and, when N == 2*Dec,
the odd channels of (globally) odd rows negated.

``wola`` takes and returns complex samples. ``wola_planes`` and
``wola_planes_flat`` take float32 quadrature planes (re, im) and return the
channel matrix as planes: (rows, n) each, or the same storage as 1-D views
of rows*n (the JAX package's TPU I/O layouts, ``ops/wola.py:123,157``).

``select_wola_path`` makes the routing decision: N == Dec goes through the
Hopper kernel (ops/hopper/wola_fused.py), complex or plane instance, whose
CPU twin serves CPU tensors; N == 2*Dec is plain torch on any device (the
plane entry points interleave, run ``wola`` and split there, as the JAX
package does).
"""

from __future__ import annotations

import torch
from torch import nn

from pydsproutines_tpu_torch.ops.hopper.wola_fused import (plan_text,
                                                           wola_fused,
                                                           wola_fused_planes,
                                                           wola_plain,
                                                           wola_plan)
from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.freq import make_freq


def select_wola_path(n: int, dec: int, device, taps: int | None = None,
                     planes: bool = False) -> tuple[str, str]:
    """The routing decision of ``wola`` (``planes``: of ``wola_planes``):
    (path, reason). On the kernel's route the reason names its plan for
    ``taps`` taps (default 32 a channel)."""
    device = torch.device(device)
    if n == dec and device.type == "cuda":
        nb = max(1, (taps or 32 * n) // n)
        if planes:
            return "fused-planes-hopper", (
                f"N == Dec == {n}: Hopper WOLA kernel, float32 plane I/O "
                f"instance, {plan_text(wola_plan(n, nb))}")
        return "fused-hopper", (f"N == Dec == {n}: Hopper WOLA kernel, "
                                f"{plan_text(wola_plan(n, nb))}")
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
    return _wola_impl(f_tap, x, dec, n, row_offset)[0]


def _wola_impl(f_tap: torch.Tensor, x: torch.Tensor, dec: int,
               n: int | None = None, row_offset: int = 0):
    """The routed core of ``wola``; returns (what ``wola`` returns, the
    (path, reason) of ``select_wola_path`` for this call). At N == Dec the
    dispatch is ``wola_fused``'s: the kernel for a CUDA tensor, the twin
    for a CPU one, as the router says."""
    if n is None:
        n = dec
    if n != dec and n != 2 * dec:
        raise ValueError("Only N == Dec or N == 2*Dec supported (as reference).")
    if f_tap.shape[-1] % n != 0:
        raise ValueError("Filter tap length must be an integer multiple of N.")
    route = select_wola_path(n, dec, x.device, f_tap.shape[-1])
    if n == dec:
        if f_tap.is_complex():
            f_tap = f_tap.real.contiguous()
        return wola_fused(f_tap, x, n), route
    out = wola_plain(f_tap, x, dec, n)
    rows = out.shape[0]
    odd_row = (torch.arange(rows, device=x.device) + row_offset) % 2 == 1
    odd_chan = torch.arange(n, device=x.device) % 2 == 1
    flip = odd_row[:, None] & odd_chan[None, :]
    return torch.where(flip, -out, out), route


def wola_planes(f_tap: torch.Tensor, re: torch.Tensor, im: torch.Tensor,
                dec: int, n: int | None = None, row_offset: int = 0):
    """WOLA channelize float32 quadrature planes: the numbers of
    ``wola(f_tap, torch.complex(re, im), dec, n, row_offset)`` as
    ``(out_re, out_im)``, each (len(re)//dec, n) float32. At N == Dec a
    CUDA input launches the kernel's plane instance (no interleave or
    split); the planes are cut to rows*n samples first."""
    return _wola_planes_impl(f_tap, re, im, dec, n, row_offset)[0]


def wola_planes_flat(f_tap: torch.Tensor, re: torch.Tensor,
                     im: torch.Tensor, dec: int, n: int | None = None,
                     row_offset: int = 0):
    """``wola_planes`` with 1-D outputs: each plane's row-major (rows, n)
    channel matrix as a view of rows*n samples of the same storage."""
    o_re, o_im = wola_planes(f_tap, re, im, dec, n, row_offset)
    return o_re.view(-1), o_im.view(-1)


def _wola_planes_impl(f_tap: torch.Tensor, re: torch.Tensor,
                      im: torch.Tensor, dec: int, n: int | None = None,
                      row_offset: int = 0):
    """The routed core of ``wola_planes``; returns (what ``wola_planes``
    returns, the (path, reason) of ``select_wola_path(..., planes=True)``
    for this call). At N == Dec the dispatch is ``wola_fused_planes``'s:
    the plane instance for CUDA tensors, the twin for CPU ones; at N ==
    2*Dec the planes are interleaved for ``wola`` and its result split."""
    if n is None:
        n = dec
    rows = re.shape[-1] // dec
    re, im = re.to(torch.float32), im.to(torch.float32)
    if n != dec:
        out, route = _wola_impl(f_tap, torch.complex(re, im), dec, n,
                                row_offset)
        return (out.real.contiguous(), out.imag.contiguous()), route
    if f_tap.shape[-1] % n != 0:
        raise ValueError("Filter tap length must be an integer multiple of N.")
    route = select_wola_path(n, dec, re.device, f_tap.shape[-1], planes=True)
    if f_tap.is_complex():
        f_tap = f_tap.real.contiguous()
    return wola_fused_planes(f_tap, re[: rows * n], im[: rows * n],
                             n), route


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
