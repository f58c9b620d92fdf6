"""Multi-preamble FFT-subset correlator.

PyTorch counterpart of ``pydsproutines_tpu/ops/multicorr.py``: searching an
oversampled capture for K equal-length critically-sampled preambles with a
CAF whose frequency resolution equals the preamble's own bin spacing.
Brick-wall upsampling by an integer eta keeps the preamble's bins as a
contiguous subset of the oversampled bins, so each input window takes one
length eta*L FFT, and every preamble spectrum is dotted against each of the
C = (eta-1)*L + 1 contiguous length-L spectral windows (C carrier offsets).

Normalisation: QF^2 = |dot|^2 / ||X window||^2 / ||Y||^2 in the spectral
domain, 0 where the denominator is 0. Windowed spectral energies come from a
float64 prefix sum; the dots are one full-f32 product. No TPU kernel runs
here.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import full_f32, numpy_dtype
from pydsproutines_tpu_torch.utils.memory import chunk_shifts


class MultiPreambleCorrelator:
    """Cached-plan correlator for K equal-length preambles.

    preambles : (K, L) complex array at the critical (symbol) rate.
    osr : integer oversampling factor eta of the capture relative to the
        preamble sample rate.
    device : where the preamble spectra live; ``cuda`` when None.
    """

    def __init__(self, preambles, osr: int,
                 dtype: torch.dtype = torch.complex64, device=None):
        preambles = np.atleast_2d(np.asarray(preambles))
        if osr < 1 or int(osr) != osr:
            raise ValueError("osr must be a positive integer")
        self.device = resolve_device(device)
        self.osr = int(osr)
        self.k, self.l = preambles.shape
        self.window = self.osr * self.l
        self.c = (self.osr - 1) * self.l + 1
        yf = np.fft.fftshift(np.fft.fft(preambles, axis=-1), axes=-1)
        self.dtype = dtype
        self._yconj = torch.from_numpy(
            np.conj(yf).astype(numpy_dtype(dtype))).to(self.device)
        self._ynorm = torch.from_numpy(
            np.sum(np.abs(yf) ** 2, axis=-1)).to(self.device)
        self._spec_idx = (torch.arange(self.c)[:, None]
                          + torch.arange(self.l)[None, :]).to(self.device)

    def freq_offsets(self, fsp: float) -> np.ndarray:
        """Carrier offset (Hz) of each of the C output columns, for a
        preamble sample rate of ``fsp``: offset c aligns preamble bin j with
        input bin c + j, i.e. df = (c - (eta-1)L/2) * fsp / L."""
        c = np.arange(self.c, dtype=np.float64)
        return (c - (self.osr - 1) * self.l / 2.0) * fsp / self.l

    def correlate(self, x: torch.Tensor, shifts=None,
                  batch_size: int = 128) -> torch.Tensor:
        """QF^2 CAF over (preamble, shift, freq offset): (K, num_shifts, C)
        float32. ``shifts`` defaults to every full window."""
        x = x.to(self.dtype)
        nvalid = x.shape[-1] - self.window + 1
        if nvalid <= 0:
            raise ValueError("input shorter than one preamble window")
        if shifts is None:
            shifts = torch.arange(nvalid)
        shifts = torch.as_tensor(shifts, dtype=torch.int64, device=x.device)
        if int(shifts.min()) < 0 or int(shifts.max()) >= nvalid:
            raise ValueError("a shift's window runs past the input")
        chunk = chunk_shifts(self.c * self.l, min(batch_size, shifts.shape[0]),
                             16)
        ar = torch.arange(self.window, device=x.device)
        parts = []
        for c0 in range(0, shifts.shape[0], chunk):
            win = x[shifts[c0: c0 + chunk, None] + ar]
            spec = torch.fft.fftshift(torch.fft.fft(win, dim=-1), dim=-1)
            power = spec.real.double() ** 2 + spec.imag.double() ** 2
            csum = torch.cat([power.new_zeros(power.shape[0], 1),
                              torch.cumsum(power, -1)], -1)
            ex = csum[:, self.l:] - csum[:, :-self.l]            # (B, C)
            with full_f32():
                dots = torch.einsum("bcl,kl->kbc", spec[:, self._spec_idx],
                                    self._yconj)
            mag = dots.real.double() ** 2 + dots.imag.double() ** 2
            den = ex[None] * self._ynorm[:, None, None]
            parts.append(torch.where(den > 0, mag / torch.where(
                den > 0, den, 1.0), 0.0).to(torch.float32))
        return torch.cat(parts, dim=1)
