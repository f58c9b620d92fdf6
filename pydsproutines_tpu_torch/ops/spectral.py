"""Spectral transforms: CZT (chirp-Z, zoom FFT), direct DFT at arbitrary
frequencies, analytic tone spectrum, integer-multiple padded FFT and
overlap-add burst FFT.

PyTorch counterpart of ``pydsproutines_tpu/ops/spectral.py``. Plan
constants (chirps, tone banks) are built on the host in float64 and stored
at the plan's dtype on its device. The CZT is f32-exact on every path: its
tone-bank product runs under ``utils.dtypes.full_f32()`` and the Bluestein
path is ``torch.fft``; the JAX package's bf16-grade small-n DFT tier (ROADMAP
Queue 3) has no counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import (full_f32, numpy_dtype,
                                                  real_dtype_for)
from pydsproutines_tpu_torch.utils.fftlen import next_fast_len

# the JAX plan's gate for its direct (m, k) tone bank (ops/spectral.py:89)
TONE_BANK_MAX = 4_000_000


def _chirp_phase_exp(scale: float, kk2: np.ndarray) -> np.ndarray:
    """exp(-1j * scale * kk2) evaluated in float64 with the phase wrapped
    mod 2*pi before the complex exponential, to keep precision for large
    kk2."""
    phase = np.mod(scale * kk2, 2.0 * np.pi)
    return np.exp(-1j * phase)


class CZT:
    """Cached chirp-Z transform plan.

    The spectrum of a length-``m`` input at ``k`` bins from ``f1`` spaced by
    ``bin_width`` (f2 inclusive): freqs = f1 + arange(k) * bin_width,
    k = int((f2 - f1) / bin_width + 1). With m * k <= 4,000,000 the plan
    keeps the (m, k) tone bank and a call is one full-f32 product; otherwise
    it runs Bluestein's algorithm (x*aa -> fft(nfft) -> *fv -> ifft ->
    slice*ww) on ``torch.fft``. Constants live on ``device`` (``cuda`` when
    None); inputs must be there too. A plan known by its bin count is built
    with ``k`` given and ``f2=None``: f2 is then f1 + (k - 1) * bin_width.
    """

    def __init__(self, xlength: int, f1: float, f2: float | None,
                 bin_width: float, fs: float,
                 dtype: torch.dtype = torch.complex64, device=None,
                 k: int | None = None):
        self.device = resolve_device(device)
        self.f1 = float(f1)
        self.bin_width = float(bin_width)
        self.fs = float(fs)
        if k is None:
            self.k = int((f2 - f1) / bin_width + 1)
        else:
            self.k = int(k)
            f2 = f1 + (self.k - 1) * bin_width
        self.m = int(xlength)
        self.nfft = next_fast_len(self.m + self.k - 1, max_prime=7)
        self.dtype = dtype
        npdt = numpy_dtype(dtype)

        m, k = self.m, self.k
        kk = np.arange(-m + 1, max(k - 1, m - 1) + 1, dtype=np.float64)
        kk2 = kk * kk / 2.0
        scale = 2.0 * np.pi * (f2 - f1 + bin_width) / (k * fs)
        ww = _chirp_phase_exp(scale, kk2)
        chirpfilter = 1.0 / ww[: k - 1 + m]
        fv = np.fft.fft(chirpfilter, self.nfft)
        nn = np.arange(m, dtype=np.float64)
        aa = np.exp(-1j * np.mod(2.0 * np.pi * f1 / fs * nn, 2.0 * np.pi))
        aa = aa * ww[m + np.arange(m) - 1]
        self.ww_tail = ww[m - 1: m + k - 1].astype(npdt)
        self.fv = fv.astype(npdt)
        self.aa = aa.astype(npdt)
        self.tones = None
        if m * k <= TONE_BANK_MAX:
            t_idx = np.arange(m, dtype=np.float64)
            phase = np.mod(np.outer(t_idx, self.freqs() / fs), 1.0) * 2 * np.pi
            self.tones = np.exp(-1j * phase).astype(npdt)
        self._t = {name: torch.from_numpy(a).to(self.device)
                   for name, a in (("aa", self.aa), ("fv", self.fv),
                                   ("ww", self.ww_tail), ("tones", self.tones))
                   if a is not None}

    def freqs(self) -> np.ndarray:
        """Frequency bin centres (host float64, like CZTCached.getFreq)."""
        return np.arange(self.k) * self.bin_width + self.f1

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """CZT along the last axis, of 1-D input or batched rows."""
        if x.device != self.device:
            raise ValueError(f"input on {x.device}, CZT plan on {self.device}")
        x = x.to(self.dtype)
        if self.tones is not None:
            with full_f32():
                return x @ self._t["tones"]
        return _czt_bluestein(x, self._t["aa"], self._t["fv"], self._t["ww"],
                              self.m, self.k, self.nfft)

    run = __call__
    run_many = __call__


def _czt_bluestein(x, aa, fv, ww_tail, m: int, k: int, nfft: int):
    fy = torch.fft.fft(x * aa, n=nfft, dim=-1)
    g = torch.fft.ifft(fy * fv, dim=-1)
    return g[..., m - 1: m + k - 1] * ww_tail


@functools.lru_cache(maxsize=64)
def get_czt_plan(xlength: int, f1: float, f2: float, bin_width: float,
                 fs: float, dtype: torch.dtype = torch.complex64,
                 device: str | None = None) -> CZT:
    """Memoized CZT plan factory for repeated one-shot calls; the plan
    lives on ``device`` (``cuda`` when None)."""
    return CZT(xlength, f1, f2, bin_width, fs, dtype=dtype, device=device)


def czt(x: torch.Tensor, f1: float, f2: float, bin_width: float, fs: float,
        dtype: torch.dtype | None = None) -> torch.Tensor:
    """One-shot CZT on ``x``'s device (reference czt). For repeated use
    with one geometry build a ``CZT`` plan."""
    plan = get_czt_plan(x.shape[-1], float(f1), float(f2), float(bin_width),
                        float(fs), dtype or x.dtype, str(x.device))
    return plan(x)


def dft(x: torch.Tensor, freqs: torch.Tensor, fs: float = 1.0
        ) -> torch.Tensor:
    """Direct DFT of ``x`` at arbitrary ``freqs`` (reference dft):
    out[i] = sum_n exp(-2j*pi*f_i*n/fs) * x[n], as a (num_freqs, n) tone
    bank times the signal, built in x's real dtype."""
    rdt = real_dtype_for(x.dtype)
    n = torch.arange(x.shape[-1], dtype=rdt, device=x.device)
    freqs = torch.as_tensor(freqs, device=x.device).to(rdt)
    phase = (-2.0 * np.pi / fs) * freqs[:, None] * n[None, :]
    tones = torch.polar(torch.ones_like(phase), phase).to(x.dtype)
    with full_f32():
        return tones @ x


def tone_spectrum(f0: float, freqs: torch.Tensor, fs: float, n: int,
                  phi: float = 0.0, amplitude: float = 1.0) -> torch.Tensor:
    """Analytic spectrum of a length-``n`` tone at ``f0`` evaluated at
    ``freqs`` (reference toneSpectrum):
    -1j*A*(1 - exp(-2j*pi*(f-f0)*N/fs)) / (2*pi*(f-f0)/fs) * exp(1j*phi),
    with its removable singularity at f == f0 filled by A*N*exp(1j*phi)."""
    df = torch.as_tensor(freqs) - f0
    num = 1.0 - torch.exp(-1j * 2 * np.pi * df * n / fs)
    den = 2 * np.pi * df / fs
    safe = torch.where(den == 0, torch.ones_like(den), den)
    vals = -1j * amplitude * num / safe * np.exp(1j * phi)
    return torch.where(den == 0, amplitude * n * np.exp(1j * phi), vals)


class IntegerMultipleFFT:
    """Padded FFT of length multiple*N via ``multiple`` tone-shifted length-N
    FFTs (reference IntegerMultipleFFT); the tone table lives on ``device``
    (``cuda`` when None)."""

    def __init__(self, multiple: int, unpad_length: int,
                 dtype: torch.dtype = torch.complex64, device=None):
        self.multiple = int(multiple)
        self.n = int(unpad_length)
        i = np.arange(self.multiple, dtype=np.float64)[:, None]
        nn = np.arange(self.n, dtype=np.float64)[None, :]
        tones = np.exp(-1j * 2 * np.pi * (i / self.multiple) * (nn / self.n))
        self.tones = torch.from_numpy(tones.astype(numpy_dtype(dtype))).to(
            resolve_device(device))

    def fft(self, x: torch.Tensor, reorder: bool = False) -> torch.Tensor:
        """Row i of the output is fft(x * tone_i). With ``reorder`` the rows
        are interleaved to equal torch.fft.fft(x, n=multiple*N)."""
        out = torch.fft.fft(x[None, :] * self.tones, dim=-1)
        return out.T.reshape(-1) if reorder else out

    @property
    def padded_length(self) -> int:
        return self.multiple * self.n


def burst_fft(x: torch.Tensor, length: int) -> torch.Tensor:
    """Overlap-add fold-then-FFT spectrum of length-multiple bursts
    (reference burstFFT): zero-pad x to a multiple of ``length``, fold rows,
    sum, then one length-``length`` FFT."""
    n = x.shape[-1]
    pad = -(-n // length) * length - n
    xp = torch.nn.functional.pad(x, (0, pad))
    return torch.fft.fft(xp.reshape(-1, length).sum(dim=0))
