"""Cyclostationary / blind modulation estimation.

PyTorch counterpart of ``pydsproutines_tpu/ops/cyclostationary.py``
(reference cyclostationaryRoutines.py: PSKOrderDetector :16,
estimateBaud :126, estimateOffsetViaCM :172). Raise the signal to a power
m (a PSK of order m collapses to a tone), FFT, look at the peaks. Batched
rows go through one batched ``torch.fft`` on the device of the input; the
baud estimator's prominence-based peak sort stays on the host (numpy and
scipy, a copy of the JAX package's). No TPU kernel lies on this path.

Peak indices come back as int64 where the JAX package returns uint32:
torch lacks full uint32 arithmetic.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as sps
import torch

from pydsproutines_tpu_torch.utils.device import place
from pydsproutines_tpu_torch.utils.freq import make_freq


def _integer_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y for a positive integer y by repeated squaring, in the order
    XLA's ``integer_pow`` multiplies (``x ** order`` in the JAX package),
    not through exp(y log x)."""
    if y < 1:
        raise ValueError(f"order must be a positive integer, got {y}")
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def cm_peak_scan(x, num_iter: int, device=None):
    """Repeatedly square the rows of ``x`` and record the spectral peak
    (first index of the maximum, value) at each power 2, 4, ... (reference
    PSKOrderDetector._computeCmMaxes, cyclostationaryRoutines.py:102).

    A tensor stays on its device; an array goes to ``device`` (the card when
    None). Returns (mi (num_iter, N) int64, peaks (num_iter, N) real)."""
    xc = torch.atleast_2d(place(x, device))
    mis, peaks = [], []
    for _ in range(num_iter):
        xc = xc * xc
        xf = torch.abs(torch.fft.fft(xc, dim=-1))
        mis.append(torch.argmax(xf, dim=-1))
        peaks.append(torch.amax(xf, dim=-1))
    return torch.stack(mis), torch.stack(peaks)


class PSKOrderDetector:
    """PSK order detection by iterated squaring + spectral peak ratios
    (reference PSKOrderDetector, cyclostationaryRoutines.py:16).

    Later iterations overwrite earlier assignments, as in the reference:
    pure BPSK under ``max_m = 8`` reads as 4."""

    m_p = [2, 4, 8]

    def __init__(self, max_m: int):
        if max_m not in (4, 8):
            raise ValueError("Max order 'm' must be 4 or 8.")
        self.max_m = max_m
        self.mi = None
        self.peaks = None
        self.ratios = None

    def estimate_order(self, x, threshold: float = 0.2, device=None):
        """Order (2, 4 or 8) of each row of ``x`` as a uint8 numpy array.
        A tensor stays on its device; an array goes to ``device`` (the card
        when None). ``mi`` and ``peaks`` keep the scan's tensors."""
        x2 = torch.atleast_2d(place(x, device))
        num_iter = self.m_p.index(self.max_m) + 1
        n, length = x2.shape
        self.mi, self.peaks = cm_peak_scan(x2, num_iter)
        peaks = self.peaks.cpu().numpy()

        order = np.zeros(n, dtype=np.uint8)
        self.ratios = np.zeros((num_iter - 1, n))
        for i in range(1, num_iter):
            prediction = (peaks[i - 1] / length) ** 2 * length
            self.ratios[i - 1] = prediction / peaks[i]
            order[self.ratios[i - 1] > threshold] = self.m_p[i - 1]
        order[order == 0] = self.max_m
        return order


def estimate_baud(x, fs: float):
    """Baud estimation from the cyclic peaks of FFT(|x|) (reference
    estimateBaud, cyclostationaryRoutines.py:126), on the host. Returns
    (est_baud, idx1, idx2, Xf, freq)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    xf = np.fft.fftshift(np.fft.fft(np.abs(x)))
    xfabs = np.abs(xf)
    freq = np.fft.fftshift(make_freq(x.size, fs, dtype=torch.float64,
                                     device="cpu").numpy())
    peaks, _ = sps.find_peaks(xfabs)
    prominences = sps.peak_prominences(xfabs, peaks)[0]
    si = np.argsort(prominences)
    peaks = peaks[si]
    b1 = freq[peaks[-2]]
    b2 = freq[peaks[-3]]
    est_baud = (abs(b1) + abs(b2)) / 2
    return est_baud, peaks[-2], peaks[-3], xf, freq


def estimate_offset_via_cm(x, fs: float, order: int, device=None):
    """CMx0 carrier offset estimate: the peak of FFT(x^order) over order
    (reference estimateOffsetViaCM, cyclostationaryRoutines.py:172).

    The argmax is flat over every element, as ``jnp.argmax`` without an
    axis; its index into the frequency axis is clamped to the last bin, as
    a JAX gather clamps (only a 2-D ``x`` can reach past it). A tensor stays
    on its device; an array goes to ``device`` (the card when None).
    Returns a 0-d float32 tensor."""
    x = place(x, device)
    xpf = torch.fft.fft(_integer_pow(x, int(order)))
    n = x.shape[-1]
    mi = torch.argmax(torch.abs(xpf)).clamp(max=n - 1)
    freqvec = make_freq(n, fs, device=x.device)
    return freqvec[mi] / order
