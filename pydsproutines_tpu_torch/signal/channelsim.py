"""Channel simulation / remodulation: a constant-amplitude signal resampled
along a delay curve tau(t) with its carrier phase (reference native
interpolator stack: SampledLinearInterpolator_64f, ConstAmpSigLerp_64f,
ConstAmpSigLerpBursty_64f, ConstAmpSigLerpBurstyMulti_64f):

    x(t) = amp * exp(j*(phase(t - tau(t)) - 2*pi*fc*tau(t) + phi))

where phase() is linearly interpolated from a sampled phase curve and x is
nonzero only while t - tau lies inside the signal's time span. Bursty
variants add per-burst delay offsets (tau + tJump_b) and phases; the multi
variant sums several bursty emitters.

PyTorch counterpart of the JAX package's ``signal/channelsim.py``: each
burst is one masked gather + lerp + ``exp`` over the time vector on the
object's device (the card unless ``device`` names another). The phase is
formed in t's dtype: with a float64 time vector the carrier -2*pi*fc*tau
(~6e5 rad at 300 MHz and 300 us) keeps its fraction, which float32 loses,
and the result is complex128 as in the JAX package; cast it after the
``exp``.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import to_tensor


class SampledLinearInterpolator:
    """Linear interpolation of y sampled at x = n*T (reference
    SampledLinearInterpolator_64f), on ``device``."""

    def __init__(self, y, T: float, device=None):
        self.device = resolve_device(device)
        self.y = to_tensor(y, self.device)
        self.T = float(T)

    def lerp(self, xq) -> torch.Tensor:
        xg = to_tensor(xq, self.device) / self.T
        idx = torch.clamp(torch.floor(xg).long(), 0, self.y.shape[-1] - 2)
        rem = xg - idx
        y0 = self.y[idx]
        y1 = self.y[idx + 1]
        return y0 + (y1 - y0) * rem


def _const_amp_propagate(t, tau, phi, phasevec, T, t0, t1, amp, fc):
    tmtau = t - tau
    mask = (tmtau >= t0) & (tmtau <= t1)
    xg = (tmtau - t0) / T
    idx = torch.clamp(torch.floor(xg).long(), 0, phasevec.shape[-1] - 2)
    rem = xg - idx
    p0 = phasevec[idx]
    phase = p0 + (phasevec[idx + 1] - p0) * rem
    carrier = -2.0 * np.pi * fc * tau
    total = phase + carrier + phi
    x = amp * torch.exp(1j * total)
    return torch.where(mask, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _complex_of_time(t: torch.Tensor) -> torch.dtype:
    return torch.complex128 if t.dtype == torch.float64 else torch.complex64


class ConstAmpSigLerp:
    """Constant-amplitude signal propagated along a delay curve (reference
    ConstAmpSigLerp_64f.propagate), its phase curve on ``device``."""

    def __init__(self, timevec_start: float, timevec_end: float, phasevec,
                 T: float, amp: float, fc: float, device=None):
        self.t0 = float(timevec_start)
        self.t1 = float(timevec_end)
        self.phase_interp = SampledLinearInterpolator(phasevec, T, device)
        self.device = self.phase_interp.device
        self.amp = float(amp)
        self.fc = float(fc)

    def propagate(self, t, tau, phi: float = 0.0) -> torch.Tensor:
        """x[i] = amp * exp(j*(phase(t-tau) - 2*pi*fc*tau + phi)) masked to
        the signal's time span."""
        t = to_tensor(t, self.device)
        tau = to_tensor(tau, self.device)
        phi = torch.as_tensor(float(phi), dtype=t.dtype, device=self.device)
        return _const_amp_propagate(
            t, tau, phi, self.phase_interp.y, self.phase_interp.T, self.t0,
            self.t1, self.amp, self.fc)


class ConstAmpSigLerpBursty:
    """A train of bursts of one signal, each with its own delay offset and
    phase (reference ConstAmpSigLerpBursty_64f), summed on ``device``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.signals: list[ConstAmpSigLerp] = []

    def add_signal(self, sig: ConstAmpSigLerp):
        self.signals.append(sig)

    def propagate(self, t, tau, phi_arr, tjump_arr) -> torch.Tensor:
        t = to_tensor(t, self.device)
        tau = to_tensor(tau, self.device)
        out = torch.zeros(t.shape, dtype=_complex_of_time(t),
                          device=self.device)
        for sig, phi, tjump in zip(self.signals, np.asarray(phi_arr),
                                   np.asarray(tjump_arr)):
            out = out + sig.propagate(t, tau + float(tjump), float(phi))
        return out


class ConstAmpSigLerpBurstyMulti:
    """Several bursty emitters summed (reference
    ConstAmpSigLerpBurstyMulti_64f), on ``device``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.sigs: list[ConstAmpSigLerpBursty] = []

    def add_signal(self, sig: ConstAmpSigLerpBursty):
        self.sigs.append(sig)

    def propagate(self, t, tau, phi_arrs, tjump_arrs) -> torch.Tensor:
        t = to_tensor(t, self.device)
        out = torch.zeros(t.shape, dtype=_complex_of_time(t),
                          device=self.device)
        for sig, phis, tjumps in zip(self.sigs, phi_arrs, tjump_arrs):
            out = out + sig.propagate(t, tau, phis, tjumps)
        return out
