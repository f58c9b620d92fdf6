"""Flagship end-to-end receiver pipeline (PyTorch counterpart of
``pydsproutines_tpu/models/receiver.py``):

    wideband block -> WOLA channelize -> strongest-channel select ->
    frequency-scanning CAF peak search against a template -> demod
    (eye opening + phase lock + symbol map) at the peak.

On a CUDA device the channelizer and the peak search run the hand-written
Hopper kernels (``run()`` reports both routes and the kernels' launch
counts). The channel and peak selections read one scalar each back to the
host; all the work stays on the device.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pydsproutines_tpu_torch.ops.demod import get_eye_opening, lock_phase, map_syms
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import caf_peak
from pydsproutines_tpu_torch.ops.hopper.wola_fused import wola_fused
from pydsproutines_tpu_torch.ops.wola import select_wola_path, wola
from pydsproutines_tpu_torch.ops.xcorr import (_fast_xcorr_impl,
                                               convert_qf2_to_eff_snr,
                                               select_xcorr_path)
from pydsproutines_tpu_torch.utils.device import resolve_device


class WidebandReceiver(nn.Module):
    """Channelize -> detect -> xcorr -> demod pipeline.

    Parameters
    ----------
    num_channels : WOLA channels (num_channels == dec here).
    num_taps : channelizer prototype filter length (multiple of num_channels).
    template_len : xcorr template length at channel rate.
    num_shifts : sliding shifts searched at channel rate.
    osr : samples per symbol at channel rate (for the demod stage).
    demod_syms : symbols demodulated at the CAF peak.
    m : PSK order.
    f_tap : prototype filter taps; default ``scipy.signal.firwin(num_taps,
        1/num_channels)``, the JAX receiver's.
    device : where the taps live; ``cuda`` when None (which raises without
        CUDA: pass ``device="cpu"`` for a CPU run).
    """

    def __init__(self, num_channels: int = 64, num_taps: int = 512,
                 template_len: int = 1024, num_shifts: int = 256,
                 osr: int = 4, demod_syms: int = 128, m: int = 4,
                 f_tap=None, device=None):
        super().__init__()
        self.num_channels = int(num_channels)
        self.dec = int(num_channels)
        self.num_taps = int(num_taps)
        if f_tap is None:
            from scipy import signal as sps
            f_tap = sps.firwin(num_taps, 1.0 / self.dec)
        self.register_buffer("f_tap", torch.tensor(
            np.asarray(f_tap, dtype=np.float32), device=resolve_device(device)))
        if self.f_tap.shape != (self.num_taps,):
            raise ValueError(f"f_tap has shape {tuple(self.f_tap.shape)}, "
                             f"expected ({self.num_taps},)")
        self.template_len = int(template_len)
        self.num_shifts = int(num_shifts)
        self.osr = int(osr)
        self.demod_syms = int(demod_syms)
        self.m = int(m)

    @classmethod
    def from_numpy_params(cls, params: dict, device=None) -> "WidebandReceiver":
        """Build from ``{"f_tap": taps, **config}``, e.g. the JAX receiver's
        ``np.asarray(rcv.f_tap)`` and constructor arguments."""
        params = dict(params)
        return cls(f_tap=np.asarray(params.pop("f_tap")), device=device,
                   **params)

    def step(self, template_ri: torch.Tensor, rx_ri: torch.Tensor):
        """One forward step.

        template_ri : (2, template_len) float32, re/im of the xcorr template
            at channel rate.
        rx_ri : (2, n_wideband) float32, re/im of the wideband capture.

        Returns (qf2 peak, best shift, best freq bin, per-channel energy,
        demod symbol indices as int32).
        """
        template = torch.complex(template_ri[0], template_ri[1])
        rx = torch.complex(rx_ri[0], rx_ri[1])

        channels = wola(self.f_tap, rx, self.dec, self.num_channels)
        energy = torch.mean(channels.real ** 2 + channels.imag ** 2, dim=0)
        x = channels[:, int(torch.argmax(energy))].contiguous()

        shifts = torch.arange(self.num_shifts, device=x.device)
        qf2, freqbins = _fast_xcorr_impl(
            template, x, shifts, n=self.template_len,
            batch_size=min(128, self.num_shifts), step=1)
        ipeak = int(torch.argmax(qf2))

        # a fixed-length slice from the peak, its start clamped to fit
        # (jax.lax.dynamic_slice semantics)
        seg_len = self.demod_syms * self.osr
        start = max(0, min(ipeak, x.shape[0] - seg_len))
        xeo, _, _ = get_eye_opening(x[start: start + seg_len], self.osr)
        reimc, _, _ = lock_phase(xeo, self.m)
        syms = map_syms(reimc, self.m)
        return (qf2[ipeak], ipeak, freqbins[ipeak], energy,
                syms.to(torch.int32))

    def run(self, template_ri: torch.Tensor, rx_ri: torch.Tensor) -> dict:
        """One step plus a structured run summary: the JAX receiver's keys,
        plus the WOLA route and the Hopper kernels' launches in this step."""
        launches0 = (wola_fused.launches, caf_peak.launches)
        qf2, ipeak, fbin, energy, syms = self.step(template_ri, rx_ri)
        energy = energy.cpu().numpy()
        dev = rx_ri.device
        path, reason = select_xcorr_path(self.template_len, torch.complex64,
                                         1, dev)
        wpath, wreason = select_wola_path(self.num_channels, self.dec, dev)
        qf2 = float(qf2)
        return {
            "qf2_peak": qf2,
            "eff_snr_db": float(10 * np.log10(max(
                convert_qf2_to_eff_snr(min(qf2, 1 - 1e-9)), 1e-12))),
            "best_shift": int(ipeak),
            "freq_bin": int(fbin),
            "best_channel": int(np.argmax(energy)),
            "channel_energy_db": (10 * np.log10(
                np.maximum(energy, 1e-30))).round(2).tolist(),
            "demod_syms": syms.cpu().tolist(),
            "xcorr_path": path,
            "xcorr_path_reason": reason,
            "wola_path": wpath,
            "wola_path_reason": wreason,
            "kernel_launches": {
                "wola_fused": wola_fused.launches - launches0[0],
                "caf_peak": caf_peak.launches - launches0[1],
            },
            "config": {
                "num_channels": self.num_channels,
                "num_taps": self.num_taps,
                "template_len": self.template_len,
                "num_shifts": self.num_shifts,
                "osr": self.osr, "m": self.m,
            },
        }

    def example_inputs(self, seed: int = 0):
        """(template_ri, rx_ri) float32 tensors on the module's device, the
        JAX receiver's example: a QPSK template planted as an impulse train
        on the channel-1 tone at shift ~ num_shifts//2, in noise."""
        rng = np.random.default_rng(seed)
        n_wide = (self.num_shifts + self.template_len
                  + self.demod_syms * self.osr + self.num_taps // self.dec
                  + 8) * self.dec
        syms = np.exp(1j * (np.pi / 2) * rng.integers(0, 4, self.template_len))
        rx = (rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide))
        rx *= 0.1
        k = 1
        t = np.arange(n_wide)
        start = (self.num_shifts // 2 + self.num_taps // self.dec) * self.dec
        up = np.zeros(n_wide, dtype=complex)
        up[start: start + self.template_len * self.dec: self.dec] = syms
        rx = rx + up * np.exp(1j * 2 * np.pi * (k / self.num_channels) * t)
        template_ri = np.stack([syms.real, syms.imag]).astype(np.float32)
        rx_ri = np.stack([rx.real, rx.imag]).astype(np.float32)
        dev = self.f_tap.device
        return (torch.from_numpy(template_ri).to(dev),
                torch.from_numpy(rx_ri).to(dev))
