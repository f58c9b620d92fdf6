"""Synthetic signal creation (reference signalCreationRoutines: randBits,
symsFromBits, randPSKsyms, randnoise, addSigToNoise, addManySigToNoise,
makeCPFSKsyms, makePulsedCPFSKsyms, propagateSignal, propagateSignalExact).

PyTorch counterpart of the JAX package's ``signal/creation.py``. The random
generators take an explicit ``torch.Generator`` where the JAX functions take
a PRNG key: they draw on the generator's device (a CUDA generator draws on
the card) and return tensors on ``device``, which is the card unless the
caller names another (``utils.device.resolve_device``). The same generator
state gives the same output; torch cannot replay a JAX key, so the tests
hold the random functions by shape, range and noise power. The deterministic
functions take tensors and follow their device. No TPU kernel lies on this
path: everything is plain torch, and the one matrix product
(``propagate_signal_exact``) runs in full f32 (``utils.dtypes.full_f32``).
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import (full_f32, real_dtype_for,
                                                  to_tensor)
from pydsproutines_tpu_torch.utils.freq import make_freq, tone

# Constellations indexed by symbol value (the reference's orderings)
_SQ2 = 1.0 / np.sqrt(2.0)
PSK_CONSTELLATIONS = {
    2: np.array([1, -1], dtype=np.complex128),
    4: np.array([1, 1j, -1, -1j], dtype=np.complex128),
    8: np.array(
        [1, (1 + 1j) * _SQ2, 1j, (-1 + 1j) * _SQ2,
         -1, (-1 - 1j) * _SQ2, -1j, (1 - 1j) * _SQ2],
        dtype=np.complex128,
    ),
}


def _place(length: int, signal: torch.Tensor, start: int) -> torch.Tensor:
    """zeros(length) with ``signal`` written from ``start``, the start
    clamped to [0, length - len(signal)] so that the signal fits, as
    ``jax.lax.dynamic_update_slice`` clamps it."""
    m = signal.shape[-1]
    if m > length:
        raise ValueError(f"a signal of {m} samples does not fit in "
                         f"{length}")
    start = min(max(int(start), 0), length - m)
    out = torch.zeros(length, dtype=signal.dtype, device=signal.device)
    out[start: start + m] = signal
    return out


def rand_bits(gen: torch.Generator, length: int, m: int,
              device=None) -> torch.Tensor:
    """Random symbols in [0, m) as uint8 (reference randBits)."""
    bits = torch.randint(0, m, (length,), generator=gen, dtype=torch.uint8,
                         device=gen.device)
    return bits.to(resolve_device(device))


def syms_from_bits(bits: torch.Tensor, m: int,
                   dtype: torch.dtype = torch.complex64) -> torch.Tensor:
    """Map integer symbol values to PSK constellation points, on the bits'
    device."""
    const = torch.from_numpy(PSK_CONSTELLATIONS[m]).to(bits.device, dtype)
    return const[bits.long()]


def rand_psk_syms(gen: torch.Generator, length: int, m: int,
                  dtype: torch.dtype = torch.complex64, device=None):
    """Random m-ary PSK symbols. Returns (syms, bits)."""
    bits = rand_bits(gen, length, m, device)
    return syms_from_bits(bits, m, dtype), bits


def randnoise(gen: torch.Generator, length: int, bw_signal: float,
              chn_bw: float, snr_inband_linear: float, sig_pwr: float = 1.0,
              dtype: torch.dtype = torch.complex64,
              device=None) -> torch.Tensor:
    """Complex AWGN calibrated so a signal of power ``sig_pwr`` and bandwidth
    ``bw_signal`` in a channel of bandwidth ``chn_bw`` sees the requested
    in-band SNR (reference randnoise)."""
    rdt = real_dtype_for(dtype)
    ri = torch.randn((2, length), generator=gen, dtype=rdt,
                     device=gen.device).to(resolve_device(device))
    basic = torch.complex(ri[0], ri[1]) / np.sqrt(2.0)
    scale = (np.sqrt(sig_pwr) * np.sqrt(1.0 / snr_inband_linear)
             * np.sqrt(chn_bw / bw_signal))
    return (basic * scale).to(dtype)


def add_sig_to_noise(gen: torch.Generator, signal,
                     noise_len: int | None = None,
                     sig_start_idx: int = 0, bw_signal: float = 1.0,
                     chn_bw: float = 1.0, snr_inband_linear: float = np.inf,
                     sig_pwr: float = 1.0, fshift: float | None = None,
                     device=None):
    """Place ``signal`` into a noisy background at ``sig_start_idx`` with an
    optional frequency shift (reference addSigToNoise). A start past
    ``noise_len - len(signal)`` is clamped so the signal fits, as in the JAX
    package. Returns (noise, rx) or (noise, rx, tone) when ``fshift`` is
    given."""
    dev = resolve_device(device)
    signal = to_tensor(signal, dev)
    if noise_len is None:
        noise_len = signal.shape[-1]
    if np.isinf(snr_inband_linear):
        noise = torch.zeros(noise_len, dtype=signal.dtype, device=dev)
    else:
        noise = randnoise(gen, noise_len, bw_signal, chn_bw,
                          snr_inband_linear, sig_pwr, dtype=signal.dtype,
                          device=dev)
    rx = _place(noise_len, signal, sig_start_idx) + noise
    if fshift is not None:
        t = tone(noise_len, fshift, chn_bw, dtype=signal.dtype, device=dev)
        return noise, rx * t, t
    return noise, rx


def add_many_sig_to_noise(gen: torch.Generator, noise_len: int,
                          sig_start_idx_list, signal_list, bw_signal: float,
                          chn_bw: float, snr_inband_linear_list,
                          fshifts=None, device=None):
    """Sum many scaled signal copies into one calibrated noise floor
    (reference addManySigToNoise). Signals are assumed unit power; relative
    SNRs are produced by amplitude scaling against the first SNR in the
    list. Returns (noise, rx)."""
    dev = resolve_device(device)
    snrs = list(snr_inband_linear_list)
    signals = [to_tensor(s, dev) for s in signal_list]
    noise = randnoise(gen, noise_len, bw_signal, chn_bw, snrs[0], 1.0,
                      dtype=signals[0].dtype, device=dev)
    rx = torch.zeros(noise_len, dtype=noise.dtype, device=dev)
    for i, (start, sig) in enumerate(zip(sig_start_idx_list, signals)):
        scaled = (sig * np.sqrt(snrs[i] / snrs[0])).to(noise.dtype)
        row = _place(noise_len, scaled, start)
        if fshifts is not None:
            row = row * tone(noise_len, fshifts[i], chn_bw, dtype=noise.dtype,
                             device=dev)
        rx = rx + row
    return noise, rx + noise


def make_cpfsk_syms(bits: torch.Tensor, baud: float, m: int = 2,
                    h: float = 0.5, up: int = 8, phase: float = 0.0,
                    dtype: torch.dtype = torch.complex64):
    """CPFSK with a rectangular pulse of length one symbol (reference
    makeCPFSKsyms), on the bits' device. Returns (sig, fs, data) with
    data = bits*m - 1 in int8, as in the JAX package: that is the ±1
    alphabet only for m = 2."""
    rdt = real_dtype_for(dtype)
    dev = bits.device
    T = 1.0 / baud
    fs = baud * up
    nbits = bits.shape[0]
    data = bits.to(torch.int8) * m - 1

    n = torch.arange(nbits * up, device=dev)
    i_list = n // up
    t_list = n.to(rdt) / fs
    # phase accumulator: cumulative sum of the previous symbols
    accum = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                       torch.cumsum(data.to(torch.int32), 0,
                                    dtype=torch.int32)])[:nbits]
    a_list = torch.repeat_interleave(accum, up).to(rdt)

    theta = (data[i_list].to(rdt) * (np.pi * h)
             * (t_list - i_list.to(rdt) * T) / T
             + np.pi * h * a_list + phase)
    return torch.exp(1j * theta).to(dtype), fs, data


def make_pulsed_cpfsk_syms(bits: torch.Tensor, baud: float, g=None,
                           m: int = 2, h: float = 0.5, up: int = 8,
                           phase: float = 0.0,
                           dtype: torch.dtype = torch.complex64):
    """CPFSK with an arbitrary phase pulse ``g`` applied by a full
    convolution before phase accumulation (reference makePulsedCPFSKsyms),
    on the bits' device. Returns (sig, fs, data, css) with the full
    convolution's length, as in the reference.

    The convolution is explicit shifted sums over the pulse's taps, so no
    cuDNN convolution (TF32 by default on the card) runs."""
    rdt = real_dtype_for(dtype)
    dev = bits.device
    if g is None:
        g = torch.ones(up, dtype=rdt, device=dev) / (2 * up)
    g = to_tensor(g, dev).to(rdt)
    fs = baud * up
    data = bits.to(torch.int8) * m - 1

    theta = torch.zeros(bits.shape[0] * up + 1, dtype=rdt, device=dev)
    theta[1::up] = data.to(rdt)
    c = torch.zeros(theta.shape[0] + g.shape[0] - 1, dtype=rdt, device=dev)
    for j in range(g.shape[0]):
        c[j: j + theta.shape[0]] += g[j] * theta
    cs = torch.cumsum(c, 0)
    css = cs * (2 * np.pi * h) + phase
    return torch.exp(1j * css).to(dtype), fs, data, css


def propagate_signal(sig: torch.Tensor, time, fs: float,
                     freq: float | None = None):
    """Sub-sample time shift by an FFT phase ramp, with an optional
    frequency shift (reference propagateSignal), on sig's device.

    ``sig`` may be 1-D or 2-D (rows shifted independently); ``time`` is a
    scalar or a per-row array of shifts in seconds. A scalar ``time`` gives
    a row, not a (1, N) array. Returns the shifted signal, or (shifted*tone,
    tone) when ``freq`` is given."""
    scalar = np.ndim(time) == 0
    sig = torch.atleast_2d(sig)
    dev = sig.device
    t = to_tensor(np.asarray(time, dtype=np.float64)
                  if not isinstance(time, torch.Tensor) else time, dev)
    t = torch.atleast_1d(t)
    n = sig.shape[-1]
    rdt = real_dtype_for(sig.dtype)
    sigfft = torch.fft.fft(sig, dim=-1)
    f = make_freq(n, fs, dtype=rdt, device=dev)
    phase = -2 * np.pi * f[None, :] * t[:, None]
    mat = torch.exp(1j * phase).to(sigfft.dtype)
    result = torch.fft.ifft(mat * sigfft, dim=-1).to(sig.dtype)
    if result.shape[0] == 1 and scalar:
        result = result[0]
    if freq is None:
        return result
    tn = tone(n, freq, fs, dtype=sig.dtype, device=dev)
    return result * tn, tn


def propagate_signal_exact(sig: torch.Tensor, tau, fs: float,
                           f_c: float = 0.0) -> torch.Tensor:
    """Exact per-sample delay resampling by the DFT interpolation formula
    (reference propagateSignalExact), as one (N, N) matrix product in full
    f32 on sig's device: result[n] = (1/N) sum_k exp(1j*2*pi*(n/fs -
    tau[n])*f_k) X[k], times the carrier exp(-1j*2*pi*f_c*tau) formed in
    tau's dtype. The phase is the JAX package's, in sig's real dtype."""
    n = sig.shape[-1]
    rdt = real_dtype_for(sig.dtype)
    tau = to_tensor(tau, sig.device)
    fftsig = torch.fft.fft(sig)
    f = make_freq(n, fs, dtype=rdt, device=sig.device)
    # n / fs divided in float64 and rounded once: a CUDA tensor divided by
    # a scalar is multiplied by its reciprocal, one float32 ulp off, which
    # at N = 8192, fs = 1 MHz moves the basis phase (~2.5e4 rad) by ~3e-3
    t_n = (torch.arange(n, dtype=torch.float64, device=sig.device)
           / fs).to(rdt)
    ntau = t_n - tau.to(rdt)
    basis = torch.exp(1j * (2 * np.pi * ntau)[:, None] * f[None, :]).to(
        fftsig.dtype)
    with full_f32():
        result = (basis @ fftsig) / n
    carrier = torch.exp(-1j * (2 * np.pi * f_c) * tau).to(fftsig.dtype)
    return (result * carrier).to(sig.dtype)
