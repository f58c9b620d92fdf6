"""Frequency-scanning cross-correlation / CAF peak search.

PyTorch counterpart of ``pydsproutines_tpu/ops/xcorr.py`` for the peak
search ``fast_xcorr(freqsearch=True)`` with |.|^2 peaks and no CAF output:
for each shift s, the bin k maximising |DFT(rx[s:s+n] * conj(cutout))[k]|^2
and its QF^2 = |peak|^2 / ||rx[s:s+n]||^2 / ||cutout||^2, a normalized 0..1
correlation power.

``select_xcorr_path`` makes the routing decision and says why:

  "fused-hopper"  the Hopper CAF kernel (ops/hopper/fused_xcorr.py), for
                  every uniform-step complex64 sweep on a CUDA tensor whose
                  n has a two-factor split;
  "plain"         torch.fft over gathered windows (CPU tensors, non-uniform
                  shifts, other dtypes, n with no split).

The kernel computes in f32 throughout, so the JAX package's bf16 sweep and
its f32 re-verify of the winning peak have no counterpart here. Window
energies come from one float64 prefix sum of |rx|^2: one pass over rx for
any number of shifts, and float64 keeps the running-sum error far below the
f32 result's rounding at any capture length, so no window/length gate is
needed. Bins are returned as int64.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.fft import best_two_factor
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import caf_peak
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for


def _abs_sq(x: torch.Tensor) -> torch.Tensor:
    return x.real * x.real + x.imag * x.imag


def gather_shift_slices(rx: torch.Tensor, shifts: torch.Tensor, n: int,
                        step: int | None = None) -> torch.Tensor:
    """rx[s:s+n] for each s in shifts as a (len(shifts), n) matrix. A uniform
    ``step`` makes it a strided view with no copy."""
    if step is not None:
        s0 = int(shifts[0])
        return rx.as_strided((shifts.shape[0], n), (step * rx.stride(0),
                                                    rx.stride(0)),
                             rx.storage_offset() + s0 * rx.stride(0))
    idx = shifts[:, None] + torch.arange(n, device=rx.device)[None, :]
    return rx[idx]


def argmax_and_max_last(m: torch.Tensor):
    """(argmax, max) over the last axis; ties go to the first occurrence."""
    i = torch.argmax(m, dim=-1)
    return i, torch.gather(m, -1, i[..., None])[..., 0]


def _uniform_step(shifts) -> int | None:
    """The stride of a host-visible arithmetic progression of shifts, or
    None when the shifts are not one. A single shift counts as step 1."""
    s = shifts.cpu().numpy() if isinstance(shifts, torch.Tensor) \
        else np.asarray(shifts)
    if s.ndim != 1 or s.size < 2 or not np.issubdtype(s.dtype, np.integer):
        return None if s.size > 1 else 1
    d = np.diff(s)
    if np.all(d == d[0]) and d[0] > 0:
        return int(d[0])
    return None


def select_xcorr_path(n: int, dtype: torch.dtype, step: int | None,
                      device) -> tuple[str, str]:
    """The routing decision of ``fast_xcorr``: (path, reason)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "plain", f"{device.type} tensor: plain torch.fft twin"
    if dtype != torch.complex64:
        return "plain", f"dtype {dtype}: the Hopper CAF kernel takes complex64"
    if step is None:
        return "plain", "shifts are not a uniform progression"
    split = best_two_factor(n)
    if split is None:
        return "plain", f"n={n} has no two-factor split"
    reason = (f"uniform step {step}, n={n}={split[0]}x{split[1]}: Hopper CAF "
              f"kernel, f32 throughout (no bf16 sweep, no peak re-verify)")
    if n < 4096:
        reason += (f"; the TPU kernel's n >= 4096 VMEM gate does not apply, "
                   f"so this n={n} sweep runs the kernel")
    return "fused-hopper", reason


def peak_search_plain(rx: torch.Tensor, cutout_conj: torch.Tensor,
                      shifts: torch.Tensor, batch_size: int,
                      step: int | None = None):
    """torch.fft peak search: (max_k |X_s[k]|^2, int64 argmax) per shift, in
    chunks of ``batch_size`` shifts."""
    n = cutout_conj.shape[-1]
    maxv, bins = [], []
    for c0 in range(0, shifts.shape[0], batch_size):
        chunk = shifts[c0: c0 + batch_size]
        spec = torch.fft.fft(gather_shift_slices(rx, chunk, n, step)
                             * cutout_conj, dim=-1)
        i, m = argmax_and_max_last(_abs_sq(spec))
        maxv.append(m)
        bins.append(i)
    return torch.cat(maxv), torch.cat(bins)


def _fast_xcorr_impl(cutout: torch.Tensor, rx: torch.Tensor,
                     shifts: torch.Tensor, *, n: int, batch_size: int,
                     step: int | None = None):
    """(QF^2, int64 peak bin) per shift; the routed core of fast_xcorr."""
    path, _ = select_xcorr_path(n, cutout.dtype, step, rx.device)
    cutout_conj = cutout.conj().resolve_conj().contiguous()
    cutout_norm_sq = _abs_sq(cutout).sum(dtype=torch.float64)
    power = torch.cat([rx.new_zeros(1, dtype=torch.float64),
                       torch.cumsum(_abs_sq(rx).double(), 0)])
    rx_norm_sq = power[shifts + n] - power[shifts]
    if path == "fused-hopper":
        maxv, bins = caf_peak(rx.contiguous(), cutout_conj, int(shifts[0]),
                              step, shifts.shape[0], batch_size)
    else:
        maxv, bins = peak_search_plain(rx, cutout_conj, shifts, batch_size,
                                       step)
    qf2 = maxv.double() / cutout_norm_sq / rx_norm_sq
    return qf2.to(real_dtype_for(rx.dtype)), bins


def fast_xcorr(cutout: torch.Tensor, rx: torch.Tensor,
               freqsearch: bool = True, shifts=None, batch_size: int = 128,
               step: int | None = None):
    """Sliding-window normalized xcorr with a per-shift frequency scan
    (reference fastXcorr). Returns (QF^2 per shift, int64 peak-frequency bin
    per shift).

    Only the frequency-scanning peak search is ported (``freqsearch=True``,
    |.|^2 peaks, no CAF output). ``shifts`` defaults to every full-overlap
    shift; ``step`` declares their uniform stride (detected from host-visible
    shifts when None). ``batch_size`` is the number of shifts per chunk.
    """
    if not freqsearch:
        raise NotImplementedError("the port covers the frequency-scanning "
                                  "peak search only (freqsearch=True)")
    n = cutout.shape[-1]
    if n > rx.shape[-1]:
        raise ValueError(f"cutout (len {n}) is longer than rx "
                         f"(len {rx.shape[-1]})")
    if shifts is None:
        shifts = torch.arange(rx.shape[-1] - n + 1, device=rx.device)
        step = 1
    if step is None:
        step = _uniform_step(shifts)
    shifts = torch.as_tensor(shifts, dtype=torch.int64, device=rx.device)
    if shifts.shape[0] == 0:
        raise ValueError("shifts must be non-empty")
    if int(shifts.min()) < 0 or int(shifts.max()) + n > rx.shape[-1]:
        raise ValueError(f"shifts [{int(shifts.min())}, {int(shifts.max())}] "
                         f"+ cutout length {n} exceed rx length "
                         f"{rx.shape[-1]}")
    batch_size = int(min(batch_size, shifts.shape[0]))
    return _fast_xcorr_impl(cutout, rx, shifts, n=n, batch_size=batch_size,
                            step=step)


def calc_qf2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """QF^2 of two aligned equal-length arrays; row-wise for 2-D inputs
    (reference calcQF2)."""
    if x.ndim == 1:
        return _abs_sq(torch.vdot(x, y)) / _abs_sq(x).sum() / _abs_sq(y).sum()
    return (_abs_sq(torch.sum(x * torch.conj(y), dim=1))
            / _abs_sq(x).sum(dim=1) / _abs_sq(y).sum(dim=1))


def convert_qf2_to_eff_snr(qf2):
    """For xcorr of two noisy signals."""
    return 2.0 * qf2 / (1.0 - qf2)
