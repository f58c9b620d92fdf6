"""Sliding-window cross-correlation and frequency-scanning CAF peak search.

PyTorch counterpart of ``pydsproutines_tpu/ops/xcorr.py``'s ``fast_xcorr``,
with the JAX signature, defaults and modes:

  no frequency search   QF^2 of the sliding dot product per shift (or the
                        complex normalized QF with ``abs_result=False``);
  peak search           (QF^2, bin) of each shift's spectrum peak
                        (``freqsearch=True``): |peak|^2 / ||rx[s:s+n]||^2 /
                        ||cutout||^2, a normalized 0..1 correlation power,
                        or the complex normalized peak (``abs_result=False``);
  full CAF              the normalized (shifts, n) spectrum
                        (``output_caf=True``).

``select_xcorr_path`` makes the routing decision and says why:

  "dot"                 no frequency search: plain torch sliding dot
                        products (the TPU ran no kernel here either);
  "caf"                 full CAF output: plain torch.fft, no peak fusion;
  "fused3-hopper"       the three-stage Hopper CAF kernel
                        (ops/hopper/fused_caf3.py) for n >= 2^21 with a
                        factor triple, uniform shifts or a shift list;
  "fused-hopper"        the two-stage Hopper CAF kernel
                        (ops/hopper/fused_xcorr.py) for a uniform sweep of
                        any other n with a two-factor split;
  "peak-kernel-hopper"  a shift list over a two-factor split: stage 1 read
                        through the per-shift offsets, then the Hopper
                        last-stage peak kernel (ops/hopper/fft_peak.py);
  "plain"               torch.fft over gathered windows (CPU tensors, other
                        dtypes, complex peaks, n with no split).

The kernels compute in f32 throughout, so the JAX package's bf16 sweep and
its f32 re-verify of the winning peak have no counterpart here; ``precision``
is accepted for the JAX signature and ignored. Window energies come from one
float64 prefix sum of |rx|^2: one pass over rx for any number of shifts, and
float64 keeps the running-sum error far below the f32 result's rounding at
any capture length, so no window/length gate is needed. Every route
processes shifts in chunks bounded by a byte budget (``utils.memory``).
Bins are returned as int64; ties go to the lowest bin.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.fft import (best_two_factor, fft_factors,
                                             find_triple)
from pydsproutines_tpu_torch.ops.hopper.fft_peak import peak_sweep
from pydsproutines_tpu_torch.ops.hopper.fused_caf3 import caf3_peak
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import caf_peak
from pydsproutines_tpu_torch.utils.dtypes import real_dtype_for
from pydsproutines_tpu_torch.utils.memory import chunk_shifts

# n from which a sweep with a factor triple takes the three-stage kernel
# (the JAX package's "fused3" gate, ops/xcorr.py:212)
BIG_N = 1 << 21
# plain routes' working set per (shift, sample): the gathered window, the
# modulated product and its spectrum (complex64), and |.|^2 (float32)
PLAIN_BYTES_PER_SAMPLE = 32
# the dot mode's: the gathered window and its product with the cutout
DOT_BYTES_PER_SAMPLE = 16


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
                      device, freqsearch: bool = True,
                      output_caf: bool = False,
                      abs_result: bool = True) -> tuple[str, str]:
    """The routing decision of ``fast_xcorr``: (path, reason)."""
    if not freqsearch:
        return "dot", "freqsearch=False: sliding dot products (plain torch)"
    if output_caf:
        return "caf", "full CAF output requested: plain torch.fft, no peak " \
                      "fusion possible"
    device = torch.device(device)
    if device.type != "cuda":
        return "plain", f"{device.type} tensor: plain torch.fft twin"
    if not abs_result:
        return "plain", "abs_result=False keeps complex peaks (no |.|^2 " \
                        "fusion)"
    if dtype != torch.complex64:
        return "plain", f"dtype {dtype}: the Hopper CAF kernels take complex64"
    sweep = (f"uniform step {step}" if step is not None
             else "non-uniform shift list")
    f32 = "f32 throughout (no bf16 sweep, no peak re-verify)"
    note = ""
    if n >= BIG_N:
        triple = find_triple(n)
        if triple is not None:
            f0, f1, f2 = triple
            return "fused3-hopper", (
                f"{sweep}, n={n}={f0}x{f1}x{f2} >= 2^21: three-stage Hopper "
                f"CAF kernel, {f32}; factors in [16, 1024] with no TPU lane "
                f"rule (f2 % 128), minimising f0+f1+f2")
        note = f"; n={n} has no factor triple in [16, 1024]"
    split = best_two_factor(n)
    if split is None:
        return "plain", f"n={n} has no two-factor split{note}"
    n1, n2 = split
    if step is not None:
        reason = (f"{sweep}, n={n}={n1}x{n2}: Hopper CAF kernel, {f32}"
                  f"{note}")
        if n < 4096:
            reason += (f"; the TPU kernel's n >= 4096 VMEM gate does not "
                       f"apply, so this n={n} sweep runs the kernel")
        return "fused-hopper", reason
    reason = (f"{sweep}, n={n}={n1}x{n2}: stage 1 over per-shift offsets, "
              f"then the Hopper last-stage peak kernel, {f32}{note}")
    plan = fft_factors(n)
    if plan is not None and plan != [n1, n2]:
        reason += f"; the JAX plan {plan} becomes this two-factor split"
    return "peak-kernel-hopper", reason


def _windows(rx, shifts, n, batch_size, step, bytes_per_sample):
    """The sweep's windows rx[s:s+n] as (chunk, n) matrices, chunk sizes
    within the byte budget."""
    m = chunk_shifts(n, batch_size, bytes_per_sample)
    for c0 in range(0, shifts.shape[0], m):
        yield gather_shift_slices(rx, shifts[c0: c0 + m], n, step)


def _complex_peaks_plain(rx, cutout_conj, shifts, batch_size, step):
    """(X_s[k*], int64 k*) per shift, k* the |X_s|^2 argmax (lowest on
    ties), by torch.fft in chunks within the byte budget."""
    n = cutout_conj.shape[-1]
    vals, bins = [], []
    for w in _windows(rx, shifts, n, batch_size, step,
                      PLAIN_BYTES_PER_SAMPLE):
        spec = torch.fft.fft(w * cutout_conj, dim=-1)
        i = torch.argmax(_abs_sq(spec), dim=-1)
        vals.append(torch.gather(spec, -1, i[:, None])[:, 0])
        bins.append(i)
    return torch.cat(vals), torch.cat(bins)


def peak_search_plain(rx: torch.Tensor, cutout_conj: torch.Tensor,
                      shifts: torch.Tensor, batch_size: int,
                      step: int | None = None):
    """torch.fft peak search: (max_k |X_s[k]|^2, int64 argmax) per shift, in
    chunks of at most ``batch_size`` shifts within the byte budget."""
    peak, bins = _complex_peaks_plain(rx, cutout_conj, shifts, batch_size,
                                      step)
    return _abs_sq(peak), bins


def _fast_xcorr_impl(cutout: torch.Tensor, rx: torch.Tensor,
                     shifts: torch.Tensor, *, n: int, batch_size: int,
                     step: int | None = None, freqsearch: bool = True,
                     output_caf: bool = False, abs_result: bool = True):
    """The routed core of fast_xcorr; returns what fast_xcorr returns."""
    path, _ = select_xcorr_path(n, cutout.dtype, step, rx.device,
                                freqsearch, output_caf, abs_result)
    rdt = real_dtype_for(rx.dtype)
    cutout_conj = cutout.conj().resolve_conj().contiguous()
    cutout_norm_sq = _abs_sq(cutout).sum(dtype=torch.float64)
    power = torch.cat([rx.new_zeros(1, dtype=torch.float64),
                       torch.cumsum(_abs_sq(rx).double(), 0)])
    rx_norm_sq = power[shifts + n] - power[shifts]
    norm = torch.sqrt(cutout_norm_sq * rx_norm_sq)
    if path == "dot":
        # vdot semantics: sum(conj(rx_slice) * cutout)
        prod = torch.cat([torch.sum(w.conj() * cutout, dim=-1) for w in
                          _windows(rx, shifts, n, batch_size, step,
                                   DOT_BYTES_PER_SAMPLE)])
        if abs_result:
            return (_abs_sq(prod).double() / cutout_norm_sq
                    / rx_norm_sq).to(rdt)
        return prod / norm.to(rdt)
    if path == "caf":
        spec = torch.cat([torch.fft.fft(w * cutout_conj, dim=-1) for w in
                          _windows(rx, shifts, n, batch_size, step,
                                   PLAIN_BYTES_PER_SAMPLE)])
        if abs_result:
            return (_abs_sq(spec).double()
                    / (cutout_norm_sq * rx_norm_sq)[:, None]).to(rdt)
        return spec / norm.to(rdt)[:, None]
    if not abs_result:
        peak, bins = _complex_peaks_plain(rx, cutout_conj, shifts, batch_size,
                                          step)
        return peak / norm.to(rdt), bins
    if path == "fused3-hopper":
        maxv, bins = caf3_peak(rx.contiguous(), cutout_conj, shifts,
                               batch_size)
    elif path == "fused-hopper":
        maxv, bins = caf_peak(rx.contiguous(), cutout_conj, int(shifts[0]),
                              step, shifts.shape[0], batch_size)
    elif path == "peak-kernel-hopper":
        maxv, bins = peak_sweep(rx.contiguous(), cutout_conj, shifts,
                                batch_size)
    else:
        maxv, bins = peak_search_plain(rx, cutout_conj, shifts, batch_size,
                                       step)
    qf2 = maxv.double() / cutout_norm_sq / rx_norm_sq
    return qf2.to(rdt), bins


def fast_xcorr(cutout: torch.Tensor, rx: torch.Tensor,
               freqsearch: bool = False, output_caf: bool = False,
               shifts=None, abs_result: bool = True, batch_size: int = 128,
               precision: str | None = None, step: int | None = None):
    """Sliding-window normalized xcorr with an optional per-shift frequency
    scan (reference fastXcorr), with the JAX package's signature. Returns:

      * no freqsearch: QF^2 per shift (complex QF when ``abs_result=False``);
      * freqsearch, no CAF: (QF^2 per shift, int64 peak-frequency bin per
        shift), or (complex normalized peak, bin) with ``abs_result=False``;
      * freqsearch + output_caf: the full (num_shifts, len(cutout)) CAF.

    ``shifts`` defaults to every full-overlap shift; ``step`` declares their
    uniform stride (detected from host-visible shifts when None).
    ``batch_size`` caps the shifts per chunk (chunks are also bounded by a
    byte budget). ``precision`` selects the TPU's matrix precision in the
    JAX package; the port computes in f32 throughout and ignores it.
    """
    del precision  # f32 throughout; see the module docstring
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
                            step=step, freqsearch=bool(freqsearch),
                            output_caf=bool(output_caf),
                            abs_result=bool(abs_result))


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
