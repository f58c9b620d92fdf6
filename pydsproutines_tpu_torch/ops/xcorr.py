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
  "fused3-hopper"       the Hopper CAF kernel over a shift list
                        (ops/hopper/fused_caf3.py) for n >= 2^21 with a
                        factor triple (the JAX "fused3" gate), uniform
                        shifts or a list; and for a shift list whose
                        shared-memory FFT plan is not two passes (a window
                        that fits one block, or a three-pass plan);
  "fused-hopper"        the Hopper CAF kernel over a uniform sweep
                        (ops/hopper/fused_xcorr.py) for any other n with a
                        two-factor split;
  "peak-kernel-hopper"  a shift list under a two-pass plan n = n1*n2: the
                        shared-memory column pass read through the per-shift
                        offsets, then the Hopper last-stage peak kernel
                        (ops/hopper/fft_peak.py: twiddle on load, row FFT,
                        row peaks);
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

The rest of the TDOA refinement chain (``fast_xcorr`` -> ``czt_xcorr`` ->
``fine_freq_time_search``), ``GenXcorr`` and the QF^2/SNR conversions and
Stein bounds follow; they run no TPU kernel and are plain torch (products in
full f32) or host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.fft import (best_two_factor, caf_plan,
                                             fft_factors, find_triple)
from pydsproutines_tpu_torch.ops.hopper.fft_peak import peak_sweep
from pydsproutines_tpu_torch.ops.hopper.fused_caf3 import caf3_peak
from pydsproutines_tpu_torch.ops.hopper.fused_xcorr import caf_peak
from pydsproutines_tpu_torch.ops.spectral import get_czt_plan
from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import full_f32, real_dtype_for
from pydsproutines_tpu_torch.utils.fftlen import next_fast_len
from pydsproutines_tpu_torch.utils.freq import make_freq
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


def power_prefix(rx: torch.Tensor) -> torch.Tensor:
    """P with P[i] = sum_{j < i} |rx[j]|^2 in float64 (P[0] = 0): the
    energy of rx[s:s+n] is P[s+n] - P[s], for any number of windows from
    one pass over rx."""
    return torch.cat([rx.new_zeros(1, dtype=torch.float64),
                      torch.cumsum(_abs_sq(rx).double(), 0)])


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


def _fft_passes(n: int) -> str:
    """How the CAF kernels' shared-memory FFT runs an n-point window."""
    f = caf_plan(n)["factors"]
    if len(f) == 1:
        return f"one-pass shared-memory FFT of n={n} per block"
    return (f"shared-memory FFT in {len(f)} passes of "
            f"{'x'.join(map(str, f))} over a scratch")


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
                f"{sweep}, n={n}={f0}x{f1}x{f2} >= 2^21 (the JAX three-stage "
                f"gate, factors in [16, 1024] with no TPU lane rule): Hopper "
                f"CAF kernel over the shift offsets, {_fft_passes(n)}, {f32}")
        note = f"; n={n} has no factor triple in [16, 1024]"
    if best_two_factor(n) is None:
        return "plain", f"n={n} has no two-factor split{note}"
    if step is not None:
        reason = (f"{sweep}, n={n}: Hopper CAF kernel, {_fft_passes(n)}, "
                  f"{f32}{note}")
        if n < 4096:
            reason += (f"; the TPU kernel's n >= 4096 VMEM gate does not "
                       f"apply, so this n={n} sweep runs the kernel")
        return "fused-hopper", reason
    passes = caf_plan(n)["factors"]
    if len(passes) != 2:
        return "fused3-hopper", (
            f"{sweep}, n={n}: {_fft_passes(n)}, not the two passes the "
            f"last-stage peak kernel's route takes, so the Hopper CAF kernel "
            f"over the shift offsets runs it whole, {f32}{note}")
    n1, n2 = passes
    reason = (f"{sweep}, n={n}={n1}x{n2}: shared-memory column FFTs over "
              f"per-shift offsets, then the Hopper last-stage peak kernel "
              f"(twiddle on load, {n2}-point row FFTs, row peaks), "
              f"{f32}{note}")
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
    power = power_prefix(rx)
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


# ---------------------------------------------------------------------------
# czt_xcorr: frequency scan on an arbitrary CZT grid
# ---------------------------------------------------------------------------

def czt_xcorr(cutout: torch.Tensor, rx: torch.Tensor, f_search_min: float,
              f_search_max: float, fs: float, czt_step: float = 0.1,
              output_caf: bool = False, shifts=None, batch_size: int = 128):
    """Sliding xcorr with a CZT fine-frequency scan (reference cztXcorr).

    Returns (caf, f_search) when ``output_caf`` (the (shifts, k) QF^2 grid
    and the scan frequencies) else (complex normalized peak, peak frequency
    in Hz) per shift. The CZT is the plan of ``ops/spectral`` on rx's
    device; window energies come from the float64 prefix sum."""
    n = cutout.shape[-1]
    if n > rx.shape[-1]:
        raise ValueError(f"cutout (len {n}) is longer than rx "
                         f"(len {rx.shape[-1]})")
    plan = get_czt_plan(n, float(f_search_min), float(f_search_max),
                        float(czt_step), float(fs), cutout.dtype,
                        str(rx.device))
    rdt = real_dtype_for(cutout.dtype)
    f_search = torch.from_numpy(plan.freqs()).to(rx.device, rdt)
    if shifts is None:
        shifts = torch.arange(rx.shape[-1] - n + 1, device=rx.device)
    shifts = torch.as_tensor(shifts, dtype=torch.int64, device=rx.device)
    if shifts.shape[0] == 0:
        raise ValueError("shifts must be non-empty")
    if int(shifts.min()) < 0 or int(shifts.max()) + n > rx.shape[-1]:
        raise ValueError("a shift's window runs past rx")
    rx = rx.to(cutout.dtype)
    cutout_norm_sq = _abs_sq(cutout).sum(dtype=torch.float64)
    power = power_prefix(rx)
    rx_norm_sq = power[shifts + n] - power[shifts]
    cutout_conj = cutout.conj()
    rows = [plan(w * cutout_conj) for w in _windows(
        rx, shifts, n, min(batch_size, shifts.shape[0]), None,
        PLAIN_BYTES_PER_SAMPLE)]
    spec = torch.cat(rows)
    mag = _abs_sq(spec)
    if output_caf:
        return (mag.double() / (rx_norm_sq[:, None] * cutout_norm_sq)).to(
            rdt), f_search
    mi = torch.argmax(mag, dim=-1)
    peak = torch.gather(spec, -1, mi[:, None])[:, 0]
    norm = torch.sqrt(rx_norm_sq * cutout_norm_sq).to(rdt)
    return peak / norm, f_search[mi]


# ---------------------------------------------------------------------------
# Fine time/frequency refinement
# ---------------------------------------------------------------------------

def make_time_scan_steervec(td_scan_range, fs: float, siglen: int,
                            dtype: torch.dtype = torch.complex64
                            ) -> torch.Tensor:
    """Steering-vector matrix exp(1j*2*pi*f*td) over the FFT frequency axis
    (reference makeTimeScanSteervec), on the scan range's device."""
    rdt = real_dtype_for(dtype)
    td = torch.as_tensor(td_scan_range).to(rdt)
    f = make_freq(siglen, fs, dtype=rdt, device=td.device)
    phase = 2 * np.pi * f[None, :] * td[:, None]
    return torch.polar(torch.ones_like(phase), phase).to(dtype)


def fine_freq_time_search(x_aligned: torch.Tensor, y_aligned: torch.Tensor,
                          fine_res, freqfound: float, freq_res: float,
                          fs: float, td_scan_range, steeringvec=None,
                          td_scan_freq_bounds=None):
    """Two-pass fine frequency then sub-sample time alignment (reference
    fineFreqTimeSearch). Positive timediff means y_aligned is LATER than
    x_aligned. Returns (fine_freq_found, timediff, cost_vec).

    As in the JAX package, x is aligned to y's tone with conj(best_shift),
    a deliberate deviation from the literal reference (which multiplies by
    best_shift itself, doubling the tone mismatch and biasing the sub-sample
    delay; pydsproutines_tpu/ops/xcorr.py:667-672)."""
    n = x_aligned.shape[-1]
    cdt = x_aligned.dtype
    rdt = real_dtype_for(cdt)
    dev = x_aligned.device
    nn = torch.arange(n, dtype=rdt, device=dev)
    freqfound = torch.as_tensor(freqfound, dtype=rdt, device=dev)
    fine_res = list(np.atleast_1d(fine_res)) if fine_res is not None else []
    fine_freq_found = None
    if fine_res:
        conj_pre = torch.conj(torch.conj(y_aligned) * x_aligned)
        best_shift = None
        for res in fine_res:
            num = int(np.ceil(2.0 * freq_res / res))
            fine = freqfound + (torch.arange(num, dtype=rdt, device=dev)
                                * float(res) - freq_res)
            phase = (-2 * np.pi / fs) * fine[:, None] * nn[None, :]
            shifts_mat = torch.polar(torch.ones_like(phase), phase).to(cdt)
            with full_f32():
                pp = shifts_mat @ conj_pre
            i = int(torch.argmax(pp.abs()))
            freqfound = fine[i]
            best_shift = shifts_mat[i]
        fine_freq_found = freqfound
        x_aligned = x_aligned * torch.conj(best_shift)
    td_scan_range = torch.as_tensor(td_scan_range, device=dev)
    if steeringvec is None:
        steeringvec = make_time_scan_steervec(td_scan_range, fs, n,
                                              dtype=cdt)
    x_fft = torch.fft.fft(x_aligned)
    y_fft = torch.fft.fft(y_aligned)
    rx_vec = x_fft * torch.conj(y_fft)
    if td_scan_freq_bounds is not None:
        fvec = make_freq(n, fs, dtype=rdt, device=dev)
        keep = ((fvec >= td_scan_freq_bounds[0])
                & (fvec < td_scan_freq_bounds[1]))
        rx_vec = torch.where(keep, rx_vec, torch.zeros_like(rx_vec))
    with full_f32():
        cost_vec = (steeringvec.conj() @ rx_vec) / torch.linalg.norm(
            x_fft) / torch.linalg.norm(y_fft)
    timediff = td_scan_range[int(torch.argmax(cost_vec.abs()))]
    return fine_freq_found, timediff, cost_vec


class GenXcorr:
    """Cached steering-vector fine time-offset estimator (reference
    GenXcorr). The steering vectors live on ``device`` (``cuda`` when
    None)."""

    def __init__(self, td_scan_range, fs: float, siglen: int,
                 dtype: torch.dtype = torch.complex64, device=None):
        self.device = resolve_device(device)
        self.td_scan_range = torch.as_tensor(td_scan_range).to(self.device)
        self.fs = fs
        self.siglen = siglen
        self.steeringvec = make_time_scan_steervec(self.td_scan_range, fs,
                                                   siglen, dtype)
        self.td_scan_freq_bounds = None

    def set_td_scan_freq_bounds(self, bounds):
        self.td_scan_freq_bounds = bounds

    def xcorr(self, x: torch.Tensor, y: torch.Tensor):
        _, timediff, cost_vec = fine_freq_time_search(
            x, y, [], 0.0, 0.0, self.fs, self.td_scan_range,
            steeringvec=self.steeringvec,
            td_scan_freq_bounds=self.td_scan_freq_bounds)
        return timediff, cost_vec


# ---------------------------------------------------------------------------
# QF^2 / SNR conversions and accuracy bounds (Stein)
# ---------------------------------------------------------------------------

def convert_qf2_to_snr(qf2):
    """For xcorr against a pure (noiseless) template."""
    return qf2 / (1.0 - qf2)


def convert_eff_snr_to_qf2(eff_snr):
    return eff_snr / (2.0 + eff_snr)


def expected_eff_snr(snr1, snr2=np.inf, osr: float = 1):
    """Stein's effective SNR 1/(0.5*(1/y1 + 1/y2 + 1/(y1*y2))), scaled by
    OSR (reference expectedEffSNR)."""
    y = 1.0 / (0.5 * (1.0 / snr1 + 1.0 / snr2 + 1.0 / (snr1 * snr2)))
    return y / osr


def sigma_dto(signal_bw, noise_bw, integ_time, eff_snr):
    """Stein DTO standard deviation."""
    beta = np.pi / np.sqrt(3.0) * signal_bw
    return 1.0 / beta / np.sqrt(noise_bw * integ_time * eff_snr)


def sigma_dfo(noise_bw, integ_time, eff_snr):
    """Stein DFO standard deviation."""
    return 0.55 / integ_time / np.sqrt(noise_bw * integ_time * eff_snr)


def theoretical_multi_peak(start_idx1, start_idx2, snr_linear_1=None,
                           snr_linear_2=None):
    """Expected xcorr peak offsets (and effective SNRs) from multiple signal
    copies in two receivers (reference theoreticalMultiPeak); host numpy."""
    start_idx1 = np.asarray(start_idx1)
    start_idx2 = np.asarray(start_idx2)
    mat = start_idx2[:, None] - start_idx1[None, :]
    if snr_linear_1 is None and snr_linear_2 is None:
        return np.unique(mat.flatten())
    snr_linear_2 = np.asarray(snr_linear_2)
    tmp = 0.5 * (1.0 / snr_linear_1 + 1.0 / snr_linear_2[:, None]
                 + 1.0 / (snr_linear_1 * snr_linear_2[:, None]))
    eff = np.broadcast_to(1.0 / tmp, mat.shape)
    u, indices = np.unique(mat.flatten(), return_index=True)
    return u, eff.flatten()[indices]


def argmax2d(m: torch.Tensor):
    """2-D indices of the matrix maximum (reference argmax2d)."""
    return torch.unravel_index(torch.argmax(m), m.shape)


def compute_fast_xcorr_complexity(n, k=1):
    """Operation-count model of the freq-scanning sliding xcorr: K shifts,
    one length-N FFT each (reference computeFastXcorrComplexity)."""
    return k * n * np.log2(n)


def compute_group_xcorr_czt_complexity(m, group_len, czt_points, k=1):
    """Operation-count model of the CZT group xcorr: K shifts x m groups,
    each a Bluestein CZT of two FFTs of the next fast length covering
    group_len + czt_points (reference computeGroupXcorrCZTcomplexity)."""
    lc = next_fast_len(int(group_len + czt_points))
    return k * m * 2 * lc * np.log2(lc)
