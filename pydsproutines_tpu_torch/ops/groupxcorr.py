"""Group cross-correlation: coherent CAF combining of disjoint burst groups,
and multi-template FFT matched filtering.

PyTorch counterpart of ``pydsproutines_tpu/ops/groupxcorr.py``. The group
xcorr evaluates, for each shift and scan frequency f,

    | sum_g exp(-j*2*pi*f*start_g/fs) * CZT_or_FFT( rx[shift+start_g : ...]
          * conj(y_g) )(f) |^2  /  sum_g ||rx group||^2  /  ||y||^2

``GroupXcorrCZT.xcorr`` routes by ``select_group_caf_path``:

  "group-caf-hopper"  complex64 CUDA input with a CZT tone bank: the
                      Hopper group CAF kernel (ops/hopper/group_caf.py)
                      over the tone bank folded with the conjugated template
                      and the group phases (``fold_tone_bank``), split once
                      at plan build for its 3xTF32 tensor-core product
                      (f32 grade), uniform sweeps and shift lists alike;
  "plain"             CPU tensors, complex128, ``fused=False`` (the JAX
                      parity tier): the kernel's twin over the same folded
                      bank; with no tone bank (m*k > 4,000,000), per-group
                      products through the Bluestein CZT on torch.fft.

Window energies come from one float64 prefix sum of |rx|^2 (the port's
convention, ``ops/xcorr.power_prefix``). Every window is read where it lies,
so no chunk clamps at the end of a capture (ROADMAP Queue 3 item 7). The
other classes run no TPU kernel and are plain torch; their products run in
full f32.
"""

from __future__ import annotations

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.hopper.group_caf import (group_caf,
                                                          group_caf_plain,
                                                          group_windows,
                                                          tf32_planes)
from pydsproutines_tpu_torch.ops.spectral import CZT
from pydsproutines_tpu_torch.ops.xcorr import _abs_sq, power_prefix
from pydsproutines_tpu_torch.utils.device import resolve_device
from pydsproutines_tpu_torch.utils.dtypes import (full_f32, numpy_dtype,
                                                  real_dtype_for)
from pydsproutines_tpu_torch.utils.freq import make_freq
from pydsproutines_tpu_torch.utils.memory import chunk_shifts

# the Bluestein and FFT routes' working set per (shift, sample): the
# gather's index, clamped copy and mask, the gathered windows and their
# masked copy, their product and its padded transform (complex64)
PLAIN_BYTES_PER_SAMPLE = 64


def _stack_groups(y: np.ndarray, starts: np.ndarray, lengths: np.ndarray,
                  auto_conj: bool) -> np.ndarray:
    max_len = int(np.max(lengths))
    ystack = np.zeros((len(starts), max_len), dtype=np.asarray(y).dtype)
    for i, (s, l) in enumerate(zip(starts, lengths)):
        ystack[i, :l] = np.asarray(y)[s: s + l]
    return np.conj(ystack) if auto_conj else ystack


def fold_tone_bank(ystack: np.ndarray, tones: np.ndarray,
                   phases: np.ndarray) -> np.ndarray:
    """Tfold[g*m + t, f] = ystack[g, t] * tones[t, f] * phases[g, f] as a
    (G*m, k) complex128 array, the product taken in float64. ``ystack`` is
    already conjugated (``_stack_groups``) and zero-padded, so short
    groups' rows are zero."""
    g, m = ystack.shape
    t = tones.astype(np.complex128)[None] * phases.astype(np.complex128)[:,
                                                                        None]
    return (ystack.astype(np.complex128)[:, :, None] * t).reshape(
        g * m, tones.shape[1])


def select_group_caf_path(g: int, m: int, k: int, dtype: torch.dtype,
                          device, tones: bool,
                          fused: bool | None = None) -> tuple[str, str]:
    """The routing decision of ``GroupXcorrCZT.xcorr``: (path, reason)."""
    device = torch.device(device)
    if fused is False:
        return "plain", "fused=False: the plain tier (the JAX parity tier)"
    if device.type != "cuda":
        return "plain", f"{device.type} tensor: plain torch twin"
    if not tones:
        return "plain", (f"m*k = {m * k} > 4,000,000: no tone bank, so "
                         f"Bluestein CZT on torch.fft (the JAX package "
                         f"leaves this to XLA too)")
    if dtype != torch.complex64:
        return "plain", f"dtype {dtype}: the group CAF kernel takes complex64"
    return "group-caf-hopper", (
        f"G={g} groups x m={m}, k={k} bins: Hopper group CAF kernel, 3xTF32 "
        f"tensor-core product at f32 grade; the TPU kernel's VMEM gate "
        f"(m % 128, batch % 8, 88 MB) does not apply")


def _checked_shifts(shifts, rx, span: int, lo: int) -> torch.Tensor:
    """int64 shifts on rx's device, after the range check: every window
    [shift + lo, shift + span) lies in rx."""
    shifts = torch.as_tensor(shifts, dtype=torch.int64, device=rx.device)
    if shifts.ndim != 1 or shifts.shape[0] == 0:
        raise ValueError("shifts must be a non-empty 1-D list")
    s_min, s_max = int(shifts.min()), int(shifts.max())
    if s_min + lo < 0 or s_max + span > rx.shape[-1]:
        raise ValueError(f"shifts [{s_min}, {s_max}] with groups spanning "
                         f"[{lo}, {span}) exceed rx length {rx.shape[-1]}")
    return shifts


def _group_energy(power, shifts, starts: np.ndarray, lengths: np.ndarray):
    """sum_g ||rx[shift + start_g : + length_g]||^2 per shift (float64)."""
    out = 0
    for s, ln in zip(starts.tolist(), lengths.tolist()):
        out = out + (power[shifts + s + ln] - power[shifts + s])
    return out


class GroupXcorrCZT:
    """Group xcorr over a CZT frequency grid (reference GroupXcorrCZT; C++
    ippGroupXcorrCZT). :meth:`xcorr` returns the (num_shifts, k) QF^2 grid
    and the CZT frequencies. Plan constants live on ``device`` (``cuda``
    when None); rx must be there too.
    """

    def __init__(self, y, starts, lengths, f1: float, f2: float,
                 bin_width: float, fs: float, auto_conj: bool = True,
                 auto_zero_starts: bool = True,
                 dtype: torch.dtype = torch.complex64, device=None):
        starts = np.asarray(starts)
        lengths = np.asarray(lengths)
        if starts.size != lengths.size:
            raise ValueError("starts and lengths differ in size")
        if auto_zero_starts:
            starts = starts - starts[0]
        ystack = _stack_groups(np.asarray(y), starts, lengths, auto_conj)
        plan = CZT(int(np.max(lengths)), f1, f2, bin_width, fs, dtype=dtype,
                   device=device)
        phases = np.exp(-2j * np.pi * plan.freqs()[None, :]
                        * starts[:, None] / fs)
        self._setup(plan, starts, lengths, ystack.astype(numpy_dtype(dtype)),
                    float(np.linalg.norm(ystack.flatten()) ** 2),
                    phases.astype(numpy_dtype(dtype)))

    @classmethod
    def from_numpy_params(cls, params: dict, device=None) -> "GroupXcorrCZT":
        """Build on a JAX ``GroupXcorrCZT``'s plan constants: ``{"ystack",
        "starts", "lengths", "group_phases", "ystack_norm_sq", "tones",
        "f1", "bin_width", "k", "fs"}`` (numpy; ``tones`` is the JAX plan's
        tone bank or None). The tone bank folded for the kernel is built
        from these arrays."""
        ystack = np.asarray(params["ystack"])
        dtype = torch.from_numpy(ystack[:0]).dtype
        plan = CZT(ystack.shape[1], params["f1"], None, params["bin_width"],
                   params["fs"], dtype=dtype, device=device,
                   k=int(params["k"]))
        tones = params.get("tones")
        if (tones is None) != (plan.tones is None):
            raise ValueError("the given tone bank does not match the plan's "
                             "gate (m*k <= 4,000,000)")
        obj = cls.__new__(cls)
        obj._setup(plan, np.asarray(params["starts"]),
                   np.asarray(params["lengths"]), ystack,
                   float(params["ystack_norm_sq"]),
                   np.asarray(params["group_phases"]),
                   tones=None if tones is None else np.asarray(tones))
        return obj

    def _setup(self, plan, starts, lengths, ystack, ynorm_sq, phases,
               tones=None):
        self.plan = plan
        self.device = plan.device
        self.starts = starts
        self.lengths = lengths
        self.num_groups = starts.size
        self.fs = plan.fs
        self.max_length = plan.m
        self.ystack = ystack
        self.ystack_norm_sq = ynorm_sq
        self.czt_freq = plan.freqs()
        self.group_phases = phases
        dev = self.device
        self._starts_t = torch.from_numpy(starts.astype(np.int64)).to(dev)
        self._tfold = self._tf32 = None
        if plan.tones is not None:
            tones = plan.tones if tones is None else tones
            self._tfold = torch.from_numpy(fold_tone_bank(
                ystack, tones, phases).astype(numpy_dtype(plan.dtype))).to(dev)
            if dev.type == "cuda" and self._tfold.dtype == torch.complex64:
                # split once for the kernel's 3xTF32 product
                self._tf32 = tf32_planes(self._tfold)
        else:
            self._ystack_t = torch.from_numpy(ystack).to(dev)
            self._phases_t = torch.from_numpy(phases).to(dev)

    def xcorr(self, rx: torch.Tensor, shifts=None, batch_size: int = 32,
              fused: bool | None = None, step: int | None = None):
        """CAF over ``shifts``; returns ((num_shifts, k) QF^2 grid, CZT
        frequencies). ``fused=False`` forces the plain tier; otherwise CUDA
        complex64 sweeps with a tone bank take the Hopper kernel (see the
        module docstring). ``batch_size`` caps the plain tier's chunks; the
        kernel sizes its own by its scratch budget (as the JAX fused route
        does). ``step`` is accepted for the JAX signature: every route reads
        each window at its own shift, so a uniform stride needs no
        declaring."""
        del step
        if rx.device != self.device:
            raise ValueError(f"rx on {rx.device}, plan on {self.device}")
        rx = rx.to(self.plan.dtype)
        ends = self.starts + self.lengths
        if shifts is None:
            shifts = torch.arange(rx.shape[-1] - int(ends[-1]) + 1)
        shifts = _checked_shifts(shifts, rx, int(ends.max()),
                                 int(self.starts.min()))
        g, m, k = self.num_groups, self.max_length, self.plan.k
        path, _ = select_group_caf_path(g, m, k, self.plan.dtype, rx.device,
                                        self._tfold is not None, fused)
        if path == "group-caf-hopper":
            mag = group_caf(rx, shifts, self._starts_t, self._tfold, k,
                            self._tf32)
        elif self._tfold is not None:
            mag = group_caf_plain(rx, shifts, self._starts_t, self._tfold, k,
                                  batch_size)
        else:
            mag = self._bluestein_caf(rx, shifts, batch_size)
        norms = _group_energy(power_prefix(rx), shifts, self.starts,
                              self.lengths)
        qf2 = mag.double() / norms[:, None] / self.ystack_norm_sq
        return qf2.to(real_dtype_for(self.plan.dtype)), self.czt_freq

    def _bluestein_caf(self, rx, shifts, batch_size):
        """|sum_g CZT(windows_g * ystack_g) * phase_g|^2 per shift, in
        chunks within the byte budget."""
        g, m = self.num_groups, self.max_length
        chunk = chunk_shifts(g * self.plan.nfft,
                             min(batch_size, shifts.shape[0]),
                             PLAIN_BYTES_PER_SAMPLE)
        rows = []
        for c0 in range(0, shifts.shape[0], chunk):
            wins = group_windows(rx, shifts[c0: c0 + chunk], self._starts_t,
                                  m)
            comb = (self.plan(wins * self._ystack_t) * self._phases_t).sum(-2)
            rows.append(_abs_sq(comb))
        return torch.cat(rows)


class GroupXcorrFFT:
    """Group xcorr over the FFT frequency grid (reference GroupXcorrFFT).
    All groups share one length; :meth:`xcorr` returns the (shifts x
    fftlen) QF^2 CAF. Constants live on ``device`` (``cuda`` when None)."""

    def __init__(self, ygroups, starts, fs: float, auto_conj: bool = True,
                 fftlen: int | None = None, auto_zero_starts: bool = True,
                 dtype: torch.dtype = torch.complex64, device=None):
        ygroups = np.asarray(ygroups)
        starts = np.asarray(starts)
        if starts.size != ygroups.shape[0]:
            raise ValueError("one start per group row")
        if auto_zero_starts:
            starts = starts - starts[0]
        self.device = resolve_device(device)
        self.starts = starts
        self.num_groups = starts.size
        self.fs = float(fs)
        self.ygroup_len = ygroups.shape[1]
        self.fftlen = int(fftlen) if fftlen is not None else self.ygroup_len
        self.ygroup_norm_sq = float(np.linalg.norm(ygroups.flatten()) ** 2)
        if auto_conj:
            ygroups = np.conj(ygroups)
        npdt = numpy_dtype(dtype)
        self.dtype = dtype
        self.ygroups = torch.from_numpy(ygroups.astype(npdt)).to(self.device)
        self.fftfreq = make_freq(self.fftlen, fs, dtype=torch.float64).numpy()
        phases = np.exp(-2j * np.pi * self.fftfreq[None, :] * starts[:, None]
                        / fs)
        self.group_phases = torch.from_numpy(phases.astype(npdt)).to(
            self.device)
        self._starts_t = torch.from_numpy(starts.astype(np.int64)).to(
            self.device)

    def xcorr(self, rx: torch.Tensor, shifts=None, batch_size: int = 32,
              step: int | None = None):
        """(shifts, fftlen) QF^2 CAF; ``step`` is accepted for the JAX
        signature (each window is read at its own shift)."""
        del step
        n = self.ygroup_len
        rx = rx.to(self.dtype)
        if shifts is None:
            shifts = torch.arange(rx.shape[-1] - (int(self.starts[-1]) + n)
                                  + 1)
        shifts = _checked_shifts(shifts, rx, int(self.starts.max()) + n,
                                 int(self.starts.min()))
        chunk = chunk_shifts(self.num_groups * max(n, self.fftlen),
                             min(batch_size, shifts.shape[0]),
                             PLAIN_BYTES_PER_SAMPLE)
        rows = []
        for c0 in range(0, shifts.shape[0], chunk):
            wins = group_windows(rx, shifts[c0: c0 + chunk], self._starts_t,
                                  n)
            spec = torch.fft.fft(wins * self.ygroups, n=self.fftlen, dim=-1)
            rows.append(_abs_sq((spec * self.group_phases).sum(-2)))
        lengths = np.full(self.num_groups, n)
        norms = _group_energy(power_prefix(rx), shifts, self.starts, lengths)
        qf2 = torch.cat(rows).double() / norms[:, None] / self.ygroup_norm_sq
        return qf2.to(real_dtype_for(self.dtype))


class GroupXcorr:
    """Group xcorr against an explicit frequency list via a tone-bank
    product (reference GroupXcorr). :meth:`xcorr` returns per-shift peak
    QF^2 and peak frequency. Constants live on ``device`` (``cuda`` when
    None)."""

    def __init__(self, y, starts, lengths, freqs, fs: float,
                 auto_conj: bool = True, auto_zero_starts: bool = True,
                 dtype: torch.dtype = torch.complex64, device=None):
        starts = np.asarray(starts)
        lengths = np.asarray(lengths)
        freqs = np.asarray(freqs, dtype=np.float64)
        if starts.size != lengths.size:
            raise ValueError("starts and lengths differ in size")
        if auto_zero_starts:
            starts = starts - starts[0]
        self.device = resolve_device(device)
        self.starts = starts
        self.lengths = lengths
        self.num_groups = starts.size
        self.freqs = freqs
        self.fs = float(fs)
        self.dtype = dtype
        y = np.asarray(y)
        concat = np.hstack([y[s: s + l] for s, l in zip(starts, lengths)])
        if auto_conj:
            concat = np.conj(concat)
        npdt = numpy_dtype(dtype)
        self.yconcat = torch.from_numpy(concat.astype(npdt)).to(self.device)
        self.yconcat_norm_sq = float(np.linalg.norm(concat) ** 2)
        positions = np.hstack([np.arange(s, s + l)
                               for s, l in zip(starts, lengths)])
        mat = np.exp(-2j * np.pi * freqs[:, None] * positions[None, :] / fs)
        self.freq_mat = torch.from_numpy(mat.astype(npdt)).to(self.device)
        self.gather_idx = torch.from_numpy(positions.astype(np.int64)).to(
            self.device)

    def xcorr(self, rx: torch.Tensor, shifts=None, batch_size: int = 64):
        rx = rx.to(self.dtype)
        span = int(np.max(self.starts + self.lengths))
        if shifts is None:
            shifts = torch.arange(rx.shape[-1] - (int(self.starts[-1])
                                                  + int(self.lengths[-1])) + 1)
        shifts = _checked_shifts(shifts, rx, span, int(self.starts.min()))
        rdt = real_dtype_for(self.dtype)
        freqs = torch.as_tensor(self.freqs, dtype=rdt, device=rx.device)
        chunk = chunk_shifts(self.gather_idx.shape[0],
                             min(batch_size, shifts.shape[0]), 16)
        xcs, fpk = [], []
        with full_f32():
            for c0 in range(0, shifts.shape[0], chunk):
                rxc = rx[shifts[c0: c0 + chunk, None] + self.gather_idx]
                mag = _abs_sq((rxc * self.yconcat) @ self.freq_mat.T)
                i = torch.argmax(mag, dim=-1)
                best = torch.gather(mag, -1, i[:, None])[:, 0]
                xcs.append(best / _abs_sq(rxc).sum(-1) / self.yconcat_norm_sq)
                fpk.append(freqs[i])
        return torch.cat(xcs), torch.cat(fpk)


class TemplateCrossCorrelator:
    """FFT-domain multi-template correlator with rolling-energy
    normalisation (reference TemplateCrossCorrelator). Returns QF (not
    QF^2), as the reference. Constants live on ``device`` (``cuda`` when
    None)."""

    def __init__(self, templates, input_size: int,
                 dtype: torch.dtype = torch.complex64, device=None):
        templates = np.asarray(templates)
        if templates.ndim != 2:
            raise ValueError("Templates must be 2D; 1 row per template.")
        self.device = resolve_device(device)
        self.input_size = int(input_size)
        self.template_len = templates.shape[1]
        self.dtype = dtype
        self.template_norms = torch.from_numpy(
            np.linalg.norm(templates, axis=1).astype(
                numpy_dtype(real_dtype_for(dtype)))).to(self.device)
        padded = np.zeros((templates.shape[0], input_size), templates.dtype)
        padded[:, : self.template_len] = templates
        self.templateffts_conj = torch.from_numpy(np.conj(np.fft.fft(
            padded, axis=1)).astype(numpy_dtype(dtype))).to(self.device)

    def correlate(self, x: torch.Tensor, return_max: bool = False):
        if x.shape[-1] != self.input_size:
            raise ValueError(f"x must be length {self.input_size}")
        x = x.to(self.dtype)
        tl = self.template_len
        out = torch.fft.ifft(torch.fft.fft(x)[None, :]
                             * self.templateffts_conj, dim=-1)
        power = power_prefix(x)
        norms = torch.sqrt(power[tl:] - power[:-tl]).to(
            real_dtype_for(self.dtype))
        nout = out[:, : x.shape[-1] - tl + 1] / norms[None, :]
        nout = nout / self.template_norms[:, None]
        if not return_max:
            return nout
        mag = nout.abs()
        idx = torch.argmax(mag, dim=0)
        return torch.gather(mag, 0, idx[None, :])[0], idx


class GroupXcorrCZTPermutations:
    """Group xcorr over template permutations: each group's template is
    drawn from a set; per-template correlations are computed once and
    combined per permutation (reference GroupXcorrCZT_Permutations). All
    templates share one length. After :meth:`xcorr`, call :meth:`get_caf`
    with one template choice per group. Constants live on ``device``
    (``cuda`` when None)."""

    def __init__(self, ygroups, ygroup_idxs, group_starts, f1: float,
                 f2: float, bin_width: float, fs: float,
                 auto_conj: bool = True, dtype: torch.dtype = torch.complex64,
                 device=None):
        ygroups = np.asarray(ygroups)
        ygroup_idxs = np.asarray(ygroup_idxs)
        group_starts = np.asarray(group_starts)
        if ygroups.shape[0] != ygroup_idxs.size:
            raise ValueError("one group index per template")
        if not np.array_equal(np.unique(ygroup_idxs),
                              np.arange(group_starts.size)):
            raise ValueError("group indices must cover 0..num_groups-1")
        self.num_templates = ygroup_idxs.size
        self.num_groups = group_starts.size
        self.group_starts = group_starts
        self.ygroup_idxs = ygroup_idxs
        self.length = ygroups.shape[1]
        self.fs = float(fs)
        if auto_conj:
            ygroups = np.conj(ygroups)
        npdt = numpy_dtype(dtype)
        self.plan = CZT(self.length, f1, f2, bin_width, fs, dtype=dtype,
                        device=device)
        self.device = self.plan.device
        self.ygroups = torch.from_numpy(ygroups.astype(npdt)).to(self.device)
        self.ygroups_energy = np.linalg.norm(ygroups, axis=1) ** 2
        self.czt_freq = self.plan.freqs()
        phases = np.exp(-2j * np.pi * self.czt_freq[None, :]
                        * group_starts[:, None] / fs)
        self.template_phases = torch.from_numpy(
            phases[ygroup_idxs].astype(npdt)).to(self.device)
        self._starts_t = torch.from_numpy(
            group_starts.astype(np.int64)).to(self.device)
        self._idx_t = torch.from_numpy(ygroup_idxs.astype(np.int64)).to(
            self.device)
        self.xc_templates = None
        self.rx_group_norm_sq = None

    def xcorr(self, rx: torch.Tensor, shifts=None, batch_size: int = 8):
        """Correlate every template at every shift. Stores (T, S, K) complex
        template spectra and (G, S) rx group energies; returns czt_freq."""
        rx = rx.to(self.plan.dtype)
        m = self.length
        if shifts is None:
            shifts = torch.arange(rx.shape[-1]
                                  - (int(self.group_starts[-1]) + m) + 1)
        shifts = _checked_shifts(shifts, rx, int(self.group_starts.max()) + m,
                                 int(self.group_starts.min()))
        chunk = chunk_shifts(self.num_templates * self.plan.nfft,
                             min(batch_size, shifts.shape[0]),
                             PLAIN_BYTES_PER_SAMPLE)
        xcs = []
        for c0 in range(0, shifts.shape[0], chunk):
            wins = group_windows(rx, shifts[c0: c0 + chunk], self._starts_t,
                                  m)
            pdt = wins[:, self._idx_t] * self.ygroups          # (B, T, m)
            xcs.append(self.plan(pdt) * self.template_phases)
        power = power_prefix(rx)
        energy = torch.stack([power[shifts + s + m] - power[shifts + s]
                              for s in self.group_starts.tolist()])
        self.xc_templates = torch.cat(xcs).movedim(0, 1)
        self.rx_group_norm_sq = energy.to(real_dtype_for(self.plan.dtype))
        return self.czt_freq

    def get_caf(self, template_idx) -> torch.Tensor:
        """Combine one template choice per group into the (S, K) CAF
        (reference getCAF)."""
        template_idx = np.asarray(template_idx)
        if template_idx.size != self.num_groups:
            raise ValueError("one template choice per group")
        if self.xc_templates is None:
            raise ValueError("Run xcorr() first.")
        caf = 0
        rxnormsq = 0
        ynormsq = 0.0
        for group in range(self.num_groups):
            tnum = int(np.argwhere(self.ygroup_idxs == group)[
                template_idx[group]][0])
            caf = caf + self.xc_templates[tnum]
            rxnormsq = rxnormsq + self.rx_group_norm_sq[group]
            ynormsq += float(self.ygroups_energy[tnum])
        return _abs_sq(caf) / rxnormsq[:, None] / ynormsq
