"""Sliding normalised matched filter (TPU kernel #7) and its plain twin.

Kernel: ``csrc/sliding.cu``, hand-written CUDA C++ for Hopper (sm_90a). It
replaces ``pydsproutines_tpu/ops/pallas/sliding.py:_kernel``: for every
template t and dense shift s,

    qf2[t, s] = |sum_n x[s+n] * conj(tmpl[t, n])|^2
                / sum_n |x[s+n]|^2 / ||tmpl_t||^2,

0 where the denominator is 0. ``sliding_plan`` picks one of its two routes:

* **overlap-save** ("sliding-ols-hopper"): per segment of nfft samples (a
  power of two, 4L <= nfft <= 8192), one FFT of the segment and per template
  a product with the template's conjugated spectrum and an inverse FFT, on
  the shared-memory line FFT of ``csrc/fft_smem.cuh`` over the host's f32
  tables (``ops/fft.line_table``); the nfft - L + 1 valid shifts of each
  segment come out. A segment whose energy exceeds ``FLAG_RATIO`` times its
  least non-zero window energy, where the FFT's rounding (which scales with
  the segment's energy) could exceed the f32 grade of a quiet window, is
  computed by the direct f32 product instead, inside the kernel;
* **direct** ("sliding-direct-hopper"): the direct product, for templates
  so short that the transforms cost more.

Both sum each window's energy in f32 over its own samples (a window of
zeros gives exactly 0); the twin sums it in float64 (not as a prefix-sum
difference, whose cancellation is as large as a short window's energy far
into a long capture). Both are f32-grade against float64 numpy: the tests
hold them to 1e-5 absolute on the 0..1 QF^2 scale, the JAX kernel test's
bound. ``sliding_staged`` runs the overlap-save schedule in torch over the
kernel's tables and flagging rule, for the tests.

``sliding_multiply_normalised`` is the counterpart of the JAX
``ops.pallas.sliding`` function (its ``tile`` is accepted for the signature;
the kernel's segments are its own). A CPU tensor takes the twin
``sliding_plain``; a CUDA tensor launches the kernel (inputs computed as
complex64, as the JAX kernel computes in f32) or raises; the route is
``select_sliding_path``'s.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from pydsproutines_tpu_torch.ops.fft import (_butterfly_flop, digit_reversal,
                                             fft_staged, line_table,
                                             plan_ints, radix_plan)
from pydsproutines_tpu_torch.ops.hopper import _build
from pydsproutines_tpu_torch.utils.dtypes import full_f32, to_tensor
from pydsproutines_tpu_torch.utils.memory import chunk_shifts

# template-length cap of the JAX kernel (ops/pallas/sliding.py:40); the
# Hopper kernel stages up to 8 templates of this length in shared memory
MAX_TEMPLATE_LEN = 2048
# the twin's working set per (shift, sample): the unfolded window's
# contiguous copy for the product (complex64) and its slack
PLAIN_BYTES_PER_SAMPLE = 16
# overlap-save segment lengths: the power of two >= 4L, within these
MIN_NFFT, MAX_NFFT = 1024, 8192
# samples a run of the window-energy sums (a warp's width)
RUN = 32
# the re-check's limit on segment energy / least non-zero window energy:
# above it the segment takes the direct f32 product (calibrated on
# sliding_staged, tests/test_torch_sliding_staged.py)
FLAG_RATIO = 16384.0


def _prepare(x, templates):
    """(x, 2-D templates) as tensors on x's device, after the JAX
    function's checks."""
    x = to_tensor(x)
    templates = to_tensor(templates, x.device)
    if templates.ndim == 1:
        templates = templates[None, :]
    if x.ndim != 1 or templates.ndim != 2:
        raise ValueError("x must be 1-D and templates (T, L)")
    tlen = templates.shape[1]
    if tlen > MAX_TEMPLATE_LEN:
        raise ValueError(
            f"template length {tlen} > {MAX_TEMPLATE_LEN}; use the FFT "
            "overlap-save xcorr path for long templates")
    if x.shape[-1] - tlen + 1 <= 0:
        raise ValueError("template longer than input")
    return x, templates


def sliding_plain(x: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """The twin: unfolded windows times the conjugated templates in full
    f32, window energies summed in float64, in chunks of shifts within the
    byte budget. Returns (T, N - L + 1) float32."""
    x, templates = _prepare(x, templates)
    tlen = templates.shape[1]
    ns = x.shape[0] - tlen + 1
    power = x.real.double() ** 2 + x.imag.double() ** 2
    tconj = templates.conj().T.to(x.dtype)
    tnorm = (templates.real.double() ** 2
             + templates.imag.double() ** 2).sum(-1)
    chunk = chunk_shifts(tlen, ns, PLAIN_BYTES_PER_SAMPLE)
    mags, energy = [], []
    with full_f32():
        for c0 in range(0, ns, chunk):
            w = x[c0: c0 + chunk + tlen - 1].unfold(0, tlen, 1)
            c = w @ tconj
            mags.append(c.real.double() ** 2 + c.imag.double() ** 2)
            energy.append(power[c0: c0 + chunk + tlen - 1].unfold(
                0, tlen, 1).sum(-1))
    den = torch.cat(energy)[:, None] * tnorm[None, :]
    mag = torch.cat(mags)
    out = torch.where(den > 0, mag / torch.where(den > 0, den, 1.0), 0.0)
    return out.T.contiguous().to(torch.float32)


def line_flop(nfft: int) -> float:
    """f32 operations of one line FFT of csrc/fft_smem.cuh (its
    butterflies and twiddle products)."""
    return float(sum(nfft // r * _butterfly_flop(r) for r in radix_plan(nfft)))


@functools.lru_cache(maxsize=64)
def sliding_plan(n: int, t: int, tlen: int) -> dict:
    """The kernel's route for an n-sample x and t templates of tlen:
    ``route`` ("ols" or "direct"), the segment length ``nfft``, its valid
    shifts ``valid`` and ``segments``, and the f32 operations of each
    route, ``ols_flop`` (the template spectra; per segment one line FFT,
    per template the product (6 a point), a line FFT and the normalisation
    (4 a shift)) and ``direct_flop`` (8 a tap a template a shift). The
    route is the one with fewer operations."""
    ns = n - tlen + 1
    nfft = min(MAX_NFFT, max(MIN_NFFT, 1 << (4 * tlen - 1).bit_length()))
    valid = nfft - tlen + 1
    segments = -(-ns // valid)
    fl = line_flop(nfft)
    ols = t * fl + segments * (fl + t * (6.0 * nfft + fl + 4.0 * valid))
    direct = 8.0 * t * tlen * ns
    return {"route": "ols" if ols < direct else "direct", "nfft": nfft,
            "valid": valid, "segments": segments, "ols_flop": ols,
            "direct_flop": direct}


def select_sliding_path(n: int, t: int, tlen: int, dtype: torch.dtype,
                        device) -> tuple[str, str]:
    """The routing decision of ``sliding_multiply_normalised`` for an
    n-sample x and t templates of tlen: (path, reason)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "plain", "cpu tensor: plain torch twin"
    if device.type != "cuda":
        raise ValueError(f"select_sliding_path: unsupported device {device}")
    plan = sliding_plan(n, t, tlen)
    how = (f"{dtype} computed as complex64; overlap-save "
           f"{plan['ols_flop']:.3g} vs direct {plan['direct_flop']:.3g} f32 "
           f"operations")
    if plan["route"] == "ols":
        return "sliding-ols-hopper", (
            f"{how}: Hopper overlap-save kernel, {plan['segments']} segments "
            f"of nfft={plan['nfft']} ({plan['valid']} shifts each) on the "
            f"shared-memory FFT, segments with energy above {FLAG_RATIO:g}x "
            f"their least window's by the direct f32 product")
    return "sliding-direct-hopper", (
        f"{how}: Hopper direct-product kernel (templates too short for the "
        f"transforms to pay)")


def _energies(p: torch.Tensor, tlen: int, valid: int):
    """(window energies (segments, valid), run sums (segments, nfft / 32))
    as the kernel forms them from the segments' powers p (segments, nfft)
    in f32: a window within one 32-sample run sums its samples; else its
    first run's suffix sum, its last run's prefix sum and the whole runs
    between. Only the window's own samples, never a difference of sums."""
    segs = p.shape[0]
    blocks = p.reshape(segs, -1, RUN)
    pre = blocks.cumsum(-1).reshape(segs, -1)
    suf = blocks.flip(-1).cumsum(-1).flip(-1).reshape(segs, -1)
    runs = blocks.sum(-1)
    s = torch.arange(valid)
    last = s + tlen - 1
    ra, rb = s // RUN, last // RUN
    one = ra == rb                      # the window within one run
    i = torch.arange(RUN)
    inside = torch.where(one[:, None] & (s[:, None] + i <= last[:, None]),
                         s[:, None] + i, -1)
    r = torch.arange(tlen // RUN + 1)
    whole = torch.where(ra[:, None] + 1 + r < rb[:, None],
                        ra[:, None] + 1 + r, -1)
    pz = torch.cat([p, p.new_zeros(segs, 1)], -1)              # -1 -> 0
    rz = torch.cat([runs, runs.new_zeros(segs, 1)], -1)
    ends = torch.where(one, 0.0, suf[:, s] + pre[:, last])
    return pz[:, inside].sum(-1) + ends + rz[:, whole].sum(-1), runs


def sliding_staged(x: torch.Tensor, templates: torch.Tensor,
                   flag_ratio: float = FLAG_RATIO):
    """The overlap-save route's schedule in torch over the kernel's tables,
    for complex64 CPU tensors: the template spectra and each segment's
    spectrum by ``fft_staged``, per template conj(X) * Tf and a forward
    ``fft_staged`` (the inverse by conjugation), |.|^2 / nfft^2; the window
    energies of ``_energies``; segments whose energy exceeds ``flag_ratio``
    times their least non-zero valid window's recomputed by the direct f32
    product and window sums (the kernel's masked direct pass). Returns
    (QF^2 (T, N - L + 1) float32, the flagged segments' indices, each
    segment's energy over its least non-zero valid window's, inf where it
    has none)."""
    x, templates = _prepare(x, templates)
    x, templates = x.to(torch.complex64), templates.to(torch.complex64)
    t, tlen = templates.shape
    ns = x.shape[0] - tlen + 1
    plan = sliding_plan(x.shape[0], t, tlen)
    nfft, valid, segments = plan["nfft"], plan["valid"], plan["segments"]
    radices = radix_plan(nfft)
    wl = torch.from_numpy(line_table(nfft, radices))
    tpad = torch.zeros((t, nfft), dtype=torch.complex64)
    tpad[:, :tlen] = templates
    tspec = fft_staged(tpad, radices, wl)
    xz = torch.zeros(segments * valid + nfft, dtype=torch.complex64)
    xz[: x.shape[0]] = x
    seg = xz[torch.arange(segments)[:, None] * valid + torch.arange(nfft)]
    spec = fft_staged(seg, radices, wl)
    b = fft_staged(spec.conj()[:, None, :] * tspec[None], radices, wl)
    b = b[..., :valid] / nfft
    mag = b.real * b.real + b.imag * b.imag                 # (S, T, valid)
    energy, runs = _energies(seg.real * seg.real + seg.imag * seg.imag,
                             tlen, valid)
    tnorm = (templates.real ** 2 + templates.imag ** 2).sum(-1)
    shift = torch.arange(segments)[:, None] * valid + torch.arange(valid)
    live = (shift < ns) & (energy > 0)
    least = torch.where(live, energy, math.inf).min(-1).values
    ratio = runs.sum(-1) / least
    flagged = torch.nonzero(runs.sum(-1) > flag_ratio * least)[:, 0]
    if flagged.numel():                     # the direct route's arithmetic
        w = xz[shift[flagged][..., None] + torch.arange(tlen)]
        with full_f32():
            c = w @ templates.conj().T                  # (F, valid, T)
        mag[flagged] = (c.real ** 2 + c.imag ** 2).transpose(1, 2)
        energy[flagged] = (w.real ** 2 + w.imag ** 2).sum(-1)
    den = energy[:, None, :] * tnorm[None, :, None]
    out = torch.where(den > 0, mag / torch.where(den > 0, den, 1.0), 0.0)
    out = out.permute(1, 0, 2).reshape(t, -1)[:, :ns]
    return out.contiguous(), flagged.tolist(), ratio


def sliding_multiply_normalised(x: torch.Tensor, templates,
                                tile: int = 1024) -> torch.Tensor:
    """QF^2 of every template against every dense shift of ``x``.

    x : (N,) complex; templates : (T, L) complex, L <= 2048. Returns
    (T, N - L + 1) float32. ``tile`` is the JAX kernel's tile and is
    ignored (the Hopper kernel's segments are ``sliding_plan``'s)."""
    del tile
    x, templates = _prepare(x, templates)
    path, _ = select_sliding_path(x.shape[0], *templates.shape, x.dtype,
                                  x.device)
    if path == "plain":
        return sliding_plain(x, templates)
    return _sliding_cuda(x, templates,
                         "ols" if path == "sliding-ols-hopper" else "direct")


sliding_multiply_normalised.launches = 0
# the last launch's count of overlap-save segments sent to the direct
# product (0 on the direct route), a one-element device tensor: reading it
# waits for the launch
sliding_multiply_normalised.flagged = None


@functools.lru_cache(maxsize=8)
def _ols_tables(nfft: int, device: torch.device):
    """(line table, digit reversal, plan ints) of the nfft-point line FFT
    on ``device``, the plan as the C entry point reads it."""
    radices = radix_plan(nfft)
    ints = plan_ints({"factors": (nfft,), "lines": (1,),
                      "radices": (radices,)})
    return (torch.from_numpy(line_table(nfft, radices)).to(device),
            torch.from_numpy(digit_reversal(nfft, radices)).to(device),
            (ctypes.c_int * len(ints))(*ints))


def _sliding_cuda(x, templates, route: str | None = None,
                  nfft: int | None = None):
    """The kernel on CUDA tensors, on ``route`` ("ols" or "direct"; default
    ``sliding_plan``'s) with segments of ``nfft`` (default the plan's)."""
    lib = _build.library()
    x = x.to(torch.complex64).contiguous()
    templates = templates.to(torch.complex64).contiguous()
    t, tlen = templates.shape
    ns = x.shape[0] - tlen + 1
    plan = sliding_plan(x.shape[0], t, tlen)
    route = route or plan["route"]
    # ||t||^2 and the re-check's count: written by the kernel's first launch
    tnorm = torch.empty(t, dtype=torch.float32, device=x.device)
    flagged = torch.empty(1, dtype=torch.int32, device=x.device)
    out = torch.empty((t, ns), dtype=torch.float32, device=x.device)
    if route == "ols":
        nfft = nfft or plan["nfft"]
        wl, rev, ints = _ols_tables(nfft, x.device)
        spec = torch.empty((t, nfft), dtype=torch.complex64, device=x.device)
        flags = torch.empty(-(-ns // (nfft - tlen + 1)), dtype=torch.int32,
                            device=x.device)
        ptrs = (ctypes.addressof(ints), wl.data_ptr(), rev.data_ptr(),
                spec.data_ptr(), FLAG_RATIO, flags.data_ptr())
    else:
        ptrs = (None, None, None, None, FLAG_RATIO, None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.pdsp_sliding(x.data_ptr(), x.shape[0], templates.data_ptr(),
                              t, tlen, tnorm.data_ptr(), out.data_ptr(),
                              *ptrs, flagged.data_ptr(), stream)
    _build.check(rc, f"sliding launch (n={x.shape[0]}, T={t}, L={tlen}, "
                     f"{route})")
    sliding_multiply_normalised.launches += 1
    sliding_multiply_normalised.flagged = flagged
    return out


def sliding_multiply_normalised_reference(x, templates) -> np.ndarray:
    """Plain numpy version with the same semantics (a copy of the JAX
    package's, for the tests): float64 sums, float32 result."""
    x = np.asarray(x)
    templates = np.atleast_2d(np.asarray(templates))
    tlen = templates.shape[1]
    nshifts = x.shape[-1] - tlen + 1
    power = np.abs(x) ** 2
    energy = np.convolve(power, np.ones(tlen), mode="valid")
    out = np.zeros((templates.shape[0], nshifts), np.float32)
    for t in range(templates.shape[0]):
        corr = np.correlate(x, templates[t], mode="valid")
        tnorm = np.sum(np.abs(templates[t]) ** 2)
        out[t] = (np.abs(corr) ** 2 / energy[:nshifts] / tnorm).astype(
            np.float32)
    return out
